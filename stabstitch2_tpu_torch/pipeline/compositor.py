"""Panorama compositor (port of ``pipeline/compositor.py``).

Meshes at model scale are rescaled to the frame resolution; one canvas per
video is sized from the meshes' global extent and padded up to a bucket;
each chunk's two views are warped onto the padded canvas, fused (AVERAGE
or LINEAR) and cropped to the true extent. The spline is normalized by the
true extent, so the padding does not change any kept pixel.

Routes (the dispatch of the JAX package's ``_composite_chunk`` and
``composite_begin``, with its ``pallas_gather`` always on: the card has
one gather, K4, and it cannot overflow, so there is no repair leg):

- A, fused (``StitchConfig.fused_warp`` True, or None, its default, for
  NORMAL mode at ``coord_stride`` 1) on uint8 input: the fused
  composite-warp kernel K2 (``ops/fused_warp_cuda.py``) does the spline,
  the sample and the mask; yuv420 converts the clipped float fusion.
- B, the gather route (NORMAL, uint8, fused route not taken): the
  coordinates from K3 (``ops/tps_coords_cuda.py``) at stride 1 or from the
  coarse lattice at stride > 1, the sample from the patch-gather kernel K4
  (``ops/patch_gather_cuda.py``), the mask from ``bilinear_mask``.
- B-planar: route B when ``out_format='yuv420'`` reaches
  :func:`composite_chunk` itself; K4 writes three planes and the fusion
  and the 4:2:0 conversion stay planar. :func:`composite_begin` chains
  NORMAL-mode yuv420 (uint8 BGR, then ``bgr_u8_to_yuv420``) whenever
  ``fused_warp`` is off, so it reaches this branch only when the fused
  route was asked for and does not apply (``coord_stride`` > 1), as in the
  JAX package.
- FAST: the coordinates as route B, the ``grid_sample``-style sampler and
  mask in plain PyTorch (the JAX package has no kernel for them either);
  yuv420 converts the clipped float fusion, unchained, as in JAX.
- float input (not uint8): the coordinates as route B, ``bilinear_sample``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from stabstitch2_tpu_torch.config import MODEL_H, MODEL_W, StitchConfig
from stabstitch2_tpu_torch.data.video_io import pack_i420_host
from stabstitch2_tpu_torch.ops.blend import (average_fusion, linear_blend_mask,
                                             linear_fusion)
from stabstitch2_tpu_torch.ops.fused_warp_cuda import fused_warp_planes
from stabstitch2_tpu_torch.ops.interp import (bilinear_mask, bilinear_sample,
                                              grid_sample_align_corners,
                                              grid_sample_mask_align_corners)
from stabstitch2_tpu_torch.ops.mesh import mesh_points, normalize_mesh, rigid_mesh
from stabstitch2_tpu_torch.ops.patch_gather_cuda import (
    bilinear_sample_patch_u8_cuda)
from stabstitch2_tpu_torch.ops.tps import tps_params, tps_sample_coords
from stabstitch2_tpu_torch.ops.yuv import (bgr_planes_to_yuv420, bgr_to_yuv420,
                                           bgr_u8_to_yuv420)


@dataclasses.dataclass(frozen=True)
class Canvas:
    """Canvas geometry of one video."""

    out_h: int          # true canvas size
    out_w: int
    pad_h: int          # bucketed size the warp runs at
    pad_w: int
    x_min: float
    y_min: float


def scale_meshes(mesh: torch.Tensor, img_h: int, img_w: int,
                 model_h: int = MODEL_H, model_w: int = MODEL_W) -> torch.Tensor:
    """Rescale model-resolution meshes to the frame resolution."""
    s = torch.tensor([img_w / float(model_w), img_h / float(model_h)],
                     dtype=mesh.dtype, device=mesh.device)
    return mesh * s


def compute_canvas(mesh1: torch.Tensor, mesh2: torch.Tensor,
                   bucket: int = 128) -> Canvas:
    """Canvas from the global extent of both views' meshes [T, GH+1, GW+1, 2]."""
    m = torch.stack([mesh1, mesh2]).detach().cpu().numpy()
    x_min, x_max = float(m[..., 0].min()), float(m[..., 0].max())
    y_min, y_max = float(m[..., 1].min()), float(m[..., 1].max())
    out_w = max(int(np.ceil(x_max - x_min)), 8)
    out_h = max(int(np.ceil(y_max - y_min)), 8)
    return Canvas(out_h=out_h, out_w=out_w,
                  pad_h=int(np.ceil(out_h / bucket)) * bucket,
                  pad_w=int(np.ceil(out_w / bucket)) * bucket,
                  x_min=x_min, y_min=y_min)


def warp_inputs(img1: torch.Tensor, img2: torch.Tensor, mesh1: torch.Tensor,
                mesh2: torch.Tensor, offset: torch.Tensor, grid_span):
    """One chunk's warp inputs: stacked views [2B, H, W, 3], T, source.

    The views' meshes, shifted by the canvas offset and normalized by the
    true canvas extent, are the spline sources; the rigid lattice of the
    frame is the target.
    """
    _, H, W, _ = img1.shape
    span_h, span_w = grid_span
    norm1 = mesh_points(normalize_mesh(mesh1 - offset, span_h, span_w))
    norm2 = mesh_points(normalize_mesh(mesh2 - offset, span_h, span_w))
    rigid = rigid_mesh(H, W, grid_h=mesh1.shape[1] - 1,
                       grid_w=mesh1.shape[2] - 1, device=mesh1.device)
    norm_rigid = mesh_points(normalize_mesh(rigid, H, W))[None]
    source = torch.cat([norm1, norm2], 0).contiguous()
    target = norm_rigid.expand(source.shape)
    return (torch.cat([img1, img2], 0).contiguous(),
            tps_params(source, target).contiguous(), source)


def _fuse(w1, w2, m1, m2, fusion_mode: str):
    if fusion_mode == "AVERAGE":
        return average_fusion(w1, w2)
    if fusion_mode == "LINEAR":
        return linear_fusion(w1, w2, m1, m2)
    raise ValueError(f"unknown fusion_mode {fusion_mode!r}")


def _planar_yuv420(stack, x_s, y_s, out_size, B: int, fusion_mode: str):
    """Route B-planar: K4's planes, planar fusion, planar 4:2:0."""
    _, H, W, _ = stack.shape
    pb, pg, pr, _ = bilinear_sample_patch_u8_cuda(stack, x_s, y_s, out_size,
                                                  planes=True)
    masks = bilinear_mask(H, W, x_s, y_s).reshape(2 * B, *out_size)
    if fusion_mode == "AVERAGE":
        fused = [average_fusion(p[:B], p[B:]) for p in (pb, pg, pr)]
    elif fusion_mode == "LINEAR":
        mask1 = linear_blend_mask(masks[:B], masks[B:])
        mask2 = (1.0 - mask1) * masks[B:]
        fused = [p[:B] * mask1 + p[B:] * mask2 for p in (pb, pg, pr)]
    else:
        raise ValueError(f"unknown fusion_mode {fusion_mode!r}")
    return bgr_planes_to_yuv420(*(torch.clamp(p, 0.0, 255.0) for p in fused))


def composite_chunk(img1: torch.Tensor, img2: torch.Tensor,
                    mesh1: torch.Tensor, mesh2: torch.Tensor,
                    offset: torch.Tensor, out_size: Tuple[int, int],
                    fusion_mode: str, grid_span, warp_mode: str = "NORMAL",
                    out_format: str = "bgr", coord_stride: int = 1,
                    fused_warp: bool = True):
    """Warp and fuse one chunk onto the padded canvas.

    img1/img2: [B, H, W, 3] uint8 (or float 0..255); mesh1/mesh2:
    [B, GH+1, GW+1, 2] frame-resolution pixel meshes; offset: [2] (x_min,
    y_min). Returns uint8 [B, pad_h, pad_w, 3] for ``out_format`` 'bgr', or
    the uint8 I420 planes (Y [B, pad_h, pad_w], U, V [B, pad_h/2, pad_w/2])
    for 'yuv420'. ``fused_warp`` asks for route A; the module docstring
    lists the routes.
    """
    B = img1.shape[0]
    input_u8 = img1.dtype == torch.uint8 and img2.dtype == torch.uint8
    if not input_u8:
        img1, img2 = img1.to(torch.float32), img2.to(torch.float32)
    stack, T, source = warp_inputs(img1, img2, mesh1, mesh2, offset, grid_span)
    _, H, W, _ = stack.shape
    if (fused_warp and warp_mode == "NORMAL" and input_u8
            and coord_stride == 1):
        pb, pg, pr, masks, _ = fused_warp_planes(stack, T, source, out_size,
                                                 grid_span=grid_span)
        warped = torch.stack([pb, pg, pr], dim=-1)          # [2B, oh, ow, 3]
    else:
        x_s, y_s = tps_sample_coords(T, source, out_size, grid_span=grid_span,
                                     coord_stride=coord_stride)
        if warp_mode == "NORMAL":
            if input_u8 and out_format == "yuv420":
                return _planar_yuv420(stack, x_s, y_s, out_size, B,
                                      fusion_mode)
            if input_u8:
                warped, _ = bilinear_sample_patch_u8_cuda(stack, x_s, y_s,
                                                          out_size)
            else:
                warped = bilinear_sample(stack, x_s, y_s)
            m = bilinear_mask(H, W, x_s, y_s)
        elif warp_mode == "FAST":
            warped = grid_sample_align_corners(stack.to(torch.float32),
                                               x_s, y_s)
            m = grid_sample_mask_align_corners(H, W, x_s, y_s)
        else:
            raise ValueError(f"unknown warp_mode {warp_mode!r}")
        warped = warped.reshape(2 * B, *out_size, 3)
        masks = m.reshape(2 * B, *out_size)
    fused = _fuse(warped[:B], warped[B:], masks[:B], masks[B:], fusion_mode)
    fused = torch.clamp(fused, 0.0, 255.0)
    if out_format == "yuv420":
        return bgr_to_yuv420(fused)
    return fused.to(torch.uint8)


def _to_device(x, device) -> torch.Tensor:
    """Frames onto the device: numpy arrays as uint8 (as the JAX package
    takes host frames), tensors as they are."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x, dtype=np.uint8))
    return x.to(device)


def composite_begin(img1, img2, smooth_mesh1: torch.Tensor,
                    smooth_mesh2: torch.Tensor,
                    config: Optional[StitchConfig] = None, chunk: int = 8,
                    model_size: Tuple[int, int] = (MODEL_H, MODEL_W)):
    """Launch a whole video's composite on the meshes' device.

    img1/img2: [T, H, W, 3] uint8 (numpy or tensor; a float tensor takes
    the float route); smooth_mesh*: [T, GH+1, GW+1, 2] model-resolution
    meshes. Returns the pending state for :func:`composite_finish`: the
    cropped chunks, still on the device, the canvas and the format.
    """
    config = config or StitchConfig()
    fused = config.fused_warp
    if fused is None:
        fused = config.warp_mode == "NORMAL" and config.coord_stride == 1
    out_format = config.download_format
    # the NORMAL gather route's yuv420 is chained: uint8 BGR, then the
    # conversion (JAX chains only there: its auto gather is NORMAL-only)
    chain_yuv = (not fused and config.warp_mode == "NORMAL"
                 and out_format == "yuv420")
    device = smooth_mesh1.device
    T, H, W, _ = img1.shape
    m1 = scale_meshes(smooth_mesh1, H, W, *model_size)
    m2 = scale_meshes(smooth_mesh2, H, W, *model_size)
    canvas = compute_canvas(m1, m2, config.canvas_bucket)
    if canvas.pad_h > config.max_canvas_h or canvas.pad_w > config.max_canvas_w:
        raise ValueError(
            f"canvas {canvas.pad_h}x{canvas.pad_w} exceeds configured max "
            f"{config.max_canvas_h}x{config.max_canvas_w}")
    # the normalization span keeps the true extent; yuv420 frames are
    # cropped to even sizes, and the canvas describes the frames emitted
    grid_span = (np.float32(canvas.out_h), np.float32(canvas.out_w))
    if out_format == "yuv420":
        canvas = dataclasses.replace(canvas, out_h=canvas.out_h // 2 * 2,
                                     out_w=canvas.out_w // 2 * 2)
    oh, ow = canvas.out_h, canvas.out_w
    offset = torch.tensor([canvas.x_min, canvas.y_min], dtype=torch.float32,
                          device=device)
    pending: List[Tuple[torch.Tensor, ...]] = []
    for s in range(0, T, chunk):
        e = min(s + chunk, T)
        out = composite_chunk(_to_device(img1[s:e], device),
                              _to_device(img2[s:e], device),
                              m1[s:e], m2[s:e], offset,
                              (canvas.pad_h, canvas.pad_w),
                              config.fusion_mode, grid_span,
                              warp_mode=config.warp_mode,
                              out_format="bgr" if chain_yuv else out_format,
                              coord_stride=config.coord_stride,
                              fused_warp=fused)
        if chain_yuv:
            out = bgr_u8_to_yuv420(out)
        if out_format == "yuv420":
            y, u, v = out
            pending.append((y[:, :oh, :ow], u[:, :oh // 2, :ow // 2],
                            v[:, :oh // 2, :ow // 2]))
        else:
            pending.append((out[:, :oh, :ow],))
    return pending, canvas, out_format


def composite_finish(state) -> Tuple[np.ndarray, Canvas]:
    """Fetch the chunks of :func:`composite_begin`: uint8 BGR frames
    [T, oh, ow, 3], or packed I420 [T, oh*3//2, ow] for yuv420."""
    pending, canvas, out_format = state
    # one contiguous copy per plane: the crops are strided views
    host = [torch.cat(planes, 0).cpu().numpy() for planes in zip(*pending)]
    if out_format == "yuv420":
        return pack_i420_host(*host), canvas
    return host[0], canvas


def composite_video(img1, img2, smooth_mesh1: torch.Tensor,
                    smooth_mesh2: torch.Tensor,
                    config: Optional[StitchConfig] = None, chunk: int = 8,
                    model_size: Tuple[int, int] = (MODEL_H, MODEL_W)
                    ) -> Tuple[np.ndarray, Canvas]:
    """Composite a whole video: (frames, canvas), the frames as
    :func:`composite_finish` returns them."""
    return composite_finish(composite_begin(img1, img2, smooth_mesh1,
                                            smooth_mesh2, config=config,
                                            chunk=chunk,
                                            model_size=model_size))
