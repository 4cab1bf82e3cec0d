"""Panorama compositor (port of ``pipeline/compositor.py``, fused route).

Meshes at model scale are rescaled to the frame resolution; one canvas per
video is sized from the meshes' global extent and padded up to a bucket;
each chunk's two views are warped onto the padded canvas by the fused
composite-warp kernel K2 (``ops/fused_warp_cuda.py``), fused (AVERAGE or
LINEAR) and cropped to the true extent. The spline is normalized by the
true extent, so the padding does not change any kept pixel. K2 cannot
overflow, so there is no repair leg.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from stabstitch2_tpu_torch.config import MODEL_H, MODEL_W, StitchConfig
from stabstitch2_tpu_torch.ops.blend import average_fusion, linear_fusion
from stabstitch2_tpu_torch.ops.fused_warp_cuda import fused_warp_planes
from stabstitch2_tpu_torch.ops.mesh import mesh_points, normalize_mesh, rigid_mesh
from stabstitch2_tpu_torch.ops.tps import tps_params


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
    """K2's inputs for one chunk: stacked views [2B, H, W, 3], T, source.

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


def composite_chunk(img1: torch.Tensor, img2: torch.Tensor,
                    mesh1: torch.Tensor, mesh2: torch.Tensor,
                    offset: torch.Tensor, out_size: Tuple[int, int],
                    fusion_mode: str, grid_span) -> torch.Tensor:
    """Warp and fuse one chunk onto the padded canvas.

    img1/img2: [B, H, W, 3] uint8; mesh1/mesh2: [B, GH+1, GW+1, 2] frame-
    resolution pixel meshes; offset: [2] (x_min, y_min). Returns uint8
    [B, pad_h, pad_w, 3].
    """
    B = img1.shape[0]
    stack, T, source = warp_inputs(img1, img2, mesh1, mesh2, offset, grid_span)
    pb, pg, pr, masks, _ = fused_warp_planes(stack, T, source, out_size,
                                             grid_span=grid_span)
    warped = torch.stack([pb, pg, pr], dim=-1)          # [2B, oh, ow, 3]
    w1, w2 = warped[:B], warped[B:]
    if fusion_mode == "AVERAGE":
        fused = average_fusion(w1, w2)
    elif fusion_mode == "LINEAR":
        fused = linear_fusion(w1, w2, masks[:B], masks[B:])
    else:
        raise ValueError(f"unknown fusion_mode {fusion_mode!r}")
    return torch.clamp(fused, 0.0, 255.0).to(torch.uint8)


def _to_device_u8(x, device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x, dtype=np.uint8))
    if x.dtype != torch.uint8:
        raise TypeError(f"composite needs uint8 frames, got {x.dtype}")
    return x.to(device)


def composite_begin(img1, img2, smooth_mesh1: torch.Tensor,
                    smooth_mesh2: torch.Tensor,
                    config: Optional[StitchConfig] = None, chunk: int = 8,
                    model_size: Tuple[int, int] = (MODEL_H, MODEL_W)):
    """Launch a whole video's composite on the meshes' device.

    img1/img2: [T, H, W, 3] uint8 (numpy or tensor); smooth_mesh*:
    [T, GH+1, GW+1, 2] model-resolution meshes. Returns the pending state
    for :func:`composite_finish`: the cropped uint8 chunks, still on the
    device, and the canvas.
    """
    config = config or StitchConfig()
    device = smooth_mesh1.device
    T, H, W, _ = img1.shape
    m1 = scale_meshes(smooth_mesh1, H, W, *model_size)
    m2 = scale_meshes(smooth_mesh2, H, W, *model_size)
    canvas = compute_canvas(m1, m2, config.canvas_bucket)
    if canvas.pad_h > config.max_canvas_h or canvas.pad_w > config.max_canvas_w:
        raise ValueError(
            f"canvas {canvas.pad_h}x{canvas.pad_w} exceeds configured max "
            f"{config.max_canvas_h}x{config.max_canvas_w}")
    grid_span = (np.float32(canvas.out_h), np.float32(canvas.out_w))
    offset = torch.tensor([canvas.x_min, canvas.y_min], dtype=torch.float32,
                          device=device)
    pending: List[torch.Tensor] = []
    for s in range(0, T, chunk):
        e = min(s + chunk, T)
        fused = composite_chunk(_to_device_u8(img1[s:e], device),
                                _to_device_u8(img2[s:e], device),
                                m1[s:e], m2[s:e], offset,
                                (canvas.pad_h, canvas.pad_w),
                                config.fusion_mode, grid_span)
        pending.append(fused[:, :canvas.out_h, :canvas.out_w])
    return pending, canvas


def composite_finish(state) -> Tuple[np.ndarray, Canvas]:
    """Fetch the chunks of :func:`composite_begin`: uint8 [T, oh, ow, 3]."""
    pending, canvas = state
    return torch.cat(pending, 0).cpu().numpy(), canvas


def composite_video(img1, img2, smooth_mesh1: torch.Tensor,
                    smooth_mesh2: torch.Tensor,
                    config: Optional[StitchConfig] = None, chunk: int = 8,
                    model_size: Tuple[int, int] = (MODEL_H, MODEL_W)
                    ) -> Tuple[np.ndarray, Canvas]:
    """Composite a whole video: (uint8 BGR frames [T, oh, ow, 3], canvas)."""
    return composite_finish(composite_begin(img1, img2, smooth_mesh1,
                                            smooth_mesh2, config=config,
                                            chunk=chunk,
                                            model_size=model_size))
