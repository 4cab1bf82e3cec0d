"""Panorama compositor (port of ``pipeline/compositor.py``).

Meshes at model scale are rescaled to the frame resolution; one canvas per
video is sized from the meshes' global extent and padded up to a bucket;
each chunk's two views are warped onto the padded canvas, fused (AVERAGE
or LINEAR) and cropped to the true extent. The spline is normalized by the
true extent, so the padding does not change any kept pixel.

Routes (the dispatch of the JAX package's ``_composite_chunk`` and
``composite_begin``, with its ``pallas_gather`` always on: the card has
one gather, K4, and it cannot overflow, so there is no repair leg); all
but B-planar go through ``ops/tps.py:tps_warp_with_mask``, which the
online stitcher, the N-view chain and the metric harness share:

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

:func:`composite_begin` enqueues a video's chunks and their copies into
host buffers (page-locked on a card, copied with ``non_blocking=True``)
and returns at once; :func:`composite_finish` waits for the copies and
assembles the frames. A caller can begin the next video in between.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from stabstitch2_tpu_torch.config import MODEL_H, MODEL_W, StitchConfig
from stabstitch2_tpu_torch.data.video_io import pack_i420_host
from stabstitch2_tpu_torch.ops.blend import (average_fusion, linear_blend_mask,
                                             linear_fusion)
from stabstitch2_tpu_torch.ops.interp import bilinear_mask
from stabstitch2_tpu_torch.ops.mesh import mesh_points, normalize_mesh, rigid_mesh
from stabstitch2_tpu_torch.ops.patch_gather_cuda import (
    bilinear_sample_patch_u8_cuda)
from stabstitch2_tpu_torch.ops.tps import (tps_params, tps_sample_coords,
                                           tps_warp_with_mask)
from stabstitch2_tpu_torch.ops.yuv import (bgr_planes_to_yuv420, bgr_to_yuv420,
                                           bgr_u8_to_yuv420)
from stabstitch2_tpu_torch.utils.transfer import constant, to_device


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
    return mesh * constant([img_w / float(model_w), img_h / float(model_h)],
                           mesh.dtype, mesh.device)


def compute_canvas(mesh1: torch.Tensor, mesh2: torch.Tensor,
                   bucket: int = 128) -> Canvas:
    """Canvas from the global extent of both views' meshes [T, GH+1, GW+1, 2].

    Fetches the meshes to the host: the one wait for the device that
    :func:`composite_begin` needs, since the canvas size sets the shapes.
    """
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
    if (warp_mode == "NORMAL" and input_u8 and out_format == "yuv420"
            and not (fused_warp and coord_stride == 1)):
        x_s, y_s = tps_sample_coords(T, source, out_size, grid_span=grid_span,
                                     coord_stride=coord_stride)
        return _planar_yuv420(stack, x_s, y_s, out_size, B, fusion_mode)
    warped, masks = tps_warp_with_mask(stack, source, None, out_size,
                                       mode=warp_mode, T=T,
                                       grid_span=grid_span,
                                       coord_stride=coord_stride,
                                       fused_warp=fused_warp)
    return clip_and_convert(
        _fuse(warped[:B], warped[B:], masks[:B], masks[B:], fusion_mode),
        out_format)


def clip_and_convert(fused: torch.Tensor, out_format: str):
    """A float fusion [B, h, w, 3] clipped to 0..255: uint8 BGR for 'bgr'
    (truncated), the uint8 I420 planes of the float values for 'yuv420'."""
    fused = torch.clamp(fused, 0.0, 255.0)
    if out_format == "yuv420":
        return bgr_to_yuv420(fused)
    return fused.to(torch.uint8)


def frames_to_device(x, device) -> torch.Tensor:
    """Frames onto the device: numpy arrays as uint8 (as the JAX package
    takes host frames), tensors as they are."""
    if isinstance(x, np.ndarray):
        return to_device(np.ascontiguousarray(x, dtype=np.uint8), device)
    return x.to(device)


def chunk_frames(x, k: int, s: int, e: int, device) -> torch.Tensor:
    """Frames s..e of a video, chunk ``k``: of a chunk list, the chunk
    itself on its own device; of one array or tensor, the slice moved to
    ``device`` (:func:`frames_to_device`)."""
    if isinstance(x, list):
        return x[k]
    return frames_to_device(x[s:e], device)


@dataclasses.dataclass
class PendingComposite:
    """A video's composite in flight (:func:`composite_begin`)."""

    host: List[torch.Tensor]    # uint8 Y, U, V [T, ..] or BGR [T, oh, ow, 3]
    canvas: Canvas
    out_format: str
    # per card that ran chunks: its last chunk's compute is done, and
    # every copy from it into `host` is done (none on the CPU)
    computed: List[torch.cuda.Event]
    copied: List[torch.cuda.Event]


def record_event(device: torch.device) -> Optional[torch.cuda.Event]:
    if device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event


def wait(events) -> None:
    """Wait for the card up to each event of ``events`` (one event, a list,
    or None: nothing is in flight)."""
    for event in events if isinstance(events, list) else [events]:
        if event is not None:
            event.synchronize()


def host_buffer(shape, dtype: torch.dtype, device: torch.device
                ) -> torch.Tensor:
    """A host buffer for copies off ``device``: page-locked on a card, so a
    ``non_blocking`` copy into it does not wait for the device."""
    return torch.empty(shape, dtype=dtype, pin_memory=device.type == "cuda")


def copy_to_host(host: List[torch.Tensor], tensors) -> None:
    """Enqueue the copies of device tensors into host buffers."""
    for h, t in zip(host, tensors):
        h.copy_(t, non_blocking=True)


def fetch(tensors, device: torch.device) -> List[torch.Tensor]:
    """Device tensors on the host with one wait: the copies into
    page-locked buffers, then an event after them."""
    host = [host_buffer(t.shape, t.dtype, device) for t in tensors]
    copy_to_host(host, tensors)
    wait(record_event(device))
    return host


def fused_route(config: StitchConfig) -> bool:
    """Whether composites take route A: ``config.fused_warp``, whose None
    selects it for NORMAL mode at ``coord_stride`` 1."""
    if config.fused_warp is not None:
        return config.fused_warp
    return config.warp_mode == "NORMAL" and config.coord_stride == 1


def chains_yuv420(config: StitchConfig, out_format: str) -> bool:
    """Whether yuv420 is made from the uint8 BGR composite
    (``bgr_u8_to_yuv420``): on the NORMAL gather route, as the JAX package
    chains only there (its automatic gather is NORMAL-only)."""
    return (not fused_route(config) and config.warp_mode == "NORMAL"
            and out_format == "yuv420")


def plan_canvas(mesh1: torch.Tensor, mesh2: torch.Tensor,
                config: StitchConfig) -> Tuple[Canvas, Tuple]:
    """The canvas of frame-resolution meshes and the spline's normalization
    span (the true extent, float32). Raises past ``config.max_canvas_*``;
    for yuv420 the canvas describes the frames emitted, cropped to even
    sizes. Fetches the meshes' extent: the one wait of a begin."""
    canvas = compute_canvas(mesh1, mesh2, config.canvas_bucket)
    if canvas.pad_h > config.max_canvas_h or canvas.pad_w > config.max_canvas_w:
        raise ValueError(
            f"canvas {canvas.pad_h}x{canvas.pad_w} exceeds configured max "
            f"{config.max_canvas_h}x{config.max_canvas_w}")
    grid_span = (np.float32(canvas.out_h), np.float32(canvas.out_w))
    if config.download_format == "yuv420":
        canvas = dataclasses.replace(canvas, out_h=canvas.out_h // 2 * 2,
                                     out_w=canvas.out_w // 2 * 2)
    return canvas, grid_span


def enqueue_chunks(run: Callable, T: int, chunk: int, canvas: Canvas,
                   config: StitchConfig, device: torch.device
                   ) -> PendingComposite:
    """Enqueue ``run(k, s, e, out_format)``, the padded composite of frames
    s..e (chunk k) on whichever device runs that chunk, chunk by chunk,
    and each crop's copy into host buffers: page-locked and
    ``non_blocking`` on a card, so nothing here waits for the device.
    ``device`` is the first device (it sizes the host buffers' pinning).
    NORMAL-mode yuv420 off the fused route is chained
    (:func:`chains_yuv420`)."""
    out_format = config.download_format
    chain_yuv = chains_yuv420(config, out_format)
    oh, ow = canvas.out_h, canvas.out_w
    shapes = ([(T, oh, ow), (T, oh // 2, ow // 2), (T, oh // 2, ow // 2)]
              if out_format == "yuv420" else [(T, oh, ow, 3)])
    host = [host_buffer(s, torch.uint8, device) for s in shapes]
    computed: Dict[torch.device, Optional[torch.cuda.Event]] = {}
    for k, s in enumerate(range(0, T, chunk)):
        e = min(s + chunk, T)
        out = run(k, s, e, "bgr" if chain_yuv else out_format)
        if chain_yuv:
            out = bgr_u8_to_yuv420(out)
        if out_format == "yuv420":
            y, u, v = out
            crops = (y[:, :oh, :ow], u[:, :oh // 2, :ow // 2],
                     v[:, :oh // 2, :ow // 2])
        else:
            crops = (out[:, :oh, :ow],)
        dev = crops[0].device
        computed[dev] = record_event(dev)   # its latest chunk's compute
        copy_to_host([h[s:e] for h in host], crops)
    copied = [record_event(d) for d in computed]
    return PendingComposite(
        host=host, canvas=canvas, out_format=out_format,
        computed=[e for e in computed.values() if e is not None],
        copied=[e for e in copied if e is not None])


def composite_begin(img1, img2, smooth_mesh1: torch.Tensor,
                    smooth_mesh2: torch.Tensor,
                    config: Optional[StitchConfig] = None, chunk: int = 8,
                    model_size: Tuple[int, int] = (MODEL_H, MODEL_W)):
    """Launch a whole video's composite.

    img1/img2: [T, H, W, 3] uint8 (numpy or tensor; a float tensor takes
    the float route), or chunk lists (chunk k of ``chunk`` frames on the
    device that runs it, as a stitcher on several devices deals them);
    smooth_mesh*: [T, GH+1, GW+1, 2] model-resolution meshes. Chunks of a
    whole video run on the meshes' device. Returns the pending state for
    :func:`composite_finish`; after the canvas fetch nothing waits for the
    device (:func:`enqueue_chunks`).
    """
    config = config or StitchConfig()
    fused = fused_route(config)
    device = smooth_mesh1.device
    if isinstance(img1, list):
        T = sum(x.shape[0] for x in img1)
        H, W = img1[0].shape[1:3]
    else:
        T, H, W, _ = img1.shape
    m1 = scale_meshes(smooth_mesh1, H, W, *model_size)
    m2 = scale_meshes(smooth_mesh2, H, W, *model_size)
    canvas, grid_span = plan_canvas(m1, m2, config)
    offsets = {}

    def run(k, s, e, out_format):
        a = chunk_frames(img1, k, s, e, device)
        b = chunk_frames(img2, k, s, e, device)
        dev = a.device
        if dev not in offsets:
            offsets[dev] = constant([canvas.x_min, canvas.y_min],
                                    torch.float32, dev)
        return composite_chunk(a, b, m1[s:e].to(dev, non_blocking=True),
                               m2[s:e].to(dev, non_blocking=True),
                               offsets[dev], (canvas.pad_h, canvas.pad_w),
                               config.fusion_mode, grid_span,
                               warp_mode=config.warp_mode,
                               out_format=out_format,
                               coord_stride=config.coord_stride,
                               fused_warp=fused)

    return enqueue_chunks(run, T, chunk, canvas, config, device)


def composite_finish(state: PendingComposite, timer=None
                     ) -> Tuple[np.ndarray, Canvas]:
    """Wait for the copies of :func:`composite_begin` and return uint8 BGR
    frames [T, oh, ow, 3] (a view of the host buffer), or packed I420
    [T, oh*3//2, ow] for yuv420, packed here on the host.

    ``timer`` (a ``utils.profiling.PhaseTimer``) gets ``warp_fuse``, until
    each device's last chunk's compute is done, and ``download``, the
    copies' remainder, as in the JAX package.
    """
    wait(state.computed)
    if timer is not None:
        timer.mark("warp_fuse", sync=False)
    wait(state.copied)
    if timer is not None:
        timer.mark("download", sync=False)
    host = [h.numpy() for h in state.host]
    if state.out_format == "yuv420":
        return pack_i420_host(*host), state.canvas
    return host[0], state.canvas


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
