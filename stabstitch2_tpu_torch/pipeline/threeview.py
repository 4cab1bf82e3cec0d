"""Multi-view (N >= 3) stitching as a chain of two-view solutions (port of
``pipeline/threeview.py``).

The two-view pipeline runs on each adjacent pair of views. At every
junction the shared view's two meshes are aligned by their mean offset,
the junction's middle plane is their average, and every mesh already
chained on either side is re-expressed in the middle plane with a TPS
point transform driven by the shared view's mesh change (the reference's
three-view script, iterated over any number of views). All V x B warps of
a chunk go through one ``tps_warp_with_mask`` call (K2 on uint8 NORMAL
input, one launch); the fusion cascades left to right.

:func:`composite_chain_begin` enqueues the chunks and their copies into
page-locked host buffers and returns; the finish waits for the copies, as
the two-view ``composite_begin``/``composite_finish`` do. No repair leg:
the card's gathers cannot overflow.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Tuple

import numpy as np
import torch

from stabstitch2_tpu_torch.config import MODEL_H, MODEL_W, StitchConfig
from stabstitch2_tpu_torch.ops.blend import average_fusion, linear_fusion
from stabstitch2_tpu_torch.ops.mesh import (denormalize_mesh, mesh_points,
                                            normalize_mesh, points_mesh,
                                            rigid_mesh)
from stabstitch2_tpu_torch.ops.tps import (tps_params, tps_transform_points,
                                           tps_warp_with_mask)
from stabstitch2_tpu_torch.pipeline.compositor import (PendingComposite,
                                                       chunk_frames,
                                                       clip_and_convert,
                                                       composite_finish,
                                                       enqueue_chunks,
                                                       fused_route,
                                                       plan_canvas,
                                                       scale_meshes)
from stabstitch2_tpu_torch.pipeline.stitcher import model_input
from stabstitch2_tpu_torch.utils.transfer import constant


def pair_smooth_meshes(stitcher, lo_a, lo_b
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two-view pipeline's smooth meshes (model resolution) of one
    adjacent pair, from its model inputs (tensors or chunk lists)."""
    smooth = stitcher.motion_smooth(lo_a, lo_b)
    return smooth["smooth_mesh1"], smooth["smooth_mesh2"]


def _reproject(meshes: torch.Tensor, source_mesh: torch.Tensor,
               target_mesh: torch.Tensor, oh: float, ow: float
               ) -> torch.Tensor:
    """Map per-frame meshes through the spline source -> target (all
    [T, GH+1, GW+1, 2]), normalized by the extent (oh, ow)."""
    gh, gw = meshes.shape[1] - 1, meshes.shape[2] - 1
    pts = mesh_points(normalize_mesh(meshes, oh, ow))
    src = mesh_points(normalize_mesh(source_mesh, oh, ow))
    tgt = mesh_points(normalize_mesh(target_mesh, oh, ow))
    out = tps_transform_points(pts, src, tgt, T=tps_params(src, tgt))
    return denormalize_mesh(points_mesh(out, grid_h=gh, grid_w=gw), oh, ow)


def chain_meshes(pair_meshes: List[Tuple[torch.Tensor, torch.Tensor]],
                 img_h: int, img_w: int, model_h: int = MODEL_H,
                 model_w: int = MODEL_W) -> List[torch.Tensor]:
    """Compose adjacent-pair meshes into one frame-resolution mesh per view.

    pair_meshes[j] = (mesh of view j, mesh of view j+1) from pair (j, j+1)
    at model resolution. Returns one [T, GH+1, GW+1, 2] per view. Each
    junction reads its extent on the host (one wait per junction).
    """
    scaled = [(scale_meshes(a, img_h, img_w, model_h, model_w),
               scale_meshes(b, img_h, img_w, model_h, model_w))
              for a, b in pair_meshes]
    views = [scaled[0][0]]          # view 0 in pair 0's plane
    plane = scaled[0][1]            # the shared view in the current plane
    for nxt_ref, nxt_tgt in scaled[1:]:
        # align the shared view across the two pairs by its mean offset
        offset = torch.mean(plane - nxt_ref, dim=(1, 2), keepdim=True)
        nxt_ref = nxt_ref + offset
        nxt_tgt = nxt_tgt + offset
        # the point transforms' normalization: the extent of every mesh
        # known so far, after the alignment (the reference also re-bases
        # to the canvas origin; the spline's affine part makes the
        # transform translation-equivariant, so that changes nothing)
        all_m = torch.stack(views + [plane, nxt_ref, nxt_tgt])
        span = torch.stack([all_m[..., 1].amax() - all_m[..., 1].amin(),
                            all_m[..., 0].amax() - all_m[..., 0].amin()])
        oh, ow = (float(v) for v in span.cpu())
        middle = (plane + nxt_ref) / 2.0
        views = [_reproject(v, plane, middle, oh, ow) for v in views]
        views.append(middle)
        plane = _reproject(nxt_tgt, nxt_ref, middle, oh, ow)
    views.append(plane)
    return views


def composite_chain_chunk(imgs: torch.Tensor, meshes: torch.Tensor,
                          offset: torch.Tensor, out_size: Tuple[int, int],
                          warp_mode: str, fusion_mode: str, grid_span,
                          out_format: str = "bgr", coord_stride: int = 1,
                          fused_warp: bool = True):
    """Warp and fuse one chunk of an N-view chain onto the padded canvas.

    imgs: [V, B, H, W, 3] uint8 (or float 0..255); meshes: [V, B, GH+1,
    GW+1, 2] frame-resolution. All V*B warps are one
    :func:`tps_warp_with_mask` call; the fusion cascades left to right.
    Returns uint8 [B, oh, ow, 3] for 'bgr', or the uint8 I420 planes for
    'yuv420' (converted from the clipped float fusion).
    """
    V, B, H, W, _ = imgs.shape
    span_h, span_w = grid_span
    im = imgs.reshape(V * B, H, W, 3)
    if not (im.dtype == torch.uint8 and warp_mode == "NORMAL"):
        im = im.to(torch.float32)
    rigid = rigid_mesh(H, W, grid_h=meshes.shape[2] - 1,
                       grid_w=meshes.shape[3] - 1, device=meshes.device)
    norm_rigid = mesh_points(normalize_mesh(rigid, H, W))
    src = mesh_points(normalize_mesh(
        meshes.reshape(V * B, *meshes.shape[2:]) - offset, span_h, span_w))
    tgt = norm_rigid[None].expand(src.shape)
    warped, masks = tps_warp_with_mask(im, src, tgt, out_size,
                                       mode=warp_mode, grid_span=grid_span,
                                       coord_stride=coord_stride,
                                       fused_warp=fused_warp)
    warped = warped.reshape(V, B, *out_size, 3)
    masks = masks.reshape(V, B, *out_size)
    acc, acc_mask = warped[0], masks[0]
    for k in range(1, V):
        if fusion_mode == "AVERAGE":
            acc = average_fusion(acc, warped[k])
        elif fusion_mode == "LINEAR":
            acc = linear_fusion(acc, warped[k], acc_mask, masks[k])
        else:
            raise ValueError(f"unknown fusion_mode {fusion_mode!r}")
        acc_mask = acc_mask + masks[k] - acc_mask * masks[k]
    return clip_and_convert(acc, out_format)


def composite_chain_begin(images, meshes: List[torch.Tensor],
                          config: StitchConfig, chunk: int = 8
                          ) -> PendingComposite:
    """Enqueue the whole N-view composite; return its pending state.

    images: V frame stacks [T, H, W, 3] uint8, tensors on the meshes'
    device or host arrays (uploaded per chunk), or V chunk lists (chunk k
    of ``chunk`` frames on the device that runs it, as a stitcher on
    several devices deals them); meshes: V frame-resolution meshes [T,
    GH+1, GW+1, 2]. The canvas spans every view's meshes (the one wait);
    for yuv420 the frames are cropped to even sizes while the spline
    keeps the true extent.
    """
    fused = fused_route(config)
    device = meshes[0].device
    T = meshes[0].shape[0]
    stacked = torch.cat(meshes, 0)
    canvas, grid_span = plan_canvas(stacked, stacked, config)
    offsets = {}
    mesh_all = torch.stack(meshes)

    def run(k, s, e, out_format):
        iv = torch.stack([chunk_frames(im, k, s, e, device) for im in images])
        dev = iv.device
        if dev not in offsets:
            offsets[dev] = constant([canvas.x_min, canvas.y_min],
                                    torch.float32, dev)
        return composite_chain_chunk(iv, mesh_all[:, s:e].to(
                                         dev, non_blocking=True),
                                     offsets[dev],
                                     (canvas.pad_h, canvas.pad_w),
                                     config.warp_mode, config.fusion_mode,
                                     grid_span, out_format=out_format,
                                     coord_stride=config.coord_stride,
                                     fused_warp=fused)

    return enqueue_chunks(run, T, chunk, canvas, config, device)


def composite_chain_finish(state: PendingComposite) -> Tuple[np.ndarray, str]:
    """Wait for :func:`composite_chain_begin`'s copies: (frames,
    frame_format), uint8 BGR [T, oh, ow, 3] ('bgr') or packed I420
    [T, oh*3//2, ow] ('i420')."""
    frames, _ = composite_finish(state)
    return frames, "i420" if state.out_format == "yuv420" else "bgr"


def composite_chain(images, meshes: List[torch.Tensor], config: StitchConfig,
                    chunk: int = 8) -> np.ndarray:
    """Warp every view onto the global canvas and cascade the fusion."""
    return composite_chain_finish(composite_chain_begin(images, meshes, config,
                                                        chunk=chunk))[0]


@dataclasses.dataclass
class _PendingMulti:
    composite: PendingComposite
    staging: List[torch.Tensor]     # upload buffers, held until finished


@torch.no_grad()
def stitch_multi_begin(stitcher, his: List[np.ndarray]) -> _PendingMulti:
    """Enqueue an N-view video's whole pipeline; return its pending state.

    his: V host arrays, uint8 BGR [T, H, W, 3] or packed I420
    [T, H*3//2, W], cut to the shortest view's T. Each view crosses to
    the card once (to each of the stitcher's devices, its chunks); its
    model input is made there. Every pair's motion chunks and every
    composite chunk run on the device that holds their frames. Waits for
    the card at each junction's extent and for the canvas.
    """
    mh, mw = stitcher.model_h, stitcher.model_w
    T = min(h.shape[0] for h in his)
    staging: List[torch.Tensor] = []
    parts = [stitcher.upload_parts(h[:T], staging) for h in his]
    frames = [stitcher.chunked(p, T) for p in parts]
    los = [stitcher.chunked([model_input(x, mh, mw) for x in p], T)
           for p in parts]
    pair_meshes = [pair_smooth_meshes(stitcher, los[j], los[j + 1])
                   for j in range(len(his) - 1)]
    H, W = int(frames[0][0].shape[1]), int(frames[0][0].shape[2])
    meshes = chain_meshes(pair_meshes, H, W, mh, mw)
    return _PendingMulti(composite_chain_begin(frames, meshes,
                                               stitcher.config,
                                               chunk=stitcher.chunk), staging)


def stitch_multi_finish(state: _PendingMulti) -> Tuple[np.ndarray, str]:
    """(frames, frame_format) of :func:`stitch_multi_begin`."""
    return composite_chain_finish(state.composite)


def view_dirs(video_dir: str) -> List[str]:
    """The sorted ``video*`` subdirectories of a multi-view clip."""
    return sorted(d for d in os.listdir(video_dir) if d.startswith("video")
                  and os.path.isdir(os.path.join(video_dir, d)))


def stitch_multi_view(stitcher, video_dir: str) -> np.ndarray:
    """Stitch video1..videoN of one clip directory into one panorama video:
    uint8 BGR frames, or packed I420 when the download is yuv420."""
    from stabstitch2_tpu_torch.data.video_io import load_view

    views = view_dirs(video_dir)
    if len(views) < 2:
        raise ValueError(f"need >= 2 views in {video_dir}, found {views}")
    his = [load_view(video_dir, v, model_size=None)[0] for v in views]
    return stitch_multi_finish(stitch_multi_begin(stitcher, his))[0]
