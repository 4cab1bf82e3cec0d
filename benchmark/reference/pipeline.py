"""The stitching pipeline in plain PyTorch, float32: what each cell's
output should be.

- :func:`video_meshes`: a whole two-view video's smooth meshes: spatial
  motion of every pair, temporal motion of every frame against the one
  before (zero at t = 0), the temporal motion carried into the stitched
  frame (for t >= 1 the lattice ``rigid + tmotion_t`` mapped through the
  spline ``rigid -> rigid + smotion_{t-1}``, minus ``rigid + smotion_t``),
  and ``SmoothNet`` on every window of ``window`` frames (each window's
  first carried motion zero; the first window kept whole, each later one
  giving its last frame).
- :func:`window_mesh`: the smooth meshes of one window as a stream of
  pushes leaves it after its last push (the online stitcher).
- :func:`chain`: N views as a chain of adjacent pairs, each junction
  aligned by the shared view's mean offset and re-expressed in the
  junction's middle plane by a spline point transform.
- :func:`plan_canvas`, :func:`composite`: the canvas of a video (the
  meshes' extent at frame resolution, padded up to the bucket; the
  spline normalized by the true extent) and every view warped backwards
  onto it (bilinear from uint8, dead pixels zero), fused AVERAGE or
  LINEAR (left to right), clipped, and written as truncated BGR or
  rounded I420.

Everything runs in blocks of frames, so it fits beside nothing else on
the card; nothing here reads the program under test.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from benchmark.reference import geometry as G

BLOCK = 16      # frames per block of the nets


@dataclasses.dataclass(frozen=True)
class Canvas:
    out_h: int          # frames emitted (cropped to even sizes for I420)
    out_w: int
    pad_h: int          # the padded canvas the warp runs on
    pad_w: int
    x_min: float
    y_min: float
    span_h: float       # the true extent the spline is normalized by
    span_w: float


def _blocks(n: int):
    for s in range(0, n, BLOCK):
        yield s, min(s + BLOCK, n)


@torch.no_grad()
def motions(nets, lo1, lo2):
    """Spatial motions (view 1, view 2) and trunk features of each view for
    model inputs [T, mh, mw, 3]."""
    sp, tp = nets["spatial"], nets["temporal"]
    _, mh, mw, _ = lo1.shape
    s1, s2, f1, f2 = [], [], [], []
    for s, e in _blocks(lo1.shape[0]):
        a, b = G.spatial_motions(*sp(lo1[s:e], lo2[s:e]), mh, mw)
        s1.append(a)
        s2.append(b)
        f1.append(tp.features(lo1[s:e]))
        f2.append(tp.features(lo2[s:e]))
    return (torch.cat(s1), torch.cat(s2), torch.cat(f1), torch.cat(f2))


@torch.no_grad()
def temporal(nets, feats):
    """Temporal motions [T, GH+1, GW+1, 2] of frames t against t - 1
    (zero at t = 0) from trunk features [T, ...]."""
    tp = nets["temporal"]
    out = [torch.zeros(1, tp.grid_h + 1, tp.grid_w + 1, 2,
                       device=feats.device)]
    for s, e in _blocks(feats.shape[0] - 1):
        out.append(tp.motion_from_features(feats[s:e], feats[s + 1:e + 1]))
    return torch.cat(out)


def transport(tmotion, smotion_prev, smotion, mh, mw):
    """Temporal motions [N, ...] carried into the stitched frame."""
    gh, gw = tmotion.shape[1] - 1, tmotion.shape[2] - 1
    rigid = G.rigid_mesh(mh, mw, gh, gw, tmotion.device)
    src = G.points(G.normalize_mesh(rigid, mh, mw))[None].expand(
        tmotion.shape[0], -1, 2)
    tgt = G.points(G.normalize_mesh(rigid + smotion_prev, mh, mw))
    pts = G.points(G.normalize_mesh(rigid + tmotion, mh, mw))
    moved = G.transform_points(pts, src, tgt).reshape(tmotion.shape)
    return G.denormalize_mesh(moved, mh, mw) - (rigid + smotion)


@torch.no_grad()
def smooth_windows(net, sm1, sm2, ts1, ts2, window):
    """``SmoothNet`` on windows [N, window, ...] (each window's first
    carried motion set to zero): (smooth mesh 1, smooth mesh 2)."""
    ts1, ts2 = ts1.clone(), ts2.clone()
    ts1[:, 0] = 0.0
    ts2[:, 0] = 0.0
    out = [net(sm1[s:e], sm2[s:e], ts1[s:e], ts2[s:e])
           for s, e in _blocks(sm1.shape[0])]
    return (torch.cat([o["smooth_mesh1"] for o in out]),
            torch.cat([o["smooth_mesh2"] for o in out]))


@torch.no_grad()
def video_meshes(nets, lo1, lo2, window: int) -> Dict[str, torch.Tensor]:
    """A two-view video's meshes at model resolution, [T, GH+1, GW+1, 2]
    each: ``ori_mesh*`` (rigid + spatial motion) and ``smooth_mesh*``."""
    T, mh, mw, _ = lo1.shape
    s1, s2, f1, f2 = motions(nets, lo1, lo2)
    ts = []
    for s, f in ((s1, f1), (s2, f2)):
        t = transport(temporal(nets, f)[1:], s[:-1], s[1:], mh, mw)
        ts.append(torch.cat([torch.zeros_like(t[:1]), t]))
    rigid = G.rigid_mesh(mh, mw, s1.shape[1] - 1, s1.shape[2] - 1, s1.device)
    o1, o2 = rigid + s1, rigid + s2
    idx = (torch.arange(T - window + 1, device=s1.device)[:, None]
           + torch.arange(window, device=s1.device)[None])
    w1, w2 = smooth_windows(nets["smooth"], o1[idx], o2[idx], ts[0][idx],
                            ts[1][idx], window)

    def assemble(w):
        return torch.cat([w[0], w[1:, -1]])

    return {"ori_mesh1": o1, "ori_mesh2": o2,
            "smooth_mesh1": assemble(w1), "smooth_mesh2": assemble(w2)}


@torch.no_grad()
def window_mesh(nets, lo1, lo2) -> Tuple[torch.Tensor, torch.Tensor]:
    """The smooth meshes [window, GH+1, GW+1, 2] of the window of frames
    [window, mh, mw, 3] pushed one by one into a running stream, as it
    stands after its last push."""
    _, mh, mw, _ = lo1.shape
    s1, s2, f1, f2 = motions(nets, lo1, lo2)
    ts = [torch.cat([torch.zeros_like(s[:1]),
                     transport(temporal(nets, f)[1:], s[:-1], s[1:], mh, mw)])
          for s, f in ((s1, f1), (s2, f2))]
    rigid = G.rigid_mesh(mh, mw, s1.shape[1] - 1, s1.shape[2] - 1, s1.device)
    w1, w2 = smooth_windows(nets["smooth"], (rigid + s1)[None],
                            (rigid + s2)[None], ts[0][None], ts[1][None],
                            lo1.shape[0])
    return w1[0], w2[0]


def scale_meshes(mesh, img_h, img_w, mh, mw):
    return mesh * G.const([img_w / float(mw), img_h / float(mh)], mesh.device)


def plan_canvas(meshes: Sequence[torch.Tensor], bucket: int,
                even: bool) -> Canvas:
    """The canvas of frame-resolution meshes: their extent, padded up to
    ``bucket``; with ``even`` (I420) the emitted frames are cropped to
    even sizes while the spline keeps the true extent."""
    m = torch.stack(list(meshes)).cpu().numpy()
    x_min, x_max = float(m[..., 0].min()), float(m[..., 0].max())
    y_min, y_max = float(m[..., 1].min()), float(m[..., 1].max())
    out_w = max(int(np.ceil(x_max - x_min)), 8)
    out_h = max(int(np.ceil(y_max - y_min)), 8)
    return Canvas(out_h=out_h // 2 * 2 if even else out_h,
                  out_w=out_w // 2 * 2 if even else out_w,
                  pad_h=int(np.ceil(out_h / bucket)) * bucket,
                  pad_w=int(np.ceil(out_w / bucket)) * bucket,
                  x_min=x_min, y_min=y_min, span_h=float(np.float32(out_h)),
                  span_w=float(np.float32(out_w)))


@torch.no_grad()
def composite(views: Sequence[torch.Tensor], meshes: Sequence[torch.Tensor],
              canvas: Canvas, fusion: str, out_format: str,
              stats: Optional[dict] = None,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Frames [B, H, W, 3] uint8 of each view and their frame-resolution
    meshes [B, GH+1, GW+1, 2] onto ``canvas``: uint8 BGR [B, oh, ow, 3]
    ('bgr', truncated) or packed I420 [B, oh*3//2, ow] ('i420').
    ``stats`` counts the warps' live pixels ('live') of all ('pixels').
    ``dtype`` is the precision of the spline's evaluation and of the
    fusion (the spline's solve and the sampling stay float32)."""
    B, H, W, _ = views[0].shape
    dev = views[0].device
    gh, gw = meshes[0].shape[1] - 1, meshes[0].shape[2] - 1
    span = (np.float32(canvas.span_h), np.float32(canvas.span_w))
    offset = G.const([canvas.x_min, canvas.y_min], dev)
    target = G.points(G.normalize_mesh(G.rigid_mesh(H, W, gh, gw, dev),
                                       H, W))[None].expand(B, -1, 2)
    size = (canvas.pad_h, canvas.pad_w)
    warped, masks = [], []
    for im, mesh in zip(views, meshes):
        src = G.points(G.normalize_mesh(mesh - offset, span[0], span[1]))
        x, y = G.canvas_coords(G.tps_params(src, target).to(dtype),
                               src.to(dtype), size, span)
        w, m, live = G.sample_u8_live(im, x.float(), y.float())
        if stats is not None:
            stats["live"] = stats.get("live", 0) + int(live.sum())
            stats["pixels"] = stats.get("pixels", 0) + live.numel()
        warped.append(w.reshape(B, *size, 3).to(dtype))
        masks.append(m.reshape(B, *size).to(dtype))
    acc, acc_m = warped[0], masks[0]
    for w, m in zip(warped[1:], masks[1:]):
        if fusion == "AVERAGE":
            acc = G.average_fusion(acc, w)
        elif fusion == "LINEAR":
            acc = G.linear_fusion(acc, w, acc_m, m)
        else:
            raise ValueError(f"unknown fusion {fusion!r}")
        acc_m = acc_m + m - acc_m * m
    acc = torch.clamp(acc.to(torch.float32), 0.0, 255.0)
    oh, ow = canvas.out_h, canvas.out_w
    if out_format == "i420":
        return _crop_i420(G.bgr_to_i420(acc), size, oh, ow)
    return acc.to(torch.uint8)[:, :oh, :ow]


def composite_video(views: Sequence[torch.Tensor],
                    meshes: Sequence[torch.Tensor], canvas: Canvas, cfg: dict,
                    stats: Optional[dict] = None,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """:func:`composite` of whole videos, chunk by chunk of the
    configuration's ``chunk``, in its fusion and download format."""
    fmt = "i420" if cfg["download_format"] == "yuv420" else "bgr"
    return torch.cat([
        composite([v[s:e] for v in views], [m[s:e] for m in meshes], canvas,
                  cfg["fusion_mode"], fmt, stats, dtype)
        for s, e in chunks(views[0].shape[0], cfg["chunk"])])


def _crop_i420(packed, size, oh, ow):
    """Packed I420 of the padded canvas -> of its (oh, ow) corner."""
    B = packed.shape[0]
    ph, pw = size
    flat = packed.reshape(B, -1)
    n = ph * pw
    y = flat[:, :n].reshape(B, ph, pw)[:, :oh, :ow]
    u = flat[:, n:n + n // 4].reshape(B, ph // 2, pw // 2)[:, :oh // 2,
                                                           :ow // 2]
    v = flat[:, n + n // 4:].reshape(B, ph // 2, pw // 2)[:, :oh // 2,
                                                          :ow // 2]
    return torch.cat([y.reshape(B, -1), u.reshape(B, -1), v.reshape(B, -1)],
                     1).reshape(B, oh * 3 // 2, ow)


def chain(pair_meshes: List[Tuple[torch.Tensor, torch.Tensor]], img_h: int,
          img_w: int, mh: int, mw: int) -> List[torch.Tensor]:
    """One frame-resolution mesh [T, GH+1, GW+1, 2] per view from the
    adjacent pairs' smooth meshes at model resolution."""
    scaled = [(scale_meshes(a, img_h, img_w, mh, mw),
               scale_meshes(b, img_h, img_w, mh, mw)) for a, b in pair_meshes]
    views = [scaled[0][0]]
    plane = scaled[0][1]

    def reproject(m, src_m, tgt_m, oh, ow):
        pts = G.points(G.normalize_mesh(m, oh, ow))
        src = G.points(G.normalize_mesh(src_m, oh, ow))
        tgt = G.points(G.normalize_mesh(tgt_m, oh, ow))
        return G.denormalize_mesh(G.transform_points(pts, src, tgt)
                                  .reshape(m.shape), oh, ow)

    for nref, ntgt in scaled[1:]:
        off = torch.mean(plane - nref, dim=(1, 2), keepdim=True)
        nref, ntgt = nref + off, ntgt + off
        allm = torch.stack(views + [plane, nref, ntgt])
        oh = float(allm[..., 1].amax() - allm[..., 1].amin())
        ow = float(allm[..., 0].amax() - allm[..., 0].amin())
        middle = (plane + nref) / 2.0
        views = [reproject(v, plane, middle, oh, ow) for v in views]
        views.append(middle)
        plane = reproject(ntgt, nref, middle, oh, ow)
    views.append(plane)
    return views


def lo_of(frames_u8, mh, mw):
    """Model inputs of uint8 BGR frames, in blocks."""
    return torch.cat([G.model_input(frames_u8[s:e], mh, mw)
                      for s, e in _blocks(frames_u8.shape[0])])


def chunks(n: int, size: int):
    """(start, end) of consecutive chunks of ``size`` frames of ``n``."""
    return [(s, min(s + size, n)) for s in range(0, n, size)]
