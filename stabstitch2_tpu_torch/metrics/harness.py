"""Per-video and per-dataset metric evaluation (port of
``metrics/harness.py``; the reference's ``test_metric_ssd.py``).

For one video: the motion and smoothing phases of the stitch path, then
stability from the continued view-2 smooth path, distortion from the
view-2 smooth meshes, and per frame PSNR and SSIM of the two views, each
warped on its own at model resolution (NORMAL mode, no fusion) and cut to
their overlap. The float images warp through ``tps_warp_with_mask``: K3
evaluates the spline on the card, then the float ``bilinear_sample``.
Scores are aggregated per StabStitch-D difficulty category and overall.

With ``fused_motion`` (the default) a video is one program per 16-frame
length bucket, the JAX package's ``_fused_eval``: the frames are padded
to Tb (T rounded up to 16, then to a multiple of the chunk) by repeating
the last frame, uploaded once per view, and :func:`_fused_eval` does the
rest, normalization (or the I420 unpack) included, with the true frame
count as a 0-dim tensor on the card: the stability and distortion are
masked to it (``scores.py:stability_distortion``) and PSNR and SSIM are
cropped to it in the one fetch. The program runs through the stitcher's
``GraphCache`` under the name ``metric``: on a card its first call per
(bucket, input format) runs eagerly and is captured, and every later
video in the bucket, whatever its length, replays that one graph; on the
CPU it is called directly. Inside it the motion runs eagerly at the
chunk shape (a capture cannot replay another graph) and the warp with
PSNR and SSIM chunk by chunk, as JAX's ``lax.map``, on cuSOLVER's linear
algebra (``train/common.py:batched_lu_on_cublas``; MAGMA's batched LU
waits for the host and cannot be captured).

On several devices one graph cannot span the replicas (the smoothing on
the first device needs every chunk's motion), so the video is three kinds
of program: the per-chunk motion programs on each replica, as
``motion_smooth`` runs them; the bucket's smoothing with the masked scores
on the first device; and the warp with PSNR and SSIM per chunk on the
chunk's replica. They run the functions of the one program on the same
shapes, so the scores equal one device's bit for bit.

``fused_motion=False`` (``cli --eager_motion``) runs eagerly at the true
T: a video is one upload per view (per device, its chunks), normalized on
the device, and one fetch of its scores. Either way a dataset submits
video k+1 before it collects video k.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from stabstitch2_tpu_torch.metrics.psnr_ssim import psnr, ssim
from stabstitch2_tpu_torch.metrics.scores import (continue_paths,
                                                  distortion_score,
                                                  stability_distortion,
                                                  stability_score)
from stabstitch2_tpu_torch.ops.mesh import mesh_points, normalize_mesh, rigid_mesh
from stabstitch2_tpu_torch.ops.tps import tps_warp_with_mask
from stabstitch2_tpu_torch.ops.yuv import unpack_i420_u8
from stabstitch2_tpu_torch.pipeline.stitcher import model_input
from stabstitch2_tpu_torch.train.common import batched_lu_on_cublas

# StabStitch-D difficulty categories (the reference's test_metric_ssd.py)
SSD_CATEGORIES = {
    "RE": ["00000107", "00000101", "MR002", "S13", "S28"],
    "LL": ["0000074", "0000085", "0000090", "0000099", "00000100"],
    "LT": ["0000021", "0000037", "0000040", "00000140", "ML001"],
    "MF": ["00000168", "00000175", "00000224", "MR006", "SF34"],
}

# the length bucket of the metric program, as the JAX package's
METRIC_BUCKET = 16


def metric_bucket(T: int, chunk: int) -> int:
    """Tb: T rounded up to the bucket, then to a multiple of the chunk."""
    Tb = -(-T // METRIC_BUCKET) * METRIC_BUCKET
    return -(-Tb // chunk) * chunk


def pad_frames(x: np.ndarray, n: int) -> np.ndarray:
    """Host frames [T, ...] padded to [n, ...] by repeating the last."""
    if x.shape[0] == n:
        return x
    return np.concatenate([x, np.repeat(x[-1:], n - x.shape[0], 0)], 0)


def _normalize(lo: torch.Tensor, mh: int, mw: int) -> torch.Tensor:
    """Uploaded frames as the model input in [-1, 1]: uint8 BGR
    normalized, packed I420 [T, mh*3//2, mw] unpacked first, float as it
    is."""
    if lo.dtype != torch.uint8:
        return lo
    return model_input(unpack_i420_u8(lo) if lo.dim() == 3 else lo, mh, mw)


def _warp_program(stitcher) -> Callable:
    """(a, b, mesh1, mesh2) -> (psnr [c], ssim [c]): chunk ``a``, ``b`` of
    both views' model input in [-1, 1] warped by their smooth meshes at
    model resolution, cut to the overlap of the two coverage masks. The
    captured forms call it under ``batched_lu_on_cublas``."""
    mh, mw = stitcher.model_h, stitcher.model_w
    batched_psnr, batched_ssim = torch.vmap(psnr), torch.vmap(ssim)

    def warp(lo, mesh):
        rigid = rigid_mesh(mh, mw, device=lo.device)
        norm_rigid = mesh_points(normalize_mesh(rigid, mh, mw))
        src = mesh_points(normalize_mesh(mesh, mh, mw))
        return tps_warp_with_mask((lo + 1.0) * 127.5, src,
                                  norm_rigid[None].expand(src.shape),
                                  (mh, mw), mode="NORMAL")

    def program(a, b, mesh1, mesh2):
        w1, k1 = warp(a, mesh1)
        w2, k2 = warp(b, mesh2)
        ov = (k1 * k2)[..., None]
        return batched_psnr(w1 * ov, w2 * ov), batched_ssim(w1 * ov, w2 * ov)

    return program


def _scores_program(stitcher) -> Callable:
    """(tmotion1, smotion1, tmotion2, smotion2, n_frames) -> (smooth
    meshes 1 and 2 [Tb, ...], stability_ori, stability, distortion_ori,
    distortion): the bucket's transport and smoothing, then the scores
    masked to the first ``n_frames`` frames."""
    smooth_program = stitcher.smooth_program()

    def program(tm1, sm1, tm2, sm2, n_frames):
        smooth = smooth_program(tm1, sm1, tm2, sm2)
        return (smooth["smooth_mesh1"], smooth["smooth_mesh2"],
                *stability_distortion(smooth["win_ori_path2"],
                                      smooth["win_smooth_path2"],
                                      smooth["ori_mesh2"],
                                      smooth["smooth_mesh2"], n_frames))

    return program


def _fused_eval(stitcher) -> Callable:
    """The whole evaluation of one video on one device as a function of
    tensors (the JAX package's ``_fused_eval``): (lo1, lo2, n_frames) ->
    (psnr [Tb], ssim [Tb], stability_ori, stability, distortion_ori,
    distortion). lo*: [Tb, mh, mw, 3] uint8 BGR or float [-1, 1], or
    packed I420 [Tb, mh*3//2, mw] uint8, with Tb a multiple of the chunk;
    n_frames: the true frame count, a 0-dim int32 tensor on their device.
    Nothing in it reads a value on the host, so it can be captured."""
    mh, mw, chunk = stitcher.model_h, stitcher.model_w, stitcher.chunk
    scores = _scores_program(stitcher)
    warp = _warp_program(stitcher)

    def program(lo1, lo2, n_frames):
        l1, l2 = _normalize(lo1, mh, mw), _normalize(lo2, mh, mw)
        sm1, sm2, tm1, tm2 = stitcher.motions(l1, l2)
        mesh1, mesh2, *masked = scores(tm1, sm1, tm2, sm2, n_frames)
        with batched_lu_on_cublas(l1.device):
            ps, ss = zip(*(warp(l1[s:s + chunk], l2[s:s + chunk],
                                mesh1[s:s + chunk], mesh2[s:s + chunk])
                           for s in range(0, l1.shape[0], chunk)))
        return (torch.cat(ps), torch.cat(ss), *masked)

    return program


@dataclasses.dataclass
class _Submitted:
    """A video in flight: its device results and upload buffers."""

    psnr: torch.Tensor            # [Tb] (or [T] on the eager path)
    ssim: torch.Tensor
    scores: torch.Tensor          # [4]: stability_ori, stability,
    T: int                        # distortion_ori, distortion
    staging: List[torch.Tensor]   # held until collected


def _host_frames(lo1: np.ndarray, lo2: np.ndarray, upload: str):
    """The frames to upload: packed to I420 on the host with
    ``upload='i420'`` where both are uint8 BGR of even size."""
    if upload not in ("bgr", "i420"):
        raise ValueError(f"upload must be 'bgr' or 'i420', got {upload!r}")
    if upload == "i420":
        from stabstitch2_tpu_torch.data.video_io import bgr_to_i420

        def packable(x):
            return (x.dtype == np.uint8 and x.ndim == 4
                    and x.shape[1] % 2 == 0 and x.shape[2] % 2 == 0)

        if packable(lo1) and packable(lo2):
            return bgr_to_i420(lo1), bgr_to_i420(lo2)
    return lo1, lo2


def _padded(stitcher, lo1: np.ndarray, lo2: np.ndarray, upload: str):
    """Both views' host frames to upload, padded to the bucket's Tb by
    repeating the last frame, and the true frame count T."""
    lo1, lo2 = _host_frames(lo1, lo2, upload)
    T, window = lo1.shape[0], stitcher.config.window
    if T < window:
        raise ValueError(f"need at least {window} frames, got {T}")
    Tb = metric_bucket(T, stitcher.chunk)
    return pad_frames(lo1, Tb), pad_frames(lo2, Tb), T


def metric_inputs(stitcher, lo1: np.ndarray, lo2: np.ndarray,
                  upload: str, staging: List[torch.Tensor]):
    """The inputs of :func:`_fused_eval` on the stitcher's first device:
    both views padded on the host and uploaded (page-locked buffers
    appended to ``staging``), and the frame count made on the device.
    Returns (lo1, lo2, n_frames, T)."""
    x1, x2, T = _padded(stitcher, lo1, lo2, upload)
    d1, d2 = (stitcher.upload(x, np.uint8 if x.dtype == np.uint8
                              else np.float32, staging) for x in (x1, x2))
    # filled on the card: nothing is copied from the host
    n_frames = torch.full((), T, dtype=torch.int32, device=stitcher.device)
    return d1, d2, n_frames, T


@torch.no_grad()
def _submit_video(stitcher, lo1: np.ndarray, lo2: np.ndarray,
                  upload: str = "bgr") -> _Submitted:
    """Enqueue one video's evaluation; nothing waits for the card. Returns
    the handle :func:`_collect_video` reads."""
    if not stitcher.fused_motion:
        return _submit_eager(stitcher, *_host_frames(lo1, lo2, upload))
    staging: List[torch.Tensor] = []
    if len(stitcher.devices) > 1:
        return _submit_composed(stitcher, *_padded(stitcher, lo1, lo2,
                                                   upload), staging)
    x1, x2, n_frames, T = metric_inputs(stitcher, lo1, lo2, upload, staging)
    ps, ss, *scores = stitcher.graphs.run(
        "metric", _fused_eval(stitcher), x1, x2, n_frames,
        modules=(stitcher.spatial_net, stitcher.temporal_net,
                 stitcher.smooth_net))
    return _Submitted(ps, ss, torch.stack(scores), T, staging)


def _submit_composed(stitcher, x1: np.ndarray, x2: np.ndarray, T: int,
                     staging: List[torch.Tensor]) -> _Submitted:
    """:func:`_fused_eval`'s functions on several devices, each a program
    of the stitcher's ``GraphCache`` (see the module docstring), on the
    padded host frames ``x1``, ``x2`` of a T-frame video."""
    graphs, first = stitcher.graphs, stitcher.device
    l1 = stitcher.model_inputs(x1, staging)
    l2 = stitcher.model_inputs(x2, staging)
    sm1, sm2, tm1, tm2 = stitcher.motions(l1, l2, graphs)
    n_frames = torch.full((), T, dtype=torch.int32, device=first)
    mesh1, mesh2, *scores = graphs.run(
        "metric_scores", _scores_program(stitcher), tm1, sm1, tm2, sm2,
        n_frames, modules=(stitcher.smooth_net,))
    warp = _warp_program(stitcher)
    ps, ss, s = [], [], 0
    for a, b in zip(l1, l2):
        e, dev = s + a.shape[0], a.device
        with batched_lu_on_cublas(dev):
            p, q = graphs.run("metric_warp", warp, a, b,
                              mesh1[s:e].to(dev, non_blocking=True),
                              mesh2[s:e].to(dev, non_blocking=True))
        ps.append(p.to(first, non_blocking=True))
        ss.append(q.to(first, non_blocking=True))
        s = e
    return _Submitted(torch.cat(ps), torch.cat(ss), torch.stack(scores), T,
                      staging)


def _submit_eager(stitcher, lo1, lo2) -> _Submitted:
    """``--eager_motion``: eagerly at the true T, chunk by chunk, each on
    the device that holds its model input."""
    staging: List[torch.Tensor] = []
    l1 = stitcher.model_inputs(lo1, staging)
    l2 = stitcher.model_inputs(lo2, staging)
    smooth = stitcher.motion_smooth(l1, l2)
    ori, sm = continue_paths(smooth["win_ori_path2"],
                             smooth["win_smooth_path2"])
    scores = torch.stack([stability_score(ori), stability_score(sm),
                          distortion_score(smooth["ori_mesh2"]),
                          distortion_score(smooth["smooth_mesh2"])])
    warp = _warp_program(stitcher)
    ps, ss, s = [], [], 0
    for a, b in zip(l1, l2):
        e = s + a.shape[0]
        p, q = warp(a, b, smooth["smooth_mesh1"][s:e].to(a.device),
                    smooth["smooth_mesh2"][s:e].to(a.device))
        ps.append(p.to(scores.device))
        ss.append(q.to(scores.device))
        s = e
    return _Submitted(torch.cat(ps), torch.cat(ss), scores, lo1.shape[0],
                      staging)


def _collect_video(handle: _Submitted) -> Dict[str, float]:
    """Fetch one submitted video's scores: the mean PSNR and SSIM over its
    T frames, stability and distortion after smoothing and before
    (_ori)."""
    T = handle.T
    host = torch.cat([handle.psnr[:T], handle.ssim[:T],
                      handle.scores]).cpu().numpy()     # one fetch
    ps, ss, scores = host[:T], host[T:2 * T], host[2 * T:]
    return {"psnr": float(np.mean(ps)), "ssim": float(np.mean(ss)),
            "stability": float(scores[1]), "distortion": float(scores[3]),
            "stability_ori": float(scores[0]),
            "distortion_ori": float(scores[2])}


def evaluate_video(stitcher, lo1: np.ndarray, lo2: np.ndarray,
                   upload: str = "bgr") -> Dict[str, float]:
    """All four metrics of one video from its model-size frames [T, mh,
    mw, 3]: uint8 BGR (normalized on the device) or float [-1, 1].

    ``upload='i420'`` packs uint8 BGR to 4:2:0 on the host and unpacks it
    on the device: half the upload bytes, but the chroma subsampling
    changes the frames the scores read, so the numbers move slightly.
    """
    return _collect_video(_submit_video(stitcher, lo1, lo2, upload))


def evaluate_dataset(stitcher, dataset_dir: str,
                     categories: Optional[Dict[str, List[str]]] = None,
                     max_videos: Optional[int] = None,
                     upload: str = "bgr") -> Dict:
    """Per-video scores, their average, and the average of each category
    (None where the dataset has none of its videos)."""
    from stabstitch2_tpu_torch.data.video_io import (list_videos,
                                                     load_video_pair)

    categories = SSD_CATEGORIES if categories is None else categories
    videos = list_videos(dataset_dir)
    if max_videos:
        videos = videos[:max_videos]
    per_video: Dict[str, Dict[str, float]] = {}
    pending = None
    for vd in videos:
        _, lo1, _, lo2 = load_video_pair(
            vd, model_size=(stitcher.model_h, stitcher.model_w),
            want_hi=False, normalize=False)
        handle = _submit_video(stitcher, lo1, lo2, upload=upload)
        if pending is not None:
            per_video[pending[0]] = _collect_video(pending[1])
        pending = (os.path.basename(vd), handle)
    if pending is not None:
        per_video[pending[0]] = _collect_video(pending[1])

    def agg(names):
        rows = [per_video[n] for n in names if n in per_video]
        if not rows:
            return None
        return {k: float(np.mean([r[k] for r in rows])) for k in rows[0]}

    report = {"per_video": per_video, "average": agg(list(per_video))}
    for cat, names in categories.items():
        report[cat] = agg(names)
    return report
