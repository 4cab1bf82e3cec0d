"""Per-video and per-dataset metric evaluation (port of
``metrics/harness.py``; the reference's ``test_metric_ssd.py``).

For one video: the motion and smoothing phases of the stitch path, then
stability from the continued view-2 smooth path, distortion from the
view-2 smooth meshes, and per frame PSNR and SSIM of the two views, each
warped on its own at model resolution (NORMAL mode, no fusion) and cut to
their overlap. The float images warp through ``tps_warp_with_mask``: K3
evaluates the spline on the card, then the float ``bilinear_sample``.
Scores are aggregated per StabStitch-D difficulty category and overall.

Eager and at the true frame count: a video is one upload per view (uint8
BGR, or packed I420 with ``upload='i420'``; per device, its chunks, when
the stitcher has several), normalized on the device, and one fetch of its
scores; a dataset submits video k+1 before it collects video k.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from stabstitch2_tpu_torch.metrics.psnr_ssim import psnr, ssim
from stabstitch2_tpu_torch.metrics.scores import (continue_paths,
                                                  distortion_score,
                                                  stability_score)
from stabstitch2_tpu_torch.ops.mesh import mesh_points, normalize_mesh, rigid_mesh
from stabstitch2_tpu_torch.ops.tps import tps_warp_with_mask

# StabStitch-D difficulty categories (the reference's test_metric_ssd.py)
SSD_CATEGORIES = {
    "RE": ["00000107", "00000101", "MR002", "S13", "S28"],
    "LL": ["0000074", "0000085", "0000090", "0000099", "00000100"],
    "LT": ["0000021", "0000037", "0000040", "00000140", "ML001"],
    "MF": ["00000168", "00000175", "00000224", "MR006", "SF34"],
}


@torch.no_grad()
def _submit_video(stitcher, lo1: np.ndarray, lo2: np.ndarray,
                  upload: str = "bgr"):
    """Enqueue one video's evaluation; nothing waits for the card. Returns
    the handle :func:`_collect_video` reads."""
    if upload not in ("bgr", "i420"):
        raise ValueError(f"upload must be 'bgr' or 'i420', got {upload!r}")
    if upload == "i420":
        from stabstitch2_tpu_torch.data.video_io import bgr_to_i420

        def packable(x):
            return (x.dtype == np.uint8 and x.ndim == 4
                    and x.shape[1] % 2 == 0 and x.shape[2] % 2 == 0)

        if packable(lo1) and packable(lo2):
            lo1, lo2 = bgr_to_i420(lo1), bgr_to_i420(lo2)
    staging: List[torch.Tensor] = []
    l1 = stitcher.model_inputs(lo1, staging)
    l2 = stitcher.model_inputs(lo2, staging)
    smooth = stitcher.motion_smooth(l1, l2)
    ori, sm = continue_paths(smooth["win_ori_path2"],
                             smooth["win_smooth_path2"])
    scores = torch.stack([stability_score(ori), stability_score(sm),
                          distortion_score(smooth["ori_mesh2"]),
                          distortion_score(smooth["smooth_mesh2"])])

    mh, mw = stitcher.model_h, stitcher.model_w
    batched_psnr, batched_ssim = torch.vmap(psnr), torch.vmap(ssim)

    def warp(lo, mesh):
        rigid = rigid_mesh(mh, mw, device=lo.device)
        norm_rigid = mesh_points(normalize_mesh(rigid, mh, mw))
        src = mesh_points(normalize_mesh(mesh.to(lo.device), mh, mw))
        return tps_warp_with_mask((lo + 1.0) * 127.5, src,
                                  norm_rigid[None].expand(src.shape),
                                  (mh, mw), mode="NORMAL")

    # chunk by chunk, each on the device that holds its model input
    ps, ss, s = [], [], 0
    for a, b in zip(l1, l2):
        e = s + a.shape[0]
        w1, k1 = warp(a, smooth["smooth_mesh1"][s:e])
        w2, k2 = warp(b, smooth["smooth_mesh2"][s:e])
        ov = (k1 * k2)[..., None]
        ps.append(batched_psnr(w1 * ov, w2 * ov).to(scores.device))
        ss.append(batched_ssim(w1 * ov, w2 * ov).to(scores.device))
        s = e
    return torch.cat(ps), torch.cat(ss), scores, staging


def _collect_video(handle) -> Dict[str, float]:
    """Fetch one submitted video's scores: the mean PSNR and SSIM over its
    frames, stability and distortion after smoothing and before (_ori)."""
    ps, ss, scores, _ = handle
    T = ps.shape[0]
    host = torch.cat([ps, ss, scores]).cpu().numpy()       # one fetch
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
