"""Motion export between the stages (port of ``train/export.py``).

Runs a stitcher's spatial and temporal nets over the training split (on
each of its devices, their chunks) and writes per-frame ``.npy`` motions
beside the frames, which the smooth trainer reads:
``SpatialMotion1/2/NNNNNN.npy`` (mesh - rigid mesh, [GH+1, GW+1, 2]) and
``TemporalMotion1/2/NNNNNN.npy`` (zero for each video's first frame).
Both views are cut to their common length, so every stream is
frame-aligned.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from stabstitch2_tpu_torch.data.video_io import list_videos, load_video_pair


def _write(video_dir: str, name: str, motions: torch.Tensor) -> None:
    d = os.path.join(video_dir, name)
    os.makedirs(d, exist_ok=True)
    for t, m in enumerate(motions.cpu().numpy()):
        np.save(os.path.join(d, f"{t:06d}.npy"), m)


def _model_inputs(stitcher, video_dir: str):
    """Both views at the model size, [-1, 1], cut to the shorter, as chunk
    lists on the stitcher's devices (``VideoStitcher.model_inputs``), and
    the staging buffers to hold while they are read."""
    _, lo1, _, lo2 = load_video_pair(
        video_dir, (stitcher.model_h, stitcher.model_w), want_hi=False)
    staging = []
    return (stitcher.model_inputs(lo1, staging),
            stitcher.model_inputs(lo2, staging), staging)


def export_spatial_motions(stitcher, dataset_dir: str) -> int:
    """Write SpatialMotion1/2 for every frame of every video; returns the
    number of frames."""
    count = 0
    for vd in list_videos(dataset_dir):
        lo1, lo2, _ = _model_inputs(stitcher, vd)
        m1, m2 = stitcher._motion.spatial(lo1, lo2)
        _write(vd, "SpatialMotion1", m1)
        _write(vd, "SpatialMotion2", m2)
        count += len(m1)
    return count


def export_temporal_motions(stitcher, dataset_dir: str) -> int:
    """Write TemporalMotion1/2 (zero motion for frame 0); returns the
    number of motions written over both views."""
    count = 0
    for vd in list_videos(dataset_dir):
        lo1, lo2, _ = _model_inputs(stitcher, vd)
        m1, m2 = stitcher._motion.temporal_pair(lo1, lo2)
        _write(vd, "TemporalMotion1", m1)
        _write(vd, "TemporalMotion2", m2)
        count += len(m1) + len(m2)
    return count
