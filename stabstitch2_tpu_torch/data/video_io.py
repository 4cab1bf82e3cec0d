"""Host-side video IO (own copy of the JAX package's ``data/video_io.py``).

A video is a directory with ``video1/*.jpg`` and ``video2/*.jpg``; frames
are used at native resolution (composite) and resized to the model input,
normalized to [-1, 1]. Decoding is cv2 only; output is mp4 from uint8 BGR.
"""

from __future__ import annotations

import glob
import os
from typing import List, Tuple

import cv2
import numpy as np

from stabstitch2_tpu_torch.config import MODEL_H, MODEL_W


def list_videos(dataset_dir: str) -> List[str]:
    """Sorted video directories under a dataset split directory."""
    return sorted(p for p in glob.glob(os.path.join(dataset_dir, "*"))
                  if os.path.isdir(p))


def list_frames(video_dir: str, view: str) -> List[str]:
    return sorted(glob.glob(os.path.join(video_dir, view, "*.jpg")))


def load_view(video_dir: str, view: str,
              model_size: Tuple[int, int] = (MODEL_H, MODEL_W)
              ) -> Tuple[np.ndarray, np.ndarray]:
    """(hires uint8 [T, H, W, 3], model-size float32 [T, mh, mw, 3] in [-1, 1])."""
    paths = list_frames(video_dir, view)
    if not paths:
        raise FileNotFoundError(f"no frames in {video_dir}/{view}")
    mh, mw = model_size
    hi, lo = [], []
    for p in paths:
        img = cv2.imread(p)
        if img is None:
            raise IOError(f"failed to read {p}")
        hi.append(img)
        lo.append(cv2.resize(img, (mw, mh)).astype(np.float32) / 127.5 - 1.0)
    return np.stack(hi), np.stack(lo)


def load_video_pair(video_dir: str,
                    model_size: Tuple[int, int] = (MODEL_H, MODEL_W)):
    """Both views of a two-view video directory, cut to the shorter one."""
    hi1, lo1 = load_view(video_dir, "video1", model_size)
    hi2, lo2 = load_view(video_dir, "video2", model_size)
    T = min(len(lo1), len(lo2))
    return hi1[:T], lo1[:T], hi2[:T], lo2[:T]


def write_video(path: str, frames: np.ndarray, fps: int = 30) -> None:
    """Encode uint8 BGR frames [T, H, W, 3] as mp4 (fourcc mp4v)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    T, H, W, _ = frames.shape
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (W, H))
    if not writer.isOpened():
        raise IOError(f"cv2.VideoWriter could not open {path!r} "
                      f"(mp4v {W}x{H}; does the path end in .mp4?)")
    try:
        for t in range(T):
            writer.write(np.clip(frames[t], 0, 255).astype(np.uint8))
    finally:
        writer.release()
