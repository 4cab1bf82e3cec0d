"""Host-side video IO (own copy of the JAX package's ``data/video_io.py``).

A video is a directory with ``video1/*.jpg`` and ``video2/*.jpg``; frames
are used at native resolution (composite) and resized to the model input,
normalized to [-1, 1]. Decoding is native (``data/native.py``) with cv2
as the fallback; frames can be packed to I420 for the upload
(:func:`bgr_to_i420`); output is mp4 from uint8 BGR or from packed I420
(the yuv420 download). cv2 is imported by the functions that decode,
convert or encode, so the compositor can use :func:`pack_i420_host` where
cv2 is not installed.
"""

from __future__ import annotations

import collections
import glob
import os
from typing import List, Optional, Tuple

import numpy as np

from stabstitch2_tpu_torch.config import MODEL_H, MODEL_W


def list_videos(dataset_dir: str) -> List[str]:
    """Sorted video directories under a dataset split directory."""
    return sorted(p for p in glob.glob(os.path.join(dataset_dir, "*"))
                  if os.path.isdir(p))


def list_frames(video_dir: str, view: str) -> List[str]:
    return sorted(glob.glob(os.path.join(video_dir, view, "*.jpg")))


# the decoder that each load_view call ran: {"native": n, "cv2": n}
DECODED: collections.Counter = collections.Counter()


def load_view(video_dir: str, view: str,
              model_size: Optional[Tuple[int, int]] = (MODEL_H, MODEL_W),
              use_native: bool = True, want_hi: bool = True,
              normalize: bool = True
              ) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """(hires uint8 [T, H, W, 3], model-size float32 [T, mh, mw, 3] in
    [-1, 1]).

    Decodes with the native loader (``data/native.py``, libjpeg on a
    thread pool, built on first use) and falls back to cv2 where it is
    unavailable or fails (a frame that is no jpg, or of another size);
    both give BGR uint8 and a half-pixel bilinear resize, and may differ
    by a few levels (their IDCTs and the resize's rounding). Each call
    counts the decoder that ran in :data:`DECODED`. ``want_hi=False``
    gives None for the hires frames; ``normalize=False`` keeps the
    model-size frames uint8 (the metric harness normalizes them on the
    device); ``model_size=None`` skips the model-size frames (None), for
    callers that make the model input on the device.
    """
    paths = list_frames(video_dir, view)
    if not paths:
        raise FileNotFoundError(f"no frames in {video_dir}/{view}")
    if use_native:
        from stabstitch2_tpu_torch.data import native

        if native.available():
            try:
                hi, lo = native.decode_batch(paths, lo_size=model_size,
                                             want_hi=want_hi)
                DECODED["native"] += 1
                return hi, (lo.astype(np.float32) / 127.5 - 1.0
                            if normalize and lo is not None else lo)
            except (IOError, RuntimeError):
                pass        # not a jpg, or of another size: cv2 below
    import cv2

    hi, lo = [], []
    for p in paths:
        img = cv2.imread(p)
        if img is None:
            raise IOError(f"failed to read {p}")
        if want_hi:
            hi.append(img)
        if model_size is not None:
            small = cv2.resize(img, model_size[::-1])
            lo.append(small.astype(np.float32) / 127.5 - 1.0 if normalize
                      else small)
    DECODED["cv2"] += 1
    return (np.stack(hi) if want_hi else None), (
        np.stack(lo) if model_size is not None else None)


def load_video_pair(video_dir: str,
                    model_size: Optional[Tuple[int, int]] = (MODEL_H,
                                                             MODEL_W),
                    want_hi: bool = True, normalize: bool = True,
                    use_native: bool = True):
    """Both views of a two-view video directory, cut to the shorter one
    (the hires frames None without ``want_hi``, the model-size ones
    without ``model_size``)."""
    hi1, lo1 = load_view(video_dir, "video1", model_size, use_native,
                         want_hi, normalize)
    hi2, lo2 = load_view(video_dir, "video2", model_size, use_native,
                         want_hi, normalize)
    T = min(len(hi1 if lo1 is None else lo1), len(hi2 if lo2 is None else lo2))
    cut = lambda x: None if x is None else x[:T]  # noqa: E731
    return cut(hi1), cut(lo1), cut(hi2), cut(lo2)


def bgr_to_i420(frames: np.ndarray) -> np.ndarray:
    """uint8 BGR [T, H, W, 3] (H, W even) -> packed I420 [T, H*3//2, W].

    The host side of the 1.5-byte/px upload (cv2); the device unpacks with
    ``ops/yuv.py:unpack_i420_u8``. Raises ValueError on odd sizes, which
    I420 cannot hold; the caller then uploads BGR.
    """
    import cv2

    T, H, W, _ = frames.shape
    if H % 2 or W % 2:
        raise ValueError(f"I420 needs even dims, got {H}x{W}")
    return np.stack([cv2.cvtColor(frames[t], cv2.COLOR_BGR2YUV_I420)
                     for t in range(T)])


def pack_i420_host(y: np.ndarray, u: np.ndarray, v: np.ndarray
                   ) -> np.ndarray:
    """(Y [.., H, W], U, V [.., H/2, W/2]) -> packed I420 [.., H*3//2, W].

    The planes are contiguous, one after the other (cv2's I420 layout);
    batched ([T, H, W]) or single-frame ([H, W]).
    """
    y, u, v = np.asarray(y), np.asarray(u), np.asarray(v)
    lead = y.shape[:-2]
    H, W = y.shape[-2:]
    flat = np.concatenate([y.reshape(*lead, -1), u.reshape(*lead, -1),
                           v.reshape(*lead, -1)], axis=-1)
    return flat.reshape(*lead, H * 3 // 2, W)


def write_video(path: str, frames: np.ndarray, fps: int = 30,
                frame_format: str = "bgr") -> None:
    """Encode frames as mp4 (fourcc mp4v).

    frame_format 'bgr': uint8 BGR [T, H, W, 3]. 'i420': packed YUV 4:2:0
    [T, H*3//2, W] uint8, each frame expanded to BGR by cv2 right before
    the encoder (which converts back to 4:2:0).
    """
    import cv2

    if frame_format == "i420":
        T, H15, W = frames.shape
        H = H15 * 2 // 3
    elif frame_format == "bgr":
        T, H, W, _ = frames.shape
    else:
        raise ValueError(f"unknown frame_format {frame_format!r}")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (W, H))
    if not writer.isOpened():
        raise IOError(f"cv2.VideoWriter could not open {path!r} "
                      f"(mp4v {W}x{H}; does the path end in .mp4?)")
    try:
        for t in range(T):
            if frame_format == "i420":
                writer.write(cv2.cvtColor(frames[t], cv2.COLOR_YUV2BGR_I420))
            else:
                writer.write(np.clip(frames[t], 0, 255).astype(np.uint8))
    finally:
        writer.release()
