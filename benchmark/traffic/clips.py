"""Synthetic multi-view shaky clips, made from a seed.

A wide panorama texture (smooth background, rectangles, discs, lines and
mild high-frequency detail: edges and corners for the cost volumes to
lock onto) is cut into ``views`` overlapping crops, each following its
own clipped random walk of camera shake: the structure of a StabStitch-D
sample (synchronized views, ~50% overlap, shake). The texture is the
one of the repository's test clips; the benchmark keeps its own copy, so
that no later change to the tests moves its traffic.
"""

from __future__ import annotations

from typing import List

import numpy as np


def texture(h: int, w: int, rng: np.random.Generator) -> np.ndarray:
    """A float32 scene-like texture [h, w, 3] in 0..255."""
    import cv2

    small = rng.uniform(40, 215, (h // 16, w // 16, 3)).astype(np.float32)
    tex = cv2.resize(small, (w, h), interpolation=cv2.INTER_CUBIC)
    for _ in range(24):
        x0, y0 = rng.integers(0, w - 20), rng.integers(0, h - 20)
        x1 = x0 + int(rng.integers(12, max(13, w // 4)))
        y1 = y0 + int(rng.integers(12, max(13, h // 4)))
        cv2.rectangle(tex, (int(x0), int(y0)), (int(x1), int(y1)),
                      rng.uniform(0, 255, 3).tolist(),
                      thickness=-1 if rng.random() < 0.6 else 2)
    for _ in range(14):
        c = (int(rng.integers(0, w)), int(rng.integers(0, h)))
        cv2.circle(tex, c, int(rng.integers(5, 25)),
                   rng.uniform(0, 255, 3).tolist(), -1)
    for _ in range(16):
        p0 = (int(rng.integers(0, w)), int(rng.integers(0, h)))
        p1 = (int(rng.integers(0, w)), int(rng.integers(0, h)))
        cv2.line(tex, p0, p1, rng.uniform(0, 255, 3).tolist(),
                 int(rng.integers(1, 4)))
    fine = rng.uniform(-20, 20, (h // 4, w // 4, 3)).astype(np.float32)
    tex = tex + cv2.resize(fine, (w, h), interpolation=cv2.INTER_CUBIC)
    return np.clip(tex, 0, 255)


def make_clip(views: int, frames: int, height: int, width: int,
              overlap: float, shake_px: float, seed: int
              ) -> List[np.ndarray]:
    """``views`` uint8 BGR clips [frames, height, width, 3], view k a crop
    ``k * width * (1 - overlap)`` to the right of view 0, each shaking by
    its own random walk (steps N(0, 0.6 shake), clipped to +-2 shake)."""
    rng = np.random.default_rng(seed)
    dx = int(width * (1.0 - overlap))
    margin = int(4 * shake_px) + 8
    pano = texture(height + 2 * margin, width + (views - 1) * dx + 2 * margin,
                   rng).astype(np.uint8)
    out = []
    for k in range(views):
        walk = np.clip(np.cumsum(rng.normal(0, shake_px * 0.6, (frames, 2)),
                                 axis=0), -shake_px * 2, shake_px * 2)
        o = (margin + walk).astype(int)
        out.append(np.stack([pano[o[t, 0]:o[t, 0] + height,
                                  o[t, 1] + k * dx:o[t, 1] + k * dx + width]
                             for t in range(frames)]))
    return out


def to_i420(frames: np.ndarray) -> np.ndarray:
    """uint8 BGR [T, H, W, 3] (even sizes) -> packed I420 [T, H*3//2, W]
    (OpenCV's BT.601 conversion, as a camera's 4:2:0 stream carries it)."""
    import cv2

    return np.stack([cv2.cvtColor(f, cv2.COLOR_BGR2YUV_I420) for f in frames])


def bounce(i: int, n: int) -> int:
    """Frame index of push ``i`` on a path of ``n`` frames played forward,
    then backward, then forward again: 0, 1, .., n-1, n-2, .., 1, 0, 1, .."""
    period = 2 * (n - 1)
    j = i % period
    return j if j < n else period - j


def write_pairs(root: str, videos: int, frames: int, height: int, width: int,
                overlap: float, shake_px: float, seed: int,
                quality: int) -> int:
    """A training tree of two-view clips under ``root``:
    ``<video>/video1/<frame>.jpg`` and ``<video>/video2/<frame>.jpg`` (the
    layout of the reference's training sets), each video a clip of
    :func:`make_clip` from its own stream of ``seed``, written as JPEG at
    ``quality``. Returns the bytes written."""
    import os

    import cv2

    from benchmark.lib.sampling import stream_seed

    written = 0
    for v in range(videos):
        for k, clip in enumerate(make_clip(2, frames, height, width, overlap,
                                           shake_px, stream_seed(seed, v))):
            d = os.path.join(root, f"{v:04d}", f"video{k + 1}")
            os.makedirs(d, exist_ok=True)
            for t, f in enumerate(clip):
                ok, buf = cv2.imencode(".jpg", f,
                                       [cv2.IMWRITE_JPEG_QUALITY, quality])
                if not ok:
                    raise IOError("JPEG encode failed")
                with open(os.path.join(d, f"{t:06d}.jpg"), "wb") as fh:
                    fh.write(buf.tobytes())
                written += buf.size
    return written
