"""Training samplers of the three stages (port of ``data/datasets.py``).

- :class:`SpatialPairDataset`: cross-view frame pairs per video, the first
  2 frames skipped in training, a random view swap with p = 0.5.
- :class:`TemporalPairDataset`: view 2 only; sliding windows of
  ``train_frame_num`` (4) frames, each sample two sorted random frames of
  its window (a random temporal gap).
- :class:`SmoothWindowDataset`: six aligned streams (TemporalMotion1/2,
  SpatialMotion1/2 npy, video1/2 jpg), windows of 12, each sample
  ``selected_frames`` sorted random picks; videos shorter than 12 are
  skipped.

Frames are decoded with cv2 per sample, and a spatial batch in one
native decode (:func:`_decode_many`, cv2 where the loader is
unavailable), resized to the model input and yielded as uint8 (the
trainers normalize on the device). Every random draw is the JAX
package's, from ``np.random.default_rng(seed)`` in the same order, so
the batches, swaps and picks equal its on the same tree and decoder.
:func:`batch_iterator` stacks items on a thread that stops when the
consumer abandons it.
"""

from __future__ import annotations

import glob
import os
import queue
import threading
from typing import Iterator, List, Optional, Tuple

import numpy as np

from stabstitch2_tpu_torch.config import MODEL_H, MODEL_W
from stabstitch2_tpu_torch.utils.profiling import annotate


def _load_image(path: str, width: int = MODEL_W,
                height: int = MODEL_H) -> np.ndarray:
    """One uint8 HWC frame at the model size."""
    import cv2

    img = cv2.imread(path)
    if img is None:
        raise IOError(f"failed to read {path}")
    return cv2.resize(img, (width, height))


def _decode_many(paths: List[str], mh: int, mw: int) -> np.ndarray:
    """Frames at the model size, uint8 [N, mh, mw, 3]: one native decode
    on two threads (``data/native.py``), or cv2 frame by frame where the
    loader is unavailable or fails."""
    from stabstitch2_tpu_torch.data import native

    if native.available():
        try:
            return native.decode_batch(paths, lo_size=(mh, mw),
                                       want_hi=False, threads=2)[1]
        except (IOError, RuntimeError):
            pass
    return np.stack([_load_image(p, mw, mh) for p in paths])


def _video_dirs(root: str) -> List[str]:
    return sorted(p for p in glob.glob(os.path.join(root, "*"))
                  if os.path.isdir(p))


class SpatialPairDataset:
    """Cross-view frame pairs for SpatialWarp training."""

    def __init__(self, data_path: str, training: bool = True,
                 seed: int = 0, model_size=(MODEL_H, MODEL_W)):
        self.training = training
        self.model_size = model_size
        self.rng = np.random.default_rng(seed)
        self.samples: List[Tuple[str, str]] = []
        skip = 2 if training else 0
        for vd in _video_dirs(data_path):
            f1 = sorted(glob.glob(os.path.join(vd, "video1", "*.jpg")))[skip:]
            f2 = sorted(glob.glob(os.path.join(vd, "video2", "*.jpg")))[skip:]
            self.samples += list(zip(f1, f2))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        p1, p2 = self.samples[i]
        mh, mw = self.model_size
        a, b = _load_image(p1, mw, mh), _load_image(p2, mw, mh)
        if self.training and self.rng.random() < 0.5:
            a, b = b, a
        return a, b

    def get_batch(self, indices) -> Tuple[np.ndarray, np.ndarray]:
        """A batch: one decode of its 2B frames (:func:`_decode_many`) and
        one draw of the swaps for all its pairs (what
        :func:`batch_iterator` calls, as the JAX package's does)."""
        mh, mw = self.model_size
        pairs = [self.samples[int(i)] for i in indices]
        imgs = _decode_many([p for pair in pairs for p in pair], mh, mw)
        a, b = imgs[0::2], imgs[1::2]
        if self.training:
            swap = (self.rng.random(len(pairs)) < 0.5)[:, None, None, None]
            return np.where(swap, b, a), np.where(swap, a, b)
        return a, b


class TemporalPairDataset:
    """Random-gap pairs from view 2 for TemporalWarp training."""

    def __init__(self, data_path: str, train_frame_num: int = 4,
                 seed: int = 0, model_size=(MODEL_H, MODEL_W)):
        self.rng = np.random.default_rng(seed)
        self.model_size = model_size
        self.train_frame_num = train_frame_num
        self.windows: List[List[str]] = []
        for vd in _video_dirs(data_path):
            frames = sorted(glob.glob(os.path.join(vd, "video2", "*.jpg")))
            for s in range(len(frames) - train_frame_num + 1):
                self.windows.append(frames[s:s + train_frame_num])

    def __len__(self):
        return len(self.windows)

    def __getitem__(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        w = self.windows[i]
        a, b = sorted(self.rng.choice(len(w), size=2, replace=False))
        mh, mw = self.model_size
        return _load_image(w[a], mw, mh), _load_image(w[b], mw, mh)


MOTION_STREAMS = {"tm1": "TemporalMotion1", "tm2": "TemporalMotion2",
                  "sm1": "SpatialMotion1", "sm2": "SpatialMotion2"}


class SmoothWindowDataset:
    """Aligned motion + frame windows for SmoothWarp training.

    Each item: (tmotion1, tmotion2, smotion1, smotion2, img1, img2), each
    [L, ...] with L = ``selected_frames`` sorted random picks from a
    ``train_frame_num``-frame window.
    """

    def __init__(self, data_path: str, selected_frames: int = 8,
                 train_frame_num: int = 12, seed: int = 0,
                 model_size=(MODEL_H, MODEL_W)):
        self.rng = np.random.default_rng(seed)
        self.model_size = model_size
        self.selected = selected_frames
        self.train_frame_num = train_frame_num
        self.windows = []
        for vd in _video_dirs(data_path):
            streams = {k: sorted(glob.glob(os.path.join(vd, d, "*.npy")))
                       for k, d in MOTION_STREAMS.items()}
            streams["img1"] = sorted(glob.glob(os.path.join(vd, "video1",
                                                            "*.jpg")))
            streams["img2"] = sorted(glob.glob(os.path.join(vd, "video2",
                                                            "*.jpg")))
            empty = [k for k in MOTION_STREAMS if not streams[k]]
            if empty and len(empty) < len(MOTION_STREAMS):
                # a partial export: fail rather than skip every video
                raise FileNotFoundError(
                    f"{vd}: missing streams {empty}; run `cli "
                    f"export-motions` to write the motion exports")
            if not empty:
                no_imgs = [k for k in ("img1", "img2") if not streams[k]]
                if no_imgs:
                    raise FileNotFoundError(
                        f"{vd}: motion exports exist but image stream(s) "
                        f"{no_imgs} are empty")
            # windows fit the shortest stream (views may differ in length)
            n = min(len(v) for v in streams.values())
            if n < train_frame_num:
                continue
            streams = {k: v[:n] for k, v in streams.items()}
            for s in range(n - train_frame_num + 1):
                self.windows.append({k: v[s:s + train_frame_num]
                                     for k, v in streams.items()})

    def __len__(self):
        return len(self.windows)

    def __getitem__(self, i: int):
        w = self.windows[i]
        idx = np.sort(self.rng.choice(self.train_frame_num,
                                      size=self.selected, replace=False))

        def motions(key):
            return np.stack([np.load(w[key][j]).astype(np.float32)
                             for j in idx])

        mh, mw = self.model_size
        im1 = np.stack([_load_image(w["img1"][j], mw, mh) for j in idx])
        im2 = np.stack([_load_image(w["img2"][j], mw, mh) for j in idx])
        return (motions("tm1"), motions("tm2"), motions("sm1"),
                motions("sm2"), im1, im2)


def batch_iterator(dataset, batch_size: int, seed: int = 0,
                   limit: Optional[int] = None) -> Iterator:
    """Numpy batches of ``dataset`` in an order shuffled from ``seed``, the
    last partial batch dropped, at most ``limit`` of them, stacked on a
    background thread two ahead. Closing the generator early stops the
    thread; a decode error is raised in the consumer.

    The datasets draw their random choices (pair gaps, view swaps, window
    frames) from one generator as items are made, so a thread that runs
    ahead of a capped epoch would draw for batches nobody takes, as many
    as the host's speed lets it, and the next epoch's samples would depend
    on that speed: ``limit`` (the loops pass their steps per epoch) keeps
    it to the batches the epoch takes. Under a profiler the consumer's
    wait for each batch is a ``loader_wait`` span
    (``utils/profiling.py``)."""
    order = np.arange(len(dataset))
    np.random.default_rng(seed).shuffle(order)
    stops = len(order) - len(order) % batch_size
    if limit is not None:
        stops = min(stops, limit * batch_size)
    get_batch = getattr(dataset, "get_batch", None)
    stop = threading.Event()
    q: queue.Queue = queue.Queue(maxsize=2)

    def put(item) -> bool:
        # a bounded put that notices the consumer's departure
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            for s in range(0, stops, batch_size):
                idx = order[s:s + batch_size]
                if get_batch is not None:
                    batch = get_batch(idx)
                else:
                    items = [dataset[int(i)] for i in idx]
                    batch = (tuple(np.stack(col) for col in zip(*items))
                             if isinstance(items[0], tuple)
                             else np.stack(items))
                if not put(batch):
                    return
        except Exception as e:  # noqa: BLE001 - raised in the consumer
            put(e)

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    try:
        for _ in range(0, stops, batch_size):
            with annotate("loader_wait"):
                item = q.get()
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        stop.set()
        t.join(timeout=5.0)
