"""End-to-end two-view stitching (port of ``pipeline/stitcher.py``).

Phases: upload -> spatial motion -> temporal motion -> transport +
sliding-window smoothing -> composite. The model input is the frames
themselves when they are already at model size, or the model-size frames
that ``data/video_io.load_video_pair`` returns; the on-device resize and
the I420 upload paths of the JAX package are not ported yet.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from stabstitch2_tpu_torch.config import MODEL_H, MODEL_W, StitchConfig
from stabstitch2_tpu_torch.models import SmoothNet, SpatialNet, TemporalNet
from stabstitch2_tpu_torch.models.backbone import init_weights
from stabstitch2_tpu_torch.pipeline.compositor import Canvas, composite_video
from stabstitch2_tpu_torch.pipeline.motion import MotionEstimator
from stabstitch2_tpu_torch.pipeline.smoothing import smooth_all_windows
from stabstitch2_tpu_torch.pipeline.transport import (
    stitched_meshes,
    transport_both_views,
)


@dataclasses.dataclass
class StitchResult:
    frames: np.ndarray            # [T, out_h, out_w, 3] uint8 BGR
    canvas: Canvas
    smooth_mesh1: torch.Tensor    # [T, GH+1, GW+1, 2] model-resolution meshes
    smooth_mesh2: torch.Tensor
    ori_mesh1: torch.Tensor
    ori_mesh2: torch.Tensor
    ms: Dict[str, float] = dataclasses.field(default_factory=dict)
    fps: Dict[str, float] = dataclasses.field(default_factory=dict)


def resolve_device(device) -> torch.device:
    """The device to run on; a CUDA device must exist, there is no fallback."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is "
                           "available (pass device='cpu' to run on the CPU)")
    return device


@dataclasses.dataclass
class VideoStitcher:
    """The model triad on one device and the pipeline around it."""

    spatial_net: SpatialNet
    temporal_net: TemporalNet
    smooth_net: SmoothNet
    config: StitchConfig = dataclasses.field(default_factory=StitchConfig)
    chunk: int = 8
    model_h: int = MODEL_H
    model_w: int = MODEL_W
    device: torch.device = torch.device("cuda")

    def __post_init__(self):
        self.device = resolve_device(self.device)
        for net in (self.spatial_net, self.temporal_net, self.smooth_net):
            net.to(self.device).eval()
        self._motion = MotionEstimator(self.spatial_net, self.temporal_net,
                                       chunk=self.chunk)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _model_input(self, hi: torch.Tensor, lo) -> torch.Tensor:
        if lo is not None:
            return torch.as_tensor(np.asarray(lo, np.float32)).to(self.device)
        if tuple(hi.shape[1:3]) != (self.model_h, self.model_w):
            raise NotImplementedError(
                f"frames are {tuple(hi.shape[1:3])}, the model input "
                f"{(self.model_h, self.model_w)}: pass the model-size frames "
                "(lo) as load_video_pair returns them; the on-device resize "
                "is not ported yet")
        return hi.to(torch.float32) / 127.5 - 1.0

    @torch.no_grad()
    def stitch_arrays(self, hi1: np.ndarray, lo1: Optional[np.ndarray],
                      hi2: np.ndarray, lo2: Optional[np.ndarray]
                      ) -> StitchResult:
        """hi*: [T, H, W, 3] uint8 BGR; lo*: [T, mh, mw, 3] float32 in [-1, 1],
        or None when hi is already at model size."""
        T = hi1.shape[0]
        window = self.config.window
        if T < window:
            raise ValueError(f"video too short: {T} < window {window}")
        ms: Dict[str, float] = {}
        t0 = t = time.perf_counter()

        def mark(name):
            nonlocal t
            self._sync()
            now = time.perf_counter()
            ms[name] = (now - t) * 1e3
            t = now

        h1 = torch.from_numpy(np.ascontiguousarray(hi1, np.uint8)).to(self.device)
        h2 = torch.from_numpy(np.ascontiguousarray(hi2, np.uint8)).to(self.device)
        l1, l2 = self._model_input(h1, lo1), self._model_input(h2, lo2)
        mark("upload")
        smotion1, smotion2 = self._motion.spatial(l1, l2)
        mark("spatial")
        tmotion1, tmotion2 = self._motion.temporal_pair(l1, l2)
        mark("temporal")
        mh, mw = self.model_h, self.model_w
        ts1, ts2 = transport_both_views(tmotion1, smotion1, tmotion2, smotion2,
                                        mh, mw)
        smooth = smooth_all_windows(self.smooth_net,
                                    stitched_meshes(smotion1, mh, mw),
                                    stitched_meshes(smotion2, mh, mw),
                                    ts1, ts2, window=window)
        mark("smooth")
        frames, canvas = composite_video(h1, h2, smooth["smooth_mesh1"],
                                         smooth["smooth_mesh2"],
                                         config=self.config, chunk=self.chunk,
                                         model_size=(mh, mw))
        mark("composite")
        total = time.perf_counter() - t0
        return StitchResult(frames=frames, canvas=canvas,
                            smooth_mesh1=smooth["smooth_mesh1"],
                            smooth_mesh2=smooth["smooth_mesh2"],
                            ori_mesh1=smooth["ori_mesh1"],
                            ori_mesh2=smooth["ori_mesh2"], ms=ms,
                            fps={"total": T / max(total, 1e-9)})

    def stitch_video_dir(self, video_dir: str,
                         output_path: Optional[str] = None) -> StitchResult:
        """Stitch one <video>/video1 + video2 directory; optionally write mp4."""
        from stabstitch2_tpu_torch.data.video_io import (load_video_pair,
                                                         write_video)

        hi1, lo1, hi2, lo2 = load_video_pair(
            video_dir, model_size=(self.model_h, self.model_w))
        result = self.stitch_arrays(hi1, lo1, hi2, lo2)
        if output_path:
            t0 = time.perf_counter()
            write_video(output_path, result.frames)
            result.fps["encode"] = len(result.frames) / max(
                time.perf_counter() - t0, 1e-9)
        return result


def init_stitcher(rng_seed: int = 0, config: Optional[StitchConfig] = None,
                  model_h: int = MODEL_H, model_w: int = MODEL_W,
                  chunk: int = 8, device="cuda") -> VideoStitcher:
    """A stitcher with random float32 weights drawn from ``rng_seed``.

    The weights are drawn on the CPU from one ``torch.Generator``, so every
    device gets the same values. Raises if ``device`` is 'cuda' and no card
    is present.
    """
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(rng_seed)
    nets = (SpatialNet(model_h, model_w), TemporalNet(model_h, model_w),
            SmoothNet())
    for net in nets:
        init_weights(net, gen)
    return VideoStitcher(*nets, config=config or StitchConfig(), chunk=chunk,
                         model_h=model_h, model_w=model_w, device=device)
