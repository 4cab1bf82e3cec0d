"""End-to-end two-view stitching (port of ``pipeline/stitcher.py``).

Phases: upload -> spatial motion -> temporal motion -> transport +
sliding-window smoothing -> composite. The model input is either given
(``lo``) or made on the device from the frames by :func:`model_input`
(antialiased bilinear resize, as ``jax.image.resize``), as in the JAX
package; its I420 upload path is not ported yet.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

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
    frames: np.ndarray            # uint8 BGR [T, out_h, out_w, 3], or
    canvas: Canvas                # packed I420 [T, out_h*3//2, out_w]
    smooth_mesh1: torch.Tensor    # [T, GH+1, GW+1, 2] model-resolution meshes
    smooth_mesh2: torch.Tensor
    ori_mesh1: torch.Tensor
    ori_mesh2: torch.Tensor
    ms: Dict[str, float] = dataclasses.field(default_factory=dict)
    fps: Dict[str, float] = dataclasses.field(default_factory=dict)
    frame_format: str = "bgr"     # 'bgr' or 'i420' (download_format yuv420)


def model_input(hi: torch.Tensor, mh: int, mw: int) -> torch.Tensor:
    """Frames [T, H, W, 3] (0..255) -> the model input [T, mh, mw, 3] in
    [-1, 1]: float32, resized unless already at model size, normalized.

    The resize is bilinear with half-pixel centres and, when it shrinks, a
    widened triangle filter (``antialias=True``): the function of the JAX
    package's ``jax.image.resize(x, shape, "bilinear")``.
    """
    x = hi.to(torch.float32)
    if tuple(x.shape[1:3]) != (mh, mw):
        x = F.interpolate(x.permute(0, 3, 1, 2), size=(mh, mw),
                          mode="bilinear", align_corners=False,
                          antialias=True).permute(0, 2, 3, 1).contiguous()
    return x / 127.5 - 1.0


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

    @torch.no_grad()
    def stitch_arrays(self, hi1: np.ndarray, lo1: Optional[np.ndarray],
                      hi2: np.ndarray, lo2: Optional[np.ndarray]
                      ) -> StitchResult:
        """hi*: [T, H, W, 3] BGR; lo*: [T, mh, mw, 3] float32 in [-1, 1],
        or None to make the model input from hi on the device
        (:func:`model_input`), which is what the CLI does.

        As in the JAX package: without both lo, hi is uploaded as uint8;
        with both, hi keeps its dtype, so float 0..255 frames take the
        float composite route.
        """
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

        given = lo1 is not None and lo2 is not None

        def upload(hi):
            # uint8 unless both lo are given; then float frames stay float
            # (float32: the JAX package's arrays are float32 at most)
            keep = given and hi.dtype != np.uint8
            return torch.from_numpy(np.ascontiguousarray(
                hi, np.float32 if keep else np.uint8)).to(self.device)

        h1, h2 = upload(hi1), upload(hi2)
        if given:
            l1, l2 = (torch.from_numpy(np.ascontiguousarray(lo, np.float32))
                      .to(self.device) for lo in (lo1, lo2))
        else:
            l1, l2 = (model_input(h, self.model_h, self.model_w)
                      for h in (h1, h2))
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
                            fps={"total": T / max(total, 1e-9)},
                            frame_format=("i420" if self.config.download_format
                                          == "yuv420" else "bgr"))

    def stitch_video_dir(self, video_dir: str,
                         output_path: Optional[str] = None) -> StitchResult:
        """Stitch one <video>/video1 + video2 directory; optionally write mp4."""
        from stabstitch2_tpu_torch.data.video_io import (load_video_pair,
                                                         write_video)

        # the model input is made on the device, as the JAX CLI does
        hi1, _, hi2, _ = load_video_pair(
            video_dir, model_size=(self.model_h, self.model_w))
        result = self.stitch_arrays(hi1, None, hi2, None)
        if output_path:
            t0 = time.perf_counter()
            write_video(output_path, result.frames,
                        frame_format=result.frame_format)
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
