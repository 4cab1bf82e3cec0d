"""End-to-end two-view stitching (port of ``pipeline/stitcher.py``).

Phases: upload -> spatial motion -> temporal motion -> transport +
sliding-window smoothing -> composite. Frames go up as uint8 BGR or as
packed I420 (unpacked on the device, ``ops/yuv.py:unpack_i420_u8``). The
model input is either given (``lo``) or made on the device from the
frames by :func:`model_input` (antialiased bilinear resize, as
``jax.image.resize``), as in the JAX package.

``upload_mode`` 'bulk' copies each view in one piece; 'stream' (when the
model input is made on the device) copies chunk by chunk on a copy
stream of its own, one event per chunk, starting chunk k+1's copy after
chunk k's unpack, model input, spatial motion and temporal features,
which wait only for their own chunk's copy: later copies run beside
earlier chunks' kernels. Both run the motion nets on the same chunks
(``pipeline/motion.py``) and give the same bits.

``fused_motion`` (the default, as in the JAX package) runs phases 1-4 of
the bulk paths (``stitch_begin`` in bulk upload, :meth:`VideoStitcher.
motion_smooth`, which the N-view chain calls) as captured programs (``utils/graphs.py``): per motion chunk the spatial
motion with the temporal features, per pair chunk the temporal motion,
each at the one chunk shape, and transport with the smoothing of every
window as one program per 16-frame bucket, padded by repeating the last
frame and cropped (exact: frame t's smooth mesh depends on frames <= t
only). On a card each is a CUDA graph, captured at its first shape and
replayed; on the CPU the same functions run directly. ``fused_motion=
False`` (``cli --eager_motion``) runs them eagerly at the true sizes;
where T is a multiple of 16 and of the chunk the two give the same bits.
``upload_mode`` 'stream' keeps its eager per-chunk interleave either way.
The metric harness captures a larger program of its own
(``metrics/harness.py``) from :meth:`VideoStitcher.motions` and
:meth:`VideoStitcher.smooth_program`.

On several devices (``init_stitcher(n_devices=N)``, the JAX package's
data-parallel inference) one process deals the chunks round-robin: chunk
k of the upload, the motion nets and the composite runs on device k mod
N, which holds a replica of the motion nets; the motions are gathered on
the first device, which smooths them, and each composite chunk is
downloaded from its device into the one host result. Every chunk runs at
the shape and through the kernels it has on one device, so the frames
equal one device's bit for bit.

:meth:`VideoStitcher.stitch_begin` enqueues a whole video and returns
without waiting for the device except to fetch the meshes that size the
canvas; :meth:`VideoStitcher.stitch_finish` collects the frames. The
phase marks (``StitchResult.ms``) are CUDA events on a card with
``sync_phases`` and take no wait; under a profiler the two calls are the
``stitch_begin`` and ``stitch_finish`` spans (``utils/profiling.py``).
Uploads are staged in page-locked memory and copied with
``non_blocking=True``; the staging buffers live in the pending state until
the video is finished.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from stabstitch2_tpu_torch.config import MODEL_H, MODEL_W, StitchConfig
from stabstitch2_tpu_torch.models import SmoothNet, SpatialNet, TemporalNet
from stabstitch2_tpu_torch.models.backbone import init_weights
from stabstitch2_tpu_torch.ops.yuv import unpack_i420_u8
from stabstitch2_tpu_torch.pipeline.compositor import (Canvas,
                                                       PendingComposite,
                                                       composite_begin,
                                                       composite_finish)
from stabstitch2_tpu_torch.parallel.devices import (resolve_device,
                                                    resolve_devices)
from stabstitch2_tpu_torch.pipeline.motion import (Frames, MotionEstimator,
                                                   pad_to)
from stabstitch2_tpu_torch.pipeline.smoothing import smooth_all_windows
from stabstitch2_tpu_torch.pipeline.transport import (
    stitched_meshes,
    transport_both_views,
)
from stabstitch2_tpu_torch.utils.graphs import GraphCache
from stabstitch2_tpu_torch.utils.profiling import PhaseTimer, annotate
from stabstitch2_tpu_torch.utils.transfer import pinned


# the frame bucket of the captured smoothing program, as the JAX package's
SMOOTH_BUCKET = 16


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


@dataclasses.dataclass
class _PendingStitch:
    """A video in flight: composite enqueued, copies draining."""

    composite: PendingComposite
    smooth: Dict[str, torch.Tensor]
    timer: PhaseTimer
    T: int
    staging: List[torch.Tensor]   # upload buffers, held until finished


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


@dataclasses.dataclass
class VideoStitcher:
    """The model triad and the pipeline around it, on one device or dealt
    over several (``devices``)."""

    spatial_net: SpatialNet
    temporal_net: TemporalNet
    smooth_net: SmoothNet
    config: StitchConfig = dataclasses.field(default_factory=StitchConfig)
    chunk: int = 8
    model_h: int = MODEL_H
    model_w: int = MODEL_W
    device: torch.device = torch.device("cuda")
    # True: StitchResult.ms reads the card's time of each phase (CUDA
    # events, reference-style attribution, no wait). False: the host's
    # clock at each mark (the phase times become enqueue times).
    sync_phases: bool = True
    # 'bulk': one upload per view (and device). 'stream': per-chunk
    # uploads on a copy stream, each chunk's motion work started as its
    # copy lands (only where the model input is made on the device; see
    # the module docstring). Phase ms in stream mode: 'upload' is ~0,
    # 'spatial' holds the staging, the copies and the temporal features,
    # 'temporal' the temporal motion alone.
    upload_mode: str = "bulk"
    # the devices the chunks are dealt over, chunk k to devices[k mod N]
    # (``init_stitcher(n_devices=N)``); None: ``device`` alone. The nets
    # above live on the first; the others hold copies of the motion nets.
    devices: Optional[List[torch.device]] = None
    # True: phases 1-4 of the bulk paths as captured programs, one CUDA
    # graph per program and shape on a card (``graphs``). False: eager.
    fused_motion: bool = True

    def __post_init__(self):
        if self.devices:
            self.devices = [resolve_device(d) for d in self.devices]
            self.device = self.devices[0]
        else:
            self.device = resolve_device(self.device)
            self.devices = [self.device]
        self._copy_streams: Dict[torch.device, torch.cuda.Stream] = {}
        for net in (self.spatial_net, self.temporal_net, self.smooth_net):
            net.to(self.device).eval()
        self.replicate()

    def replicate(self) -> None:
        """Give each device its replica of the motion nets as they are now:
        the nets themselves on the first device, copies on the others.
        With several devices, call it again after loading weights into the
        nets (``utils/checkpoint.py:stitcher_from_checkpoint`` does). The
        captured programs (``graphs``) are dropped with the old copies."""
        nets = (self.spatial_net, self.temporal_net)
        self._motion = MotionEstimator(
            [nets] + [tuple(copy.deepcopy(net).to(d).eval() for net in nets)
                      for d in self.devices[1:]], chunk=self.chunk)
        self.graphs = GraphCache()

    def stitch_arrays(self, hi1: np.ndarray, lo1: Optional[np.ndarray],
                      hi2: np.ndarray, lo2: Optional[np.ndarray]
                      ) -> StitchResult:
        """One video, begun and finished: see :meth:`stitch_begin`."""
        return self.stitch_finish(self.stitch_begin(hi1, lo1, hi2, lo2))

    @torch.no_grad()
    def stitch_begin(self, hi1: np.ndarray, lo1: Optional[np.ndarray],
                     hi2: np.ndarray, lo2: Optional[np.ndarray]
                     ) -> _PendingStitch:
        """Enqueue one video's whole pipeline; return its pending state.

        hi*: [T, H, W, 3] BGR, or packed I420 [T, H*3//2, W] uint8 (1.5
        bytes per pixel, ``data/video_io.py:bgr_to_i420``), unpacked on
        the device; lo*: [T, mh, mw, 3] float32 in [-1, 1], or None to
        make the model input from hi on the device (:func:`model_input`),
        which is what the CLI does.

        As in the JAX package: without both lo, hi is uploaded as uint8
        (in ``upload_mode`` 'stream' it keeps its dtype, as there); with
        both, hi keeps its dtype, so float 0..255 frames take the float
        composite route. Call :meth:`stitch_finish` to collect the
        frames; a caller may begin the next video first.

        With several devices each chunk is staged to the device that
        runs it; the motions are gathered on the first device, which
        smooths them, and the composite chunks are dealt as the motion
        chunks were. The host still waits once (the canvas fetch).
        """
        with annotate("stitch_begin"):
            return self._begin(hi1, lo1, hi2, lo2)

    def _begin(self, hi1, lo1, hi2, lo2) -> _PendingStitch:
        if self.upload_mode not in ("bulk", "stream"):
            raise ValueError(f"upload_mode {self.upload_mode!r}: 'bulk' or "
                             "'stream'")
        T = hi1.shape[0]
        window = self.config.window
        if T < window:
            raise ValueError(f"video too short: {T} < window {window}")
        timer = PhaseTimer(T, self.devices if self.sync_phases else None)
        given = lo1 is not None and lo2 is not None
        staging: List[torch.Tensor] = []
        mh, mw = self.model_h, self.model_w
        if not given and self.upload_mode == "stream":
            h1, h2, smooth = self._stream_motion_smooth(hi1, hi2, staging,
                                                        timer)
            return self._composite_begin(h1, h2, smooth, timer, T, staging)
        with annotate("upload"):
            # uint8 unless both lo are given; then float frames stay float
            h1, h2 = (self.upload_parts(h, staging, keep_float=given
                                        and h.dtype != np.uint8)
                      for h in (hi1, hi2))
            if given:
                l1 = self.deal(lo1, np.float32, staging)
                l2 = self.deal(lo2, np.float32, staging)
            else:
                l1 = [model_input(p, mh, mw) for p in h1]
                l2 = [model_input(p, mh, mw) for p in h2]
        timer.mark("upload")
        smooth = self.motion_smooth(self.chunked(l1, T), self.chunked(l2, T),
                                    timer)
        return self._composite_begin(self.chunked(h1, T),
                                     self.chunked(h2, T), smooth, timer, T,
                                     staging)

    def _composite_begin(self, h1, h2, smooth, timer, T, staging
                         ) -> _PendingStitch:
        with annotate("composite"):
            state = composite_begin(h1, h2, smooth["smooth_mesh1"],
                                    smooth["smooth_mesh2"],
                                    config=self.config, chunk=self.chunk,
                                    model_size=(self.model_h, self.model_w))
        return _PendingStitch(composite=state, smooth=smooth, timer=timer,
                              T=T, staging=staging)

    def _copy_stream(self, device: torch.device) -> torch.cuda.Stream:
        if device not in self._copy_streams:
            self._copy_streams[device] = torch.cuda.Stream(device)
        return self._copy_streams[device]

    def upload_chunks(self, views, staging: List[torch.Tensor]
                      ) -> Iterator[List[torch.Tensor]]:
        """Yield each chunk of the ``views`` (frames [T, ...], BGR or packed
        I420; uint8 stays uint8, any other dtype goes as float32, as the
        JAX package's stream upload keeps it) on the device that runs it,
        one list per chunk.

        A chunk is copied only when the caller asks for the next one, so
        its copy starts after the caller has enqueued the previous
        chunk's work, and on a card runs beside those kernels: the chunk
        is staged in page-locked memory (appended to ``staging``), copied
        on its device's copy stream, and that device's current stream
        waits for the copy's event before it reads the chunk (allocated
        on the copy stream, recorded on the current one).
        """
        motion = self._motion
        for k, (s, e) in enumerate(motion.chunks(views[0].shape[0])):
            device = self.devices[motion.owner(k)]
            hosts = [pinned(np.ascontiguousarray(
                v[s:e], np.uint8 if v.dtype == np.uint8 else np.float32),
                device) for v in views]
            staging.extend(hosts)
            if device.type != "cuda":
                yield hosts
                continue
            copy_stream = self._copy_stream(device)
            compute = torch.cuda.current_stream(device)
            with torch.cuda.stream(copy_stream):
                devs = [h.to(device, non_blocking=True) for h in hosts]
            landed = torch.cuda.Event()
            landed.record(copy_stream)
            compute.wait_event(landed)
            for d in devs:
                d.record_stream(compute)
            yield devs

    def _stream_motion_smooth(self, hi1, hi2, staging, timer):
        """``upload_mode`` 'stream': chunk by chunk, both views' copies
        (:meth:`upload_chunks`), then the chunk's I420 unpack, model
        input, spatial motion and temporal features on its device; then
        the temporal motion from the features, and smoothing as in bulk.
        Returns (frames1, frames2, the smoothing dict), the frames as
        chunk lists."""
        mh, mw = self.model_h, self.model_w
        motion = self._motion
        timer.mark("upload")    # the copies run inside 'spatial'
        frames1, frames2, sm1, sm2, f1, f2 = [], [], [], [], [], []
        with annotate("spatial"):
            for k, (a, b) in enumerate(self.upload_chunks((hi1, hi2),
                                                          staging)):
                a = unpack_i420_u8(a) if a.dim() == 3 else a
                b = unpack_i420_u8(b) if b.dim() == 3 else b
                frames1.append(a)
                frames2.append(b)
                l1, l2 = model_input(a, mh, mw), model_input(b, mh, mw)
                m1, m2, g1, g2 = motion.motion_chunk(l1, l2, k)
                sm1.append(m1)
                sm2.append(m2)
                f1.append(g1)
                f2.append(g2)
        timer.mark("spatial")
        with annotate("temporal"):
            tmotion = motion.temporal_from_features(f1, f2)
        timer.mark("temporal")
        smooth = self._smooth(motion.gather(sm1), motion.gather(sm2),
                              *tmotion, timer, None)
        return frames1, frames2, smooth

    def upload(self, x: np.ndarray, dtype, staging: List[torch.Tensor],
               device: Optional[torch.device] = None) -> torch.Tensor:
        """``x`` as ``dtype`` on ``device`` (default: the first), copied
        without blocking from a page-locked buffer appended to ``staging``
        (hold it until the video is finished)."""
        device = device or self.device
        host = pinned(np.ascontiguousarray(x, dtype), device)
        staging.append(host)
        return host.to(device, non_blocking=True)

    def deal(self, x: np.ndarray, dtype, staging: List[torch.Tensor]
             ) -> List[torch.Tensor]:
        """Host frames [T, ...] as ``dtype`` on the devices, one tensor per
        device holding its chunks (k mod N) in order, each staged and
        copied in one piece (:meth:`upload`); on one device, the whole
        video. :meth:`chunked` cuts them into the chunks."""
        motion, n = self._motion, len(self.devices)
        spans = list(motion.chunks(x.shape[0]))
        return [self.upload(x if n == 1 else np.concatenate(
                    [x[s:e] for s, e in spans[j::n]]), dtype, staging, dev)
                for j, dev in enumerate(self.devices[:len(spans)])]

    def chunked(self, parts: List[torch.Tensor], T: int
                ) -> List[torch.Tensor]:
        """The chunk list of a T-frame video dealt by :meth:`deal`: chunk k
        on the device that runs it."""
        return self._motion.views(parts, T)

    def upload_parts(self, hi: np.ndarray, staging: List[torch.Tensor],
                     keep_float: bool = False) -> List[torch.Tensor]:
        """:meth:`upload_frames` dealt over the devices (:meth:`deal`): BGR
        frames, one tensor per device."""
        parts = self.deal(hi, np.float32 if keep_float else np.uint8, staging)
        return [unpack_i420_u8(p) if p.dim() == 3 else p for p in parts]

    def upload_frames(self, hi: np.ndarray, staging: List[torch.Tensor],
                      keep_float: bool = False) -> torch.Tensor:
        """Frames [T, H, W, 3] BGR or packed I420 [T, H*3//2, W] onto the
        first device as BGR [T, H, W, 3]: uint8 (I420 unpacked on the
        device), or float32 with ``keep_float`` (float 0..255 frames whose
        model input is given). :func:`model_input` makes the model input
        from them."""
        h = self.upload(hi, np.float32 if keep_float else np.uint8, staging)
        return unpack_i420_u8(h) if h.dim() == 3 else h

    def model_inputs(self, x: np.ndarray, staging: List[torch.Tensor]
                     ) -> List[torch.Tensor]:
        """Model-size frames as the model input's chunk list, dealt over
        the devices: float [-1, 1] frames as they are, uint8 BGR or packed
        I420 unpacked and normalized on the device (:func:`model_input`)."""
        if x.dtype != np.uint8:
            parts = self.deal(x, np.float32, staging)
        else:
            parts = [model_input(p, self.model_h, self.model_w)
                     for p in self.upload_parts(x, staging)]
        return self.chunked(parts, x.shape[0])

    @torch.no_grad()
    def motion_smooth(self, l1: Frames, l2: Frames,
                      timer: Optional[PhaseTimer] = None
                      ) -> Dict[str, torch.Tensor]:
        """Spatial and temporal motion, transport and the smoothing of
        every window for model inputs [T, mh, mw, 3] in [-1, 1] (tensors
        on the first device, or chunk lists): the dict of
        :func:`smooth_all_windows` (per-frame smooth and original meshes,
        per-window paths) on the first device, each a tensor of its own.
        With ``fused_motion`` the programs run at the chunk shape and the
        16-frame bucket (captured on a card), else eagerly at the true T;
        no waits either way. ``timer`` marks the phases ``spatial`` (the
        spatial motion and the temporal features), ``temporal`` and
        ``smooth``."""
        graphs = self.graphs if self.fused_motion else None
        return self._smooth(*self.motions(l1, l2, graphs, timer), timer,
                            graphs)

    @torch.no_grad()
    def motions(self, l1: Frames, l2: Frames,
                graphs: Optional[GraphCache] = None,
                timer: Optional[PhaseTimer] = None):
        """Phases 1-3 of :meth:`motion_smooth`: (spatial motion 1, spatial
        motion 2, temporal motion 1, temporal motion 2), each [T, GH+1,
        GW+1, 2] on the first device; the chunk programs through
        ``graphs``, or eagerly without it (as inside a captured program,
        which cannot replay another)."""
        motion = self._motion
        c1, c2 = motion.split(l1), motion.split(l2)
        with annotate("spatial"):
            m1, m2, f1, f2 = zip(*(motion.motion_chunk(a, b, k, graphs)
                                   for k, (a, b) in enumerate(zip(c1, c2))))
            smotion1, smotion2 = motion.gather(m1), motion.gather(m2)
        if timer is not None:
            timer.mark("spatial")
        with annotate("temporal"):
            tmotion1, tmotion2 = motion.temporal_from_features(f1, f2, graphs)
        if timer is not None:
            timer.mark("temporal")
        return smotion1, smotion2, tmotion1, tmotion2

    def smooth_program(self):
        """Transport and the smoothing of every window as one function of
        the motions (tmotion1, smotion1, tmotion2, smotion2), each [T, ...]
        on the first device: the dict of :func:`smooth_all_windows`."""
        mh, mw, window = self.model_h, self.model_w, self.config.window

        def program(tm1, sm1, tm2, sm2):
            ts1, ts2 = transport_both_views(tm1, sm1, tm2, sm2, mh, mw)
            return smooth_all_windows(self.smooth_net,
                                      stitched_meshes(sm1, mh, mw),
                                      stitched_meshes(sm2, mh, mw),
                                      ts1, ts2, window=window)

        return program

    def _smooth(self, smotion1, smotion2, tmotion1, tmotion2,
                timer: Optional[PhaseTimer], graphs: Optional[GraphCache]
                ) -> Dict[str, torch.Tensor]:
        """Transport and the smoothing of every window (phase 'smooth'):
        eagerly without ``graphs``; else one program per 16-frame bucket
        through ``graphs``, the motions padded by repeating the last frame
        and the outputs cropped to T frames (T - window + 1 windows)."""
        window = self.config.window
        program = self.smooth_program()
        with annotate("smooth"):
            motions = (tmotion1, smotion1, tmotion2, smotion2)
            if graphs is None:
                smooth = program(*motions)
            else:
                T = smotion1.shape[0]
                if T < window:      # the pad would hide it
                    raise ValueError(f"need at least {window} frames, got "
                                     f"{T}")
                Tb = -(-T // SMOOTH_BUCKET) * SMOOTH_BUCKET
                smooth = graphs.run(f"smooth_w{window}", program,
                                    *(pad_to(x, Tb) for x in motions),
                                    modules=(self.smooth_net,))
                smooth = {k: v[:T - window + 1] if k.startswith("win_")
                          else v[:T] for k, v in smooth.items()}
        if timer is not None:
            timer.mark("smooth")
        return smooth

    def stitch_finish(self, pending: _PendingStitch) -> StitchResult:
        """Collect the frames enqueued by :meth:`stitch_begin`; its phase
        marks are read once the copies are waited for."""
        with annotate("stitch_finish"):
            return self._finish(pending)

    def _finish(self, pending: _PendingStitch) -> StitchResult:
        timer = pending.timer
        frames, canvas = composite_finish(pending.composite, timer=timer)
        timer.resolve()
        timer.fps["composite"] = pending.T / max(
            time.perf_counter() - timer.t0, 1e-9)
        smooth = pending.smooth
        return StitchResult(frames=frames, canvas=canvas,
                            smooth_mesh1=smooth["smooth_mesh1"],
                            smooth_mesh2=smooth["smooth_mesh2"],
                            ori_mesh1=smooth["ori_mesh1"],
                            ori_mesh2=smooth["ori_mesh2"], ms=timer.ms,
                            fps=timer.fps,
                            frame_format=("i420" if self.config.download_format
                                          == "yuv420" else "bgr"))

    def stitch_video_dir(self, video_dir: str,
                         output_path: Optional[str] = None) -> StitchResult:
        """Stitch one <video>/video1 + video2 directory; optionally write mp4."""
        from stabstitch2_tpu_torch.data.video_io import (load_video_pair,
                                                         write_video)

        # the model input is made on the device, as the JAX CLI does
        hi1, _, hi2, _ = load_video_pair(video_dir, model_size=None)
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
                  chunk: int = 8, compute_dtype: Optional[torch.dtype] = None,
                  smooth_dtype: Optional[torch.dtype] = None,
                  n_devices: Optional[int] = None,
                  device="cuda") -> VideoStitcher:
    """A stitcher with random float32 weights drawn from ``rng_seed``.

    ``compute_dtype`` runs the spatial and temporal trunks and heads in
    that dtype; None means bfloat16, the JAX package's inference default.
    Pass ``torch.float32`` for float32 parity runs. ``smooth_dtype`` is
    SmoothNet's; None keeps it float32, as the JAX package does (its
    inputs are absolute mesh coordinates, ~480 px, which bfloat16 would
    quantize to ~2 px). Parameters stay float32 and the geometry runs in
    float32 regardless.

    ``n_devices`` > 1 deals the chunks over that many devices
    (``parallel/devices.py:resolve_devices``: that many cards from
    ``device``, or replicas on the CPU with ``device='cpu'``; ``device``
    may also be a list of devices); the frames equal one device's bit
    for bit.

    The weights are drawn on the CPU from one ``torch.Generator``, so every
    device gets the same values. Raises if ``device`` is 'cuda' and no card
    is present, or if fewer cards than ``n_devices`` are.
    """
    devices = resolve_devices(n_devices, device)
    gen = torch.Generator().manual_seed(rng_seed)
    dt = compute_dtype or torch.bfloat16
    nets = (SpatialNet(model_h, model_w, compute_dtype=dt),
            TemporalNet(model_h, model_w, compute_dtype=dt),
            SmoothNet(smooth_dtype or torch.float32))
    for net in nets:
        init_weights(net, gen)
    return VideoStitcher(*nets, config=config or StitchConfig(), chunk=chunk,
                         model_h=model_h, model_w=model_w, device=devices[0],
                         devices=devices)
