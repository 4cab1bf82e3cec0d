"""Phase timing and device traces (port of ``utils/profiling.py``).

- :class:`PhaseTimer` keeps the reference's cumulative per-phase fps
  report, with the JAX package's phase names (upload, spatial, temporal,
  smooth, warp_fuse, download; ``composite`` and ``encode`` as fps only).
- :func:`trace` wraps ``torch.profiler`` so a section can be captured as a
  Chrome trace (``chrome://tracing`` or Perfetto) of host and device work.
- :func:`annotate` names a span inside such a trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch


class PhaseTimer:
    """Cumulative per-phase fps and per-phase ms, reference-style.

    ``sync``: the device (or devices) to synchronize at each :meth:`mark`
    that asks for it, or None to never synchronize (the marks then time
    the enqueue).
    """

    def __init__(self, num_frames: int, sync=None):
        self.num_frames = num_frames
        devices = sync if isinstance(sync, (list, tuple)) else [sync]
        self.sync = [d for d in dict.fromkeys(devices)
                     if d is not None and d.type == "cuda"]
        self.t0 = time.perf_counter()
        self.fps: Dict[str, float] = {}
        self.ms: Dict[str, float] = {}
        self._last = self.t0

    def mark(self, phase: str, sync: bool = True) -> None:
        if sync:
            for device in self.sync:
                torch.cuda.synchronize(device)
        now = time.perf_counter()
        self.fps[phase] = self.num_frames / max(now - self.t0, 1e-9)
        self.ms[phase] = (now - self._last) * 1e3
        self._last = now


@contextlib.contextmanager
def trace(trace_dir: Optional[str]):
    """Profile the enclosed section into ``trace_dir``.

    Host (CPU) activity always, the card's kernels and copies when CUDA is
    available. Before the profiler stops, the card is synchronized, so the
    trace holds the device work the section enqueued. Writes one Chrome
    trace JSON, ``trace_<pid>_<n>.json``, per section. No-op when
    ``trace_dir`` is None, so call sites can pass a flag directly.
    """
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(trace_dir, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        try:
            yield
        finally:
            if cuda:
                torch.cuda.synchronize()
    n = len([f for f in os.listdir(trace_dir) if f.startswith("trace_")])
    prof.export_chrome_trace(
        os.path.join(trace_dir, f"trace_{os.getpid()}_{n}.json"))


def annotate(name: str):
    """Named span inside a trace (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(name)
