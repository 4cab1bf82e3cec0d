"""Phase timing, spans and device traces (port of ``utils/profiling.py``).

- :class:`PhaseTimer` keeps the reference's cumulative per-phase fps
  report, with the JAX package's phase names (upload, spatial, temporal,
  smooth, warp_fuse, download; ``composite`` and ``encode`` as fps only).
  On a card its marks are CUDA events: a mark never waits.
- :func:`annotate` is the program's one span. While no ``torch.profiler``
  session runs it does nothing but check that flag; while one runs it is
  a ``record_function`` range in the trace and adds its host seconds to
  an in-memory table (:func:`table`), as :func:`count` adds to counters.
- :func:`trace` wraps ``torch.profiler`` so a section can be captured as a
  Chrome trace (``chrome://tracing`` or Perfetto) of host and device work.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import os
import threading
import time
from typing import Dict, List, Optional

import torch

# the profiler's on/off flag: one C call, ~0.2 us
_profiling = torch.autograd._profiler_enabled
_OFF = contextlib.nullcontext()


@dataclasses.dataclass
class SpanTotals:
    """One span name's totals: calls, host seconds, and host seconds less
    the spans entered inside it (its self time)."""

    count: int = 0
    total_s: float = 0.0
    self_s: float = 0.0


@dataclasses.dataclass
class Table:
    """What the spans and counters recorded while profiling was on."""

    spans: Dict[str, SpanTotals] = dataclasses.field(default_factory=dict)
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)


# process-wide, as the profiler is: spans on any thread add here
_TABLE = Table()
_LOCK = threading.Lock()
_LOCAL = threading.local()      # .stack: this thread's open spans


def table() -> Table:
    """A copy of the table: every span and counter recorded since the last
    :func:`clear_table` (or :func:`trace` section)."""
    with _LOCK:
        return copy.deepcopy(_TABLE)


def clear_table() -> None:
    with _LOCK:
        _TABLE.spans.clear()
        _TABLE.counters.clear()


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to counter ``name`` while profiling is on; else nothing."""
    if not _profiling():
        return
    with _LOCK:
        _TABLE.counters[name] = _TABLE.counters.get(name, 0) + n


class _Span:
    """A profiled span: a ``record_function`` range, timed on the host and
    added to the table on exit. Its parent is the innermost span open on
    the same thread, whose self time leaves this span's out."""

    __slots__ = ("name", "_range", "_t0", "_inner")

    def __init__(self, name: str):
        self.name = name
        self._range = torch.profiler.record_function(name)

    def __enter__(self):
        self._range.__enter__()
        stack = getattr(_LOCAL, "stack", None)
        if stack is None:
            stack = _LOCAL.stack = []
        stack.append(self)
        self._inner = 0.0
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        stack = _LOCAL.stack
        stack.pop()
        if stack:
            stack[-1]._inner += dt
        with _LOCK:
            s = _TABLE.spans.get(self.name)
            if s is None:
                s = _TABLE.spans[self.name] = SpanTotals()
            s.count += 1
            s.total_s += dt
            s.self_s += dt - self._inner
        self._range.__exit__(*exc)
        return False


def annotate(name: str):
    """A named span (``with annotate("wait"): ...``): nothing while no
    profiler runs; under one, a ``record_function`` range in the trace and
    an entry of :func:`table`. Adds no wait for the card."""
    return _Span(name) if _profiling() else _OFF


class PhaseTimer:
    """Cumulative per-phase fps and per-phase ms, reference-style.

    ``devices``: the device (or devices) whose card time the marks read,
    or None for the host's clock. On a card each mark records a CUDA event
    on each device's current stream, the first at construction, and never
    waits; :meth:`resolve` reads them once the card is past them (the
    phase's time is the slowest device's). On the host's clock a mark
    reads ``time.perf_counter``: where the card runs behind, the time the
    phase was enqueued. No mark may be taken inside a CUDA-graph capture.
    """

    def __init__(self, num_frames: int, devices=None):
        self.num_frames = num_frames
        devices = devices if isinstance(devices, (list, tuple)) else [devices]
        self.devices = [d for d in dict.fromkeys(devices)
                        if d is not None and d.type == "cuda"]
        self.t0 = time.perf_counter()
        self.fps: Dict[str, float] = {}
        self.ms: Dict[str, float] = {}
        self._prev = 0.0                # the last mark, seconds from t0
        self._start = self._record()
        self._marks: List = []          # (phase, {device: event})

    def _record(self) -> Dict[torch.device, torch.cuda.Event]:
        """An event on each device's current stream, keyed by the stream's
        device (with its index, as a tensor's ``.device`` has it)."""
        events = {}
        for d in self.devices:
            stream = torch.cuda.current_stream(d)
            event = torch.cuda.Event(enable_timing=True)
            event.record(stream)
            events[stream.device] = event
        return events

    def mark(self, phase: str, events: Optional[Dict] = None) -> None:
        """The end of ``phase``: on a card, ``events`` ({a tensor's device:
        timing event} the caller already recorded) or new events; else
        now."""
        if not self.devices:
            self._set(phase, time.perf_counter() - self.t0)
            return
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"phase mark {phase!r} inside a CUDA-graph "
                               "capture")
        self._marks.append((phase, self._record() if events is None
                            else events))

    def _set(self, phase: str, seconds: float) -> None:
        self.fps[phase] = self.num_frames / max(seconds, 1e-9)
        self.ms[phase] = (seconds - self._prev) * 1e3
        self._prev = seconds

    def resolve(self) -> None:
        """Read the event marks into ``ms`` and ``fps``, cumulative from the
        first event. Call it after waiting for the card past the last
        mark; a device whose events are not complete is left out (no
        wait)."""
        for phase, events in self._marks:
            ms = [self._start[d].elapsed_time(e) for d, e in events.items()
                  if d in self._start and self._start[d].query()
                  and e.query()]
            if ms:
                self._set(phase, max(ms) / 1e3)
        self._marks = []


@contextlib.contextmanager
def trace(trace_dir: Optional[str]):
    """Profile the enclosed section into ``trace_dir``.

    Host (CPU) activity always, the card's kernels and copies when CUDA is
    available. Before the profiler stops, the card is synchronized, so the
    trace holds the device work the section enqueued. Writes one Chrome
    trace JSON, ``trace_<pid>_<n>.json``, per section, and clears the span
    table on entry, so that :func:`table` then holds the section's spans.
    No-op when ``trace_dir`` is None, so call sites can pass a flag
    directly.
    """
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(trace_dir, exist_ok=True)
    clear_table()
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
