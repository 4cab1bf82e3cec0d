"""A profiled slice of a run, read into the numbers the metrics need.

:class:`Slice` wraps a bounded stretch of steady work in
``torch.profiler`` (host and card), synchronizing the card on entry and
exit so that the slice holds the device work it enqueued and nothing
else. The Chrome trace goes to a file under ``TMPDIR`` (its size is
printed on standard error), is read into a :class:`Summary` and deleted.

The device is busy where a kernel, copy or fill runs: the union of their
intervals. The window is the span of every event of the trace, host and
device. The longest idle gaps (``GAPS`` of them) are attributed to the
innermost host operation or annotation that spans the gap's middle. A
device operation belongs to a span (``record_function`` annotations the
program makes, such as the stitcher's phases) when the runtime call that
launched it (the same ``correlation``) was made inside that span.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import sys
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")
GAPS = 500


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    kernel_s: Dict[str, float]          # device seconds by kernel name
    kernel_n: Dict[str, int]            # launches by kernel name
    device_ops: List[Tuple[str, float]]  # top device operations
    idle_gaps: List[Tuple[str, float]]   # idle seconds by host activity
    span_s: Dict[str, float] = dataclasses.field(default_factory=dict)
    units: int = 0                       # units of work in the slice
    notes: Dict[str, object] = dataclasses.field(default_factory=dict)

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def seconds_of(self, fragment: str) -> Tuple[float, int]:
        """Device seconds and launches of the kernels whose name holds
        ``fragment``."""
        s = sum(v for k, v in self.kernel_s.items() if fragment in k)
        n = sum(v for k, v in self.kernel_n.items() if fragment in k)
        return s, n


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def device_seconds_by_span(events: List[dict], dev: List[dict],
                           names) -> Dict[str, float]:
    """Device seconds of the operations launched inside the annotations
    ``names`` (each device operation counted under the first name whose
    span holds its launch)."""
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    spans = {n: sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                       if e.get("cat") == "user_annotation"
                       and e["name"] == n) for n in names}
    starts = {n: np.array([a for a, _ in iv]) for n, iv in spans.items()}
    out = dict.fromkeys(names, 0.0)
    for d in dev:
        t = launched.get(d.get("args", {}).get("correlation"))
        if t is None:
            continue
        for n in names:
            i = int(np.searchsorted(starts[n], t, side="right")) - 1
            if i >= 0 and t <= spans[n][i][1]:
                out[n] += d["dur"] / 1e6
                break
    return out


def summarize(events: List[dict], top: int = 10, spans=()) -> Summary:
    events = [e for e in events if e.get("ph") == "X" and "dur" in e]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    host = [e for e in events if e.get("cat") in HOST_CATS]
    t0 = min(e["ts"] for e in events)
    t1 = max(e["ts"] + e["dur"] for e in events)
    busy = _union([e["ts"], e["ts"] + e["dur"]] for e in dev)
    by_name, n_name = collections.Counter(), collections.Counter()
    for e in dev:
        by_name[e["name"]] += e["dur"] / 1e6
        n_name[e["name"]] += 1
    # idle gaps: before the first device op, between ops, after the last
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    starts = np.array([e["ts"] for e in host], dtype=np.float64)
    durs = np.array([e["dur"] for e in host], dtype=np.float64)
    by_host = collections.Counter()
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:GAPS]:
        mid = (a + b) / 2
        hit = np.flatnonzero((starts <= mid) & (starts + durs >= mid))
        name = (host[hit[np.argmin(durs[hit])]]["name"] if hit.size
                else "no host operation")
        by_host[name[:100]] += (b - a) / 1e6
    return Summary(window_s=(t1 - t0) / 1e6,
                   busy_s=sum(b - a for a, b in busy) / 1e6,
                   kernel_s=dict(by_name), kernel_n=dict(n_name),
                   device_ops=[(k[:120], v) for k, v in
                               by_name.most_common(top)],
                   idle_gaps=by_host.most_common(top),
                   span_s=device_seconds_by_span(events, dev, spans))


class Slice:
    """``with Slice(spans) as s: ...`` profiles the block; ``s.summary``
    holds the :class:`Summary` after it (None where the card shows no
    work), with the device seconds of each annotation in ``spans``."""

    def __init__(self, spans=()):
        self.spans = tuple(spans)
        self.summary: Optional[Summary] = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.cuda = torch.cuda.is_available()
        activities = [ProfilerActivity.CPU]
        if self.cuda:
            torch.cuda.synchronize()
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch

        if self.cuda:
            torch.cuda.synchronize()
        self.seconds = time.perf_counter() - self.t0
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        fd, path = tempfile.mkstemp(prefix="bench_trace_", suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            print(f"trace: {os.path.getsize(path)} bytes written under "
                  f"TMPDIR", file=sys.stderr)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        if any(e.get("cat") in DEVICE_CATS for e in events):
            self.summary = summarize(events, spans=self.spans)
        return False
