"""K2's share of its roofline over the profiled slice of steady pushes,
in %: the least time the work of the slice's composites needs (two warps
a push onto its canvas, ``counts/kernels.py:k2``, with the live share the
reference measured) over the device time of the kernels named
``fused_warp``."""

from benchmark.counts.work import k2_bound_of_push


def read(run):
    t = run.trace
    if t is None or "live_share" not in run.layer:
        return None
    seconds, launches = t.seconds_of("fused_warp")
    if not launches:
        return None
    need = sum(k2_bound_of_push(run.cfg, p, run.layer["live_share"])
               for p in t.notes["pads"])
    return 100.0 * need / seconds
