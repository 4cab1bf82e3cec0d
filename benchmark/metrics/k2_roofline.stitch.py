"""K2's share of its roofline over the profiled slice of steady videos,
in %: the least time the warps of the slice's videos need (every view of
every frame onto its video's canvas, ``counts/kernels.py:k2``, with the
live share the reference measured) over the device time of the kernels
named ``fused_warp``."""

from benchmark.counts.work import k2_bound_of_video


def read(run):
    t = run.trace
    if t is None or "live_share" not in run.layer:
        return None
    seconds, launches = t.seconds_of("fused_warp")
    if not launches:
        return None
    need = sum(k2_bound_of_video(run.cfg, v["T"], v["pad"],
                                 run.layer["live_share"])
               for v in t.notes["videos"])
    return 100.0 * need / seconds
