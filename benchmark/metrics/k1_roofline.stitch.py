"""K1's share of its roofline over the profiled slice of steady videos,
in %: the least time the cost volumes of the slice's videos need
(``counts/work.py:k1_bound_of_video``) over the device time of the
kernels named ``cost_volume``."""

from benchmark.counts.work import k1_bound_of_video


def read(run):
    t = run.trace
    if t is None:
        return None
    seconds, launches = t.seconds_of("cost_volume")
    if not launches:
        return None
    need = sum(k1_bound_of_video(run.cfg, v["T"]) for v in t.notes["videos"])
    return 100.0 * need / seconds
