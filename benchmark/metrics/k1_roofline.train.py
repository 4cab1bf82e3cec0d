"""K1's share of its roofline over the profiled slice of steady training
steps, in %: the least time the forward cost volumes of the slice's
steps need (``counts/work.py:k1_bound_of_step``) over the device time
of the kernels named ``cost_volume`` (their backward runs in plain
operations, under other names)."""

from benchmark.counts.work import k1_bound_of_step


def read(run):
    t = run.trace
    if t is None or not t.units:
        return None
    seconds, launches = t.seconds_of("cost_volume")
    if not launches:
        return None
    need = t.units * k1_bound_of_step(run.cfg, run.mix["recipe"]["batch"])
    return 100.0 * need / seconds
