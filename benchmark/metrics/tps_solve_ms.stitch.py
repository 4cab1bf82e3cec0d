"""Host ms per frame of the TPS solves over the profiled slice of steady
videos: the seconds of the program's ``tps_solve`` spans
(``ops/tps.py:tps_params``: the system, the LU factor and solve as the
host issues them, and any wait for the card inside the library's
factorization), over the slice's frames."""


def spans(run):
    """The program's span table (``utils/profiling.py:table``) and the
    slice's units, or None: no slice, or a program without the table."""
    if run.trace is None or not run.trace.units:
        return None
    from stabstitch2_tpu_torch.utils import profiling

    table = getattr(profiling, "table", None)
    return None if table is None else (table().spans, run.trace.units)


def read(run):
    got = spans(run)
    s = got and got[0].get("tps_solve")
    return 1e3 * s.total_s / got[1] if s else None
