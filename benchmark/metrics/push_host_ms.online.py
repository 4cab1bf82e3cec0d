"""Host ms per push that ``OnlineStitcher.push`` spends other than
waiting for the card, over the profiled slice of steady pushes: the
seconds of the program's ``push`` spans less those of the ``wait``
spans (the slice waits only inside pushes: one fetch each), over the
slice's pushes."""


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
    push = got and got[0].get("push")
    if not push:
        return None
    wait = got[0].get("wait")
    return 1e3 * (push.total_s - (wait.total_s if wait else 0.0)) / got[1]
