"""Host ms per push that ``OnlineStitcher.push`` spends handing its frame
pair to the card, over the profiled slice of steady pushes: the seconds of
the program's ``upload`` spans (the pair's ``stage`` copy into page-locked
memory and the enqueue of the copy to the card), over the slice's
pushes."""


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
    s = got and got[0].get("upload")
    return 1e3 * s.total_s / got[1] if s else None
