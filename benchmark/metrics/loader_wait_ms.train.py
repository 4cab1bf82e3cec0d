"""Host ms per training step that the trainer waits for its loader's next
batch over the profiled slice of steady steps: the seconds of the
program's ``loader_wait`` spans (``data/datasets.py:batch_iterator``:
the consumer's wait on the prefetch queue), over the slice's steps."""


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
    s = got and got[0].get("loader_wait")
    return 1e3 * s.total_s / got[1] if s else None
