"""Host ms per frame spent packing the downloaded planes into I420 frames
over the profiled slice of steady videos: the seconds of the program's
``pack`` spans (``pipeline/compositor.py:composite_finish``: the host
view of the planes and ``pack_i420_host``), over the slice's frames."""


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
    s = got and got[0].get("pack")
    return 1e3 * s.total_s / got[1] if s else None
