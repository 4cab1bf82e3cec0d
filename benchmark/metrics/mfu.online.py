"""The window's share of the chip's peak, in %: the model's work of every
push (``counts/work.py:work_of_push`` on the canvas the push used,
each part over the peak of the precision it runs in) over the window's
seconds."""

from benchmark.counts import flops
from benchmark.counts.work import work_of_push


def read(run):
    pads = run.layer.get("pads")
    if not pads:
        return None
    need = sum(flops.peak_seconds(work_of_push(run.cfg, p)) for p in pads)
    return 100.0 * need / run.layer["window_s"]
