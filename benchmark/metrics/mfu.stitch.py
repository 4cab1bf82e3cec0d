"""The window's share of the chip's peak, in %: the model's work of every
video finished in the window (``counts/work.py:work_of_video``, each
part over the peak of the precision it runs in) over the window's
seconds."""

from benchmark.counts import flops
from benchmark.counts.work import work_of_video


def read(run):
    videos = run.layer.get("videos")
    if not videos:
        return None
    need = sum(flops.peak_seconds(work_of_video(run.cfg, v["T"], v["pad"]))
               for v in videos)
    return 100.0 * need / run.layer["window_s"]
