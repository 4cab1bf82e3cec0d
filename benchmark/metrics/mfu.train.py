"""The window's share of the chip's peak, in %: the model's work of every
training step of the window (``counts/flops.py:spatial_train``, float32
over the float32 peak) over the window's seconds."""

from benchmark.counts import flops


def read(run):
    steps = run.layer.get("steps")
    if not steps:
        return None
    need = steps * flops.peak_seconds(flops.spatial_train(
        run.cfg, run.mix["recipe"]["batch"]))
    return 100.0 * need / run.layer["window_s"]
