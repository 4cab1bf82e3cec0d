"""Median host ms around a push of the window: the online layer's steady
latency, beside the 95th percentile that the cell is judged by."""

import numpy as np


def read(run):
    lat = run.layer.get("push_ms")
    return float(np.median(lat)) if lat else None
