"""The 98th percentile of the host ms around a push of the window: the
far end of the stutter, beyond the 95th that the cell is judged by."""

import numpy as np


def read(run):
    lat = run.layer.get("push_ms")
    return float(np.percentile(lat, 98)) if lat else None
