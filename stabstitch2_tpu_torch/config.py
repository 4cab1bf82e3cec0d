"""Configuration of the two-view stitch path.

Own copy of the constants and the ``StitchConfig`` fields the main path
reads (the JAX package's ``config.py``): grid 6x8 (7x9 control points),
360x480 model input, a 7-frame smoothing window.
"""

from __future__ import annotations

import dataclasses

# (GRID_H+1) x (GRID_W+1) control points (reference grid_res.py:3-4)
GRID_H = 6
GRID_W = 8

# model resolution the regression heads are sized for
MODEL_H = 360
MODEL_W = 480

# online smoothing window length
WINDOW = 7


@dataclasses.dataclass(frozen=True)
class StitchConfig:
    """End-to-end inference configuration (the fields this port reads).

    ``warp_mode``: only 'NORMAL' (the reference's zero-outside sampler).
    ``fusion_mode``: 'AVERAGE' or 'LINEAR'. ``canvas_bucket``: the canvas
    is padded up to multiples of it and warped at the padded size, as the
    JAX compositor does (LINEAR fusion sees the padded canvas).
    ``download_format``: only 'bgr' (uint8 [T, H, W, 3]).
    """

    window: int = WINDOW
    warp_mode: str = "NORMAL"
    fusion_mode: str = "AVERAGE"
    canvas_bucket: int = 32
    max_canvas_h: int = 1024
    max_canvas_w: int = 1280
    download_format: str = "bgr"

    def __post_init__(self):
        if self.warp_mode != "NORMAL":
            raise ValueError(
                f"warp_mode {self.warp_mode!r} is not ported yet (NORMAL only)")
        if self.fusion_mode not in ("AVERAGE", "LINEAR"):
            raise ValueError(f"unknown fusion_mode {self.fusion_mode!r}")
        if self.download_format != "bgr":
            raise ValueError(
                f"download_format {self.download_format!r} is not ported yet "
                "(bgr only)")
