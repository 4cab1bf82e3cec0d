"""Configuration of the two-view stitch path.

Own copy of the constants and the ``StitchConfig`` fields the main path
reads (the JAX package's ``config.py``): grid 6x8 (7x9 control points),
360x480 model input, a 7-frame smoothing window.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

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
    """End-to-end inference configuration (the fields this port reads)."""

    window: int = WINDOW
    # 'NORMAL' = the reference's interpolation (zero outside the image, no
    # black half-pixel seam); 'FAST' = grid_sample-style align_corners
    # sampling.
    warp_mode: str = "NORMAL"
    # 'AVERAGE' = intensity-proportional fusion; 'LINEAR' = seam-based blend.
    fusion_mode: str = "AVERAGE"
    # The canvas is padded up to multiples of this bucket and warped at the
    # padded size (LINEAR fusion sees the padded canvas); the spline keeps
    # the true extent's normalization, so the padding changes no kept pixel.
    canvas_bucket: int = 32
    # Max canvas size (pixels) the compositor will allocate.
    max_canvas_h: int = 1024
    max_canvas_w: int = 1280
    # 'bgr': frames leave the device as uint8 BGR [T, H, W, 3].
    # 'yuv420': packed I420 [T, H*3//2, W] (H, W cropped to even), half the
    # device->host bytes, what the mp4 writer converts to anyway.
    download_format: str = "bgr"
    # Composite TPS coordinate field: 1 evaluates the spline at every pixel
    # (reference-identical coordinates); s > 1 evaluates every s-th pixel
    # and interpolates the field linearly (<= 0.25 px at stride 4 on
    # realistic smooth meshes, tests/test_geometry.py::TestCoordStride).
    coord_stride: int = 1
    # The fused composite-warp kernel (K2, csrc/fused_warp.cu), counterpart
    # of the JAX package's ``pallas_fused``. None selects it for NORMAL-mode
    # uint8 composites at coord_stride 1, on every device, so the CPU and
    # the card run the same route; False takes the coordinate kernel (K3,
    # csrc/tps_coords.cu) and the patch-gather kernel (K4,
    # csrc/patch_gather.cu) instead. There is no gather switch: the card
    # has one gather, K4.
    fused_warp: Optional[bool] = None

    def __post_init__(self):
        if self.warp_mode not in ("NORMAL", "FAST"):
            raise ValueError(f"unknown warp_mode {self.warp_mode!r}")
        if self.fusion_mode not in ("AVERAGE", "LINEAR"):
            raise ValueError(f"unknown fusion_mode {self.fusion_mode!r}")
        if self.download_format not in ("bgr", "yuv420"):
            raise ValueError(
                f"unknown download_format {self.download_format!r}")
        if int(self.coord_stride) != self.coord_stride or self.coord_stride < 1:
            raise ValueError(f"coord_stride must be an int >= 1, got "
                             f"{self.coord_stride!r}")
