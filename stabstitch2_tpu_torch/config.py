"""Configuration of the stitch paths and of the three trainers.

Own copy of the JAX package's ``config.py``: the constants (grid 6x8, so
7x9 control points, 360x480 model input, a 7-frame smoothing window), the
``StitchConfig`` fields the stitch paths read, and the trainers' recipes
(``TrainConfig`` and one subclass per stage) with their ``ssd``/``tra``
presets.
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

# fusion of each reference preset: its ssd scripts fuse AVERAGE, its tra
# scripts LINEAR (the reference's test_online_ssd.py / test_online_tra.py)
PRESET_FUSION = {"ssd": "AVERAGE", "tra": "LINEAR"}


def preset_fusion_mode(preset: str, fusion_mode: Optional[str] = None) -> str:
    """The fusion mode: ``fusion_mode`` when given, else the preset's."""
    if preset not in PRESET_FUSION:
        raise ValueError(f"unknown preset {preset!r}")
    return fusion_mode or PRESET_FUSION[preset]


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


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The optimizer recipe every reference trainer shares: global-norm
    gradient clipping at 3.0, then Adam(1e-4, (0.9, 0.999), eps 1e-8), the
    rate decayed by 0.97 per epoch."""

    learning_rate: float = 1e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    lr_decay_per_epoch: float = 0.97
    grad_clip_norm: float = 3.0
    batch_size: int = 8
    max_epoch: int = 40


@dataclasses.dataclass(frozen=True)
class SpatialTrainConfig(TrainConfig):
    # ssd: overlap + 10 * (inter + intra) per view, no perceptual term;
    # tra: grid weight 5 and perceptual weight 1e-3
    grid_weight: float = 10.0
    perception_weight: float = 0.0
    max_epoch: int = 40


@dataclasses.dataclass(frozen=True)
class TemporalTrainConfig(TrainConfig):
    # overlap + 5 * inter + 5 * intra
    grid_weight: float = 5.0
    max_epoch: int = 100
    train_frame_num: int = 4  # window the random-gap pair is drawn from


@dataclasses.dataclass(frozen=True)
class SmoothTrainConfig(TrainConfig):
    # 1 * data + 50 * smooth + 10 * shape + 1 * trajectory + 0.1 * online
    # + 1000 * align
    data_weight: float = 1.0
    smooth_weight: float = 50.0
    shape_weight: float = 10.0
    trajectory_weight: float = 1.0
    online_weight: float = 0.1
    align_weight: float = 1000.0
    frame_num: int = 7
    train_sqe: int = 2
    train_frame_num: int = 12  # videos shorter than this are skipped
    max_epoch: int = 50


def spatial_train_preset(name: str) -> SpatialTrainConfig:
    if name == "ssd":
        return SpatialTrainConfig()
    if name == "tra":
        return SpatialTrainConfig(grid_weight=5.0, perception_weight=1e-3,
                                  max_epoch=80)
    raise ValueError(f"unknown preset {name!r}")


def temporal_train_preset(name: str) -> TemporalTrainConfig:
    if name in ("ssd", "tra"):
        return TemporalTrainConfig()
    raise ValueError(f"unknown preset {name!r}")


def smooth_train_preset(name: str) -> SmoothTrainConfig:
    if name in ("ssd", "tra"):
        return SmoothTrainConfig()
    raise ValueError(f"unknown preset {name!r}")
