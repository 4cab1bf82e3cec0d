"""The model's work and the kernels' least time per unit of each kind of
cell, from the configuration and the unit's shapes: a stitched video, an
online push, a training step (``flops.py``, ``kernels.py``). The metric
readers divide these by what a run measured."""

from __future__ import annotations

from benchmark.counts import flops, kernels
from benchmark.reference import nets as N


def work_of_video(cfg: dict, T: int, pad) -> dict:
    """The model's work of one T-frame video on a (pad_h, pad_w) canvas:
    each adjacent pair of views through the two-view motion and smoothing,
    every view warped onto the canvas."""
    P = (cfg["grid_h"] + 1) * (cfg["grid_w"] + 1)
    pair = flops.add(flops.add(flops.pair_spatial(cfg), scale=T),
                     flops.add(flops.pair_temporal(cfg), scale=T - 1),
                     flops.add(flops.smooth_window(cfg),
                               scale=T - cfg["window"] + 1))
    return flops.add(flops.add(pair, scale=cfg["views"] - 1),
                     flops.composite(cfg["views"] * T, pad[0], pad[1], P))


def k1_bound_of_video(cfg: dict, T: int) -> float:
    """K1's work of one video, per adjacent pair of views: two
    search-range-5 volumes a frame, one search-range-3 volume per view and
    frame after the first."""
    (h8, w8), _ = N.feature_sizes(cfg["model_h"], cfg["model_w"])
    pair = (2 * kernels.bound_s(*kernels.k1(T, h8, w8, 128, 5))
            + kernels.bound_s(*kernels.k1(2 * (T - 1), h8, w8, 128, 3)))
    return (cfg["views"] - 1) * pair


def k2_bound_of_video(cfg: dict, T: int, pad, live_share: float) -> float:
    P = (cfg["grid_h"] + 1) * (cfg["grid_w"] + 1)
    images = cfg["views"] * T
    return kernels.bound_s(*kernels.k2(
        images, cfg["frame_h"], cfg["frame_w"], pad[0], pad[1], P,
        live_share * images * pad[0] * pad[1]))


def work_of_push(cfg: dict, pad) -> dict:
    """The model's work of one steady push: the pair's spatial motion and
    features, both views' temporal motion, one smoothing window, two warps
    onto the (pad_h, pad_w) canvas."""
    P = (cfg["grid_h"] + 1) * (cfg["grid_w"] + 1)
    return flops.add(flops.pair_spatial(cfg), flops.pair_temporal(cfg),
                     flops.smooth_window(cfg),
                     flops.composite(2, pad[0], pad[1], P))


def k2_bound_of_push(cfg: dict, pad, live_share: float) -> float:
    P = (cfg["grid_h"] + 1) * (cfg["grid_w"] + 1)
    return kernels.bound_s(*kernels.k2(
        2, cfg["frame_h"], cfg["frame_w"], pad[0], pad[1], P,
        live_share * 2 * pad[0] * pad[1]))


def k1_bound_of_step(cfg: dict, batch: int) -> float:
    """K1's forward work of one step: the two search-range-5 volumes of
    the batch."""
    (h8, w8), _ = N.feature_sizes(cfg["model_h"], cfg["model_w"])
    return 2 * kernels.bound_s(*kernels.k1(batch, h8, w8, 128, 5))
