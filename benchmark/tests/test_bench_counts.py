"""The benchmark's counts of each kernel's work reproduce the bounds that
the repository's kernel measurements report for the main path's shapes
(PERF.md, the table of the TPU kernels and their ports): K1 0.01173 ms a
launch (search ranges 5 and 3 at [8, 45, 60, 128] and [16, 45, 60, 128],
two launches of the first to one of the second), K2 0.1345 (16 images of
360x480 onto the 448x608 canvas, 63 control points, the live share of
that chunk, 0.63), K3 0.1317 and K4 0.02849 (the same canvas)."""

from __future__ import annotations

import pytest

from benchmark.counts import flops, kernels

IMAGES, CANVAS, P = 16, (448, 608), 63


def ms(nbytes_ops):
    return kernels.bound_s(*nbytes_ops) * 1e3


def test_k1_bound():
    b5, o5 = kernels.k1(8, 45, 60, 128, 5)
    b3, o3 = kernels.k1(16, 45, 60, 128, 3)
    assert ms(((2 * b5 + b3) / 3, (2 * o5 + o3) / 3)) == pytest.approx(
        0.01173, abs=5e-6)


def test_k2_bound():
    live = 0.63 * IMAGES * CANVAS[0] * CANVAS[1]
    assert ms(kernels.k2(IMAGES, 360, 480, *CANVAS, P, live)) == \
        pytest.approx(0.1345, abs=5e-5)


def test_k3_bound():
    assert ms(kernels.k3(IMAGES, *CANVAS, P)) == pytest.approx(0.1317,
                                                               abs=5e-5)


def test_k4_bound():
    live = 0.63 * IMAGES * CANVAS[0] * CANVAS[1]
    assert ms(kernels.k4(IMAGES, 360, 480, *CANVAS, live)) == \
        pytest.approx(0.02849, abs=5e-6)


def test_model_flops_from_shapes():
    """ResNet-18 to layer2 at 360x480: 6.83 GFLOP an image (conv1 alone
    2 * 64 * 180 * 240 * 3 * 49 = 0.813 GFLOP)."""
    cfg = {"model_h": 360, "model_w": 480, "grid_h": 6, "grid_w": 8,
           "window": 7, "trunk_dtype": "bfloat16"}
    parts = flops._parts(cfg)
    assert parts["stage1"] == pytest.approx(6.829e9, rel=1e-3)
    work = flops.pair_spatial(cfg)
    assert set(work) == {"bfloat16", "float32"}
    assert work["bfloat16"] == pytest.approx(
        4 * parts["stage1"] + 2 * parts["stage2"] + parts["homography_head"]
        + 2 * parts["mesh_head_r5"])
    assert flops.peak_seconds({"bfloat16": 989e12, "float32": 67e12}) == 2.0


def test_training_flops_from_shapes():
    """A spatial training step counts each part's forward three times (the
    forward and a backward of twice its work), all float32: 593 GFLOP at
    batch 8 and 360x480."""
    cfg = {"model_h": 360, "model_w": 480, "grid_h": 6, "grid_w": 8,
           "window": 7, "trunk_dtype": "bfloat16"}
    parts = flops._parts(cfg)
    work = flops.spatial_train(cfg, 8)
    assert set(work) == {"float32"}
    fwd = (2 * parts["stage1"] + 2 * parts["stage2"] + parts["ccl"]
           + parts["homography_head"] + 2 * parts["mesh_head_r5"]
           + 2 * parts["k1_r5"] + kernels.spline_ops(2, 360, 480, 63))
    assert work["float32"] == pytest.approx(24 * fwd)
    assert work["float32"] == pytest.approx(5.933e11, rel=1e-3)
