"""The model's floating-point work per unit of a cell, from shapes, split by
the precision each part runs in: the denominator-free half of ``mfu``.

Convolutions, linear layers and matrix products are counted by
``torch.utils.flop_counter`` on the plain reference's modules built on the
meta device (nothing is computed); the cost volumes and the composite's
spline by ``kernels.py``. Elementwise work (BatchNorm, activations,
pooling, fusion, colour conversion) is not counted. Precisions as the
configuration states them: the spatial and temporal trunks and heads in
``trunk_dtype``; the CCL product, the cost volumes, the smoothing net and
the composite in float32 (TF32 off).

``mfu`` of a window = sum over the parts of (FLOPs / the peak of its
precision) for all the units completed, over the window's seconds.
"""

from __future__ import annotations

import functools
from typing import Dict

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.counts import kernels, peaks
from benchmark.reference import geometry as G
from benchmark.reference import nets as N


def _count(fn) -> float:
    with FlopCounterMode(display=False) as fc:
        fn()
    return float(fc.get_total_flops())


@functools.lru_cache(maxsize=None)
def _per_image(mh: int, mw: int, gh: int, gw: int, window: int
               ) -> Dict[str, float]:
    """FLOPs per image or pair of the nets' parts at batch 1."""
    (h8, w8), (h16, w16) = N.feature_sizes(mh, mw)
    mesh_out = (gh + 1) * (gw + 1) * 2
    with torch.device("meta"):
        s1, s2 = N.Stage1(), N.Stage2()
        h1 = N.ConvHead(2, (64, 128, 128))
        m1 = N.MLPHead((128 * (h16 // 8) * (w16 // 8), 512, 128, 8))
        h2 = N.ConvHead(121, (64, 128, 128, 256))
        m2 = N.MLPHead((256 * (h8 // 16) * (w8 // 16), 1024, 512, mesh_out))
        ht = N.ConvHead(49, (64, 128, 128, 256))
        sm = N.SmoothNet()

        def img():
            return torch.empty(1, mh, mw, 3)

        def f(h, w, c):
            return torch.empty(1, h, w, c)

        return {
            "stage1": _count(lambda: s1(img())),
            "stage2": _count(lambda: s2(f(h8, w8, 128))),
            "homography_head": _count(lambda: m1(h1(f(h16, w16, 2)))),
            "mesh_head_r5": _count(lambda: m2(h2(f(h8, w8, 121)))),
            "mesh_head_r3": _count(lambda: m2(ht(f(h8, w8, 49)))),
            "ccl": _count(lambda: G.ccl_flow(f(h16, w16, 256),
                                             f(h16, w16, 256))),
            "smooth_window": _count(lambda: sm.MotionPre(
                *(torch.empty(1, window, gh + 1, gw + 1, 2)
                  for _ in range(4)))),
            "k1_r5": kernels.k1(1, h8, w8, 128, 5)[1],
            "k1_r3": kernels.k1(1, h8, w8, 128, 3)[1],
        }


def _parts(cfg: dict) -> Dict[str, float]:
    return _per_image(cfg["model_h"], cfg["model_w"], cfg["grid_h"],
                      cfg["grid_w"], cfg["window"])


def pair_spatial(cfg: dict) -> Dict[str, float]:
    """One frame pair's spatial motion and both views' trunk features:
    {precision: FLOPs}."""
    c = _parts(cfg)
    trunk = (2 * c["stage1"] + 2 * c["stage2"] + c["homography_head"]
             + 2 * c["mesh_head_r5"] + 2 * c["stage1"])
    return {cfg["trunk_dtype"]: trunk,
            "float32": c["ccl"] + 2 * c["k1_r5"]}


def pair_temporal(cfg: dict) -> Dict[str, float]:
    """Both views' temporal motion of one frame against the one before."""
    c = _parts(cfg)
    return {cfg["trunk_dtype"]: 2 * c["mesh_head_r3"],
            "float32": 2 * c["k1_r3"]}


def smooth_window(cfg: dict) -> Dict[str, float]:
    return {"float32": _parts(cfg)["smooth_window"]}


def composite(images: int, oh: int, ow: int, P: int) -> Dict[str, float]:
    """The spline of ``images`` warps onto an (oh, ow) canvas."""
    return {"float32": kernels.spline_ops(images, oh, ow, P)}


def peak_seconds(work: Dict[str, float]) -> float:
    """Seconds the chip would take at its peaks: sum of FLOPs / peak."""
    return sum(v / peaks.FLOP_PER_S[k] for k, v in work.items())


def add(*works: Dict[str, float], scale: float = 1.0) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for w in works:
        for k, v in w.items():
            out[k] = out.get(k, 0.0) + v * scale
    return out


def spatial_train(cfg: dict, batch: int) -> Dict[str, float]:
    """One spatial training step of ``batch`` pairs, all float32: every
    part's forward and twice it for its backward (the gradients of its
    input and of its weights): both views' stages 1 and 2, the CCL, the
    homography head, both mesh heads with their search-range-5 volumes,
    and the splines of both views' full-resolution TPS warps."""
    c = _parts(cfg)
    P = (cfg["grid_h"] + 1) * (cfg["grid_w"] + 1)
    fwd = (2 * c["stage1"] + 2 * c["stage2"] + c["ccl"]
           + c["homography_head"] + 2 * c["mesh_head_r5"] + 2 * c["k1_r5"]
           + kernels.spline_ops(2, cfg["model_h"], cfg["model_w"], P))
    return {"float32": 3.0 * batch * fwd}
