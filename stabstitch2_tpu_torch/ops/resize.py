"""Bicubic resize as torch's ``F.interpolate`` computes it (port of
``ops/resize.py``).

The reference uses torch's bicubic (cubic convolution with a = -0.75,
out-of-range taps replicating the border) for the perceptual loss's
overlap masks (align_corners=False) and the smooth trainer's dense path
fields (align_corners=True). As in the JAX function, the separable
interpolation is two small products with fixed weight matrices,
out = Wy @ X @ Wx^T: their backward is two more products, which sum in a
fixed order, where ``F.interpolate``'s bicubic backward adds with atomics
and so differs from run to run.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from stabstitch2_tpu_torch.utils.transfer import constant

_A = -0.75


def _cubic_kernel(x: np.ndarray) -> np.ndarray:
    ax = np.abs(x)
    return np.where(
        ax <= 1.0,
        ((_A + 2.0) * ax - (_A + 3.0)) * ax * ax + 1.0,
        np.where(ax < 2.0,
                 (((ax - 5.0) * ax + 8.0) * ax - 4.0) * _A,
                 0.0))


def _resize_matrix(in_size: int, out_size: int, align_corners: bool
                   ) -> np.ndarray:
    """[out_size, in_size] row-stochastic bicubic weight matrix."""
    dst = np.arange(out_size, dtype=np.float64)
    if align_corners:
        scale = (in_size - 1) / (out_size - 1) if out_size > 1 else 0.0
        src = dst * scale
    else:
        scale = in_size / out_size
        src = (dst + 0.5) * scale - 0.5
    base = np.floor(src).astype(np.int64)
    frac = src - base
    M = np.zeros((out_size, in_size), np.float64)
    for tap in range(-1, 3):
        idx = np.clip(base + tap, 0, in_size - 1)
        np.add.at(M, (np.arange(out_size), idx), _cubic_kernel(tap - frac))
    return M.astype(np.float32)


@functools.lru_cache(maxsize=None)   # never evicts: a graph may read it
def _weights(in_size: int, out_size: int, align_corners: bool,
             dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return constant(_resize_matrix(in_size, out_size, align_corners),
                    dtype, device)


def resize_bicubic(x: torch.Tensor, out_size: Tuple[int, int],
                   align_corners: bool) -> torch.Tensor:
    """x: [..., H, W, C] -> [..., out_h, out_w, C] (torch bicubic), in
    float32 or wider. A CUDA graph may capture it once an eager call has
    made its weights at that size, dtype and device."""
    dtype = torch.promote_types(x.dtype, torch.float32)
    H, W = x.shape[-3], x.shape[-2]
    Wy = _weights(H, out_size[0], align_corners, dtype, x.device)
    Wx = _weights(W, out_size[1], align_corners, dtype, x.device)
    y = torch.einsum("oh,...hwc->...owc", Wy, x.to(dtype))
    return torch.einsum("pw,...owc->...opc", Wx, y)
