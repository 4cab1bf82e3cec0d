"""Homography spatial transformer (port of ``ops/homography.py``).

A normalized [-1, 1] output grid is pushed through theta, divided with the
reference's small-denominator guard, and sampled with
:func:`~stabstitch2_tpu_torch.ops.interp.bilinear_sample` semantics.
"""

from __future__ import annotations

from typing import Tuple

import torch

from stabstitch2_tpu_torch.ops.interp import bilinear_mask, bilinear_sample
from stabstitch2_tpu_torch.utils.transfer import shape_constant


def normalized_grid(height: int, width: int, dtype=torch.float32,
                    device=None) -> torch.Tensor:
    """Homogeneous normalized grid [3, H*W]: rows (x, y, 1)."""
    x = torch.linspace(-1.0, 1.0, width, dtype=dtype, device=device)
    y = torch.linspace(-1.0, 1.0, height, dtype=dtype, device=device)
    gy, gx = torch.meshgrid(y, x, indexing="ij")
    ones = torch.ones(height * width, dtype=dtype, device=device)
    return torch.stack([gx.reshape(-1), gy.reshape(-1), ones], dim=0)


def homo_sample_coords(theta: torch.Tensor, out_size: Tuple[int, int]
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Map the output grid through theta [B, 3, 3]: (x_s, y_s), each [B, H*W].

    Adds 1e-6 to the denominator wherever |t| < 1e-7, as the reference does.
    """
    out_h, out_w = out_size
    grid = normalized_grid(out_h, out_w, theta.dtype, theta.device)
    T_g = torch.einsum("bij,jn->bin", theta, grid)
    x_s, y_s, t_s = T_g[:, 0], T_g[:, 1], T_g[:, 2]
    t_s = t_s + 1e-6 * (1.0 - (t_s.abs() >= 1e-7).to(t_s.dtype))
    return x_s / t_s, y_s / t_s


def homo_warp(im: torch.Tensor, theta: torch.Tensor,
              out_size: Tuple[int, int]) -> torch.Tensor:
    """Warp NHWC images [B, H, W, C] by normalized homographies [B, 3, 3]."""
    B, _, _, C = im.shape
    x_s, y_s = homo_sample_coords(theta, out_size)
    return bilinear_sample(im, x_s, y_s).reshape(B, *out_size, C)


def homo_warp_with_mask(im: torch.Tensor, theta: torch.Tensor,
                        out_size: Tuple[int, int]
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`homo_warp` and its coverage mask [B, oh, ow]: the warp of an
    all-ones channel, computed from the sample coordinates."""
    B, H, W, C = im.shape
    x_s, y_s = homo_sample_coords(theta, out_size)
    sampled = bilinear_sample(im, x_s, y_s).reshape(B, *out_size, C)
    return sampled, bilinear_mask(H, W, x_s, y_s).reshape(B, *out_size)


def normalize_homography(H: torch.Tensor, height: float,
                         width: float) -> torch.Tensor:
    """Conjugate a pixel homography into normalized coords: M^-1 H M."""
    w2, h2 = float(width) / 2.0, float(height) / 2.0
    M = shape_constant([[w2, 0.0, w2], [0.0, h2, h2], [0.0, 0.0, 1.0]],
                       H.dtype, H.device)
    M_inv = shape_constant([[1.0 / w2, 0.0, -1.0], [0.0, 1.0 / h2, -1.0],
                            [0.0, 0.0, 1.0]], H.dtype, H.device)
    return torch.einsum("ij,bjk,kl->bil", M_inv, H, M)
