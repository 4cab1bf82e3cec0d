"""Panorama fusion (port of ``ops/blend.py``).

- AVERAGE: ``I1 * I1/(I1+I2+eps) + I2 * I2/(I1+I2+eps)``.
- LINEAR: a seam mask from projecting the overlap onto the axis between
  the two views' centres, feathered with a 21x21, sigma 20 Gaussian blur.

Everything is mask arithmetic over fixed shapes; the masks are batched
over frames ([B, H, W]).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def average_fusion(img1: torch.Tensor, img2: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """Intensity-proportional fusion of two warped frames [..., H, W, C]."""
    total = img1 + img2 + eps
    return img1 * (img1 / total) + img2 * (img2 / total)


def _gaussian_kernel1d(ksize: int, sigma: float) -> np.ndarray:
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2.0
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(x: torch.Tensor, ksize: int = 21,
                  sigma: float = 20.0) -> torch.Tensor:
    """Separable Gaussian blur, reflect padding. x: [B, H, W, C] NHWC."""
    B, H, W, C = x.shape
    k = torch.from_numpy(_gaussian_kernel1d(ksize, sigma)).to(x.device, x.dtype)
    pad = ksize // 2
    y = F.pad(x.permute(0, 3, 1, 2), (pad, pad, pad, pad), mode="reflect")
    y = F.conv2d(y, k.reshape(1, 1, ksize, 1).expand(C, 1, ksize, 1),
                 groups=C)
    y = F.conv2d(y, k.reshape(1, 1, 1, ksize).expand(C, 1, 1, ksize),
                 groups=C)
    return y.permute(0, 2, 3, 1)


def _masked_center(mask: torch.Tensor) -> torch.Tensor:
    """Mean (row, col) of the mask's weight. mask: [B, H, W] -> [B, 2]."""
    _, H, W = mask.shape
    rows = torch.arange(H, dtype=mask.dtype, device=mask.device)[:, None]
    cols = torch.arange(W, dtype=mask.dtype, device=mask.device)[None, :]
    total = mask.sum(dim=(1, 2)) + 1e-8
    return torch.stack([(mask * rows).sum(dim=(1, 2)),
                        (mask * cols).sum(dim=(1, 2))], dim=1) / total[:, None]


def linear_blend_mask(ref_m: torch.Tensor, tgt_m: torch.Tensor,
                      ksize: int = 21, sigma: float = 20.0) -> torch.Tensor:
    """Seam weight of the reference view. ref_m/tgt_m: [B, H, W] in [0, 1]."""
    center1 = _masked_center(ref_m)
    vec = _masked_center(tgt_m) - center1                  # (dr, dc)
    ovl = torch.round(ref_m * tgt_m)
    ref_only = ref_m - ovl
    _, H, W = ref_m.shape
    rows = torch.arange(H, dtype=ref_m.dtype, device=ref_m.device)[None, :, None]
    cols = torch.arange(W, dtype=ref_m.dtype, device=ref_m.device)[None, None, :]
    c1r, c1c = center1[:, 0, None, None], center1[:, 1, None, None]
    proj = (rows - c1r) * vec[:, 0, None, None] + (cols - c1c) * vec[:, 1, None, None]
    big = torch.finfo(ref_m.dtype).max
    on = ovl > 0
    pmin = torch.where(on, proj, big).amin(dim=(1, 2), keepdim=True)
    pmax = torch.where(on, proj, -big).amax(dim=(1, 2), keepdim=True)
    ovl_mask = torch.where(on, (proj - pmin) / (pmax - pmin + 1e-3),
                           torch.zeros((), dtype=proj.dtype, device=proj.device))
    seam = ref_only + (1.0 - ovl_mask) * ref_m
    blurred = gaussian_blur(seam[..., None], ksize, sigma)[..., 0]
    return torch.clamp(blurred * ref_m + ref_only, 0.0, 1.0)


def linear_fusion(ref: torch.Tensor, tgt: torch.Tensor, ref_m: torch.Tensor,
                  tgt_m: torch.Tensor) -> torch.Tensor:
    """LINEAR blend. ref/tgt: [B, H, W, C]; ref_m/tgt_m: [B, H, W]."""
    mask1 = linear_blend_mask(ref_m, tgt_m)
    mask2 = (1.0 - mask1) * tgt_m
    return ref * mask1[..., None] + tgt * mask2[..., None]
