"""Bicubic resize as torch's ``F.interpolate`` computes it (port of
``ops/resize.py``).

The JAX function exists to match torch's bicubic (cubic convolution with
a = -0.75, out-of-range taps replicating the border), which the
reference uses for the perceptual loss's overlap masks
(align_corners=False) and the smooth trainer's dense path fields
(align_corners=True). Here it is that library call, on ``[..., H, W, C]``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def resize_bicubic(x: torch.Tensor, out_size: Tuple[int, int],
                   align_corners: bool) -> torch.Tensor:
    """x: [..., H, W, C] -> [..., out_h, out_w, C] (torch bicubic)."""
    lead, (H, W, C) = x.shape[:-3], x.shape[-3:]
    nchw = x.reshape(-1, H, W, C).permute(0, 3, 1, 2)
    y = F.interpolate(nchw, size=tuple(out_size), mode="bicubic",
                      align_corners=align_corners, antialias=False)
    return y.permute(0, 2, 3, 1).reshape(*lead, *out_size, C)
