"""Correlation operators (port of ``ops/cost_volume.py``).

- :func:`cost_volume`: channel d = dy*(2r+1)+dx holds the mean over C of
  x1 times x2 shifted by (dy-r, dx-r) (x2 zero-padded by r), through
  leaky_relu(0.1): the plain version of the hand-written kernel in
  ``ops/corr_cuda.py``. The JAX function's ``norm`` option (L2-normalize
  both maps first) is left out: no caller of the port sets it.
- :func:`ccl_flow`: contextual correlation flow, one batched
  [HW, 9C] x [9C, HW] product of 3x3 patches of the L2-normalized maps,
  a x10 softmax over the second map's positions and the expected
  displacement. A plain matrix product, left to ``torch.matmul``.

Feature maps are NHWC.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    norm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    return x / torch.clamp(norm, min=eps)


def cost_volume(x1: torch.Tensor, x2: torch.Tensor,
                search_range: int) -> torch.Tensor:
    """Local correlation volume: [B, H, W, C] x2 -> [B, H, W, (2r+1)^2]."""
    B, H, W, C = x1.shape
    r = search_range
    k = 2 * r + 1
    padded = F.pad(x2, (0, 0, r, r, r, r))
    slices = [torch.mean(x1 * padded[:, dy:dy + H, dx:dx + W, :], dim=-1)
              for dy in range(k) for dx in range(k)]
    return F.leaky_relu(torch.stack(slices, dim=-1), negative_slope=0.1)


def _patches_3x3(x: torch.Tensor) -> torch.Tensor:
    """Zero-padded 3x3 neighbourhoods: [B, H, W, C] -> [B, H*W, 9*C]."""
    B, H, W, C = x.shape
    padded = F.pad(x, (0, 0, 1, 1, 1, 1))
    cols = [padded[:, dy:dy + H, dx:dx + W, :]
            for dy in range(3) for dx in range(3)]
    return torch.cat(cols, dim=-1).reshape(B, H * W, 9 * C)


def ccl_flow(feature_1: torch.Tensor, feature_2: torch.Tensor,
             softmax_scale: float = 10.0) -> torch.Tensor:
    """Contextual correlation flow: [B, H, W, C] x2 -> [B, H, W, 2] (w, h)."""
    B, H, W, C = feature_1.shape
    p1 = _patches_3x3(_l2_normalize(feature_1))
    p2 = _patches_3x3(_l2_normalize(feature_2))
    match_vol = torch.matmul(p1, p2.transpose(1, 2))          # [B, HW, HW]
    attn = torch.softmax(match_vol * softmax_scale, dim=2)
    idx = torch.arange(H * W, dtype=attn.dtype, device=attn.device)
    pos = torch.stack([idx % W, torch.div(idx, W, rounding_mode="floor")],
                      dim=1)                                   # [HW, 2]
    flow = torch.matmul(attn, pos) - pos[None]
    return flow.reshape(B, H, W, 2)
