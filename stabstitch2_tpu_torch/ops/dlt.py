"""Batched 4-point Direct Linear Transform (port of ``ops/dlt.py``)."""

from __future__ import annotations

import torch


def solve_dlt(src_p: torch.Tensor, dst_p: torch.Tensor) -> torch.Tensor:
    """Homography mapping 4 source points onto 4 targets.

    src_p, dst_p: [B, 4, 2]. Returns H: [B, 3, 3] with H[2, 2] == 1. Rows
    2i / 2i+1 of the 8x8 system are ``[x y 1 0 0 0 -x*x' -y*x']`` and
    ``[0 0 0 x y 1 -x*y' -y*y']``, as in the reference.
    """
    B = src_p.shape[0]
    kw = dict(dtype=src_p.dtype, device=src_p.device)
    xy1 = torch.cat([src_p, torch.ones(B, 4, 1, **kw)], dim=2)     # [B,4,3]
    zeros = torch.zeros(B, 4, 3, **kw)
    row_even = torch.cat([xy1, zeros], dim=2)                       # [B,4,6]
    row_odd = torch.cat([zeros, xy1], dim=2)
    M1 = torch.stack([row_even, row_odd], dim=2).reshape(B, 8, 6)
    M2 = torch.einsum("bpi,bpj->bpij", dst_p, src_p).reshape(B, 8, 2)
    A = torch.cat([M1, -M2], dim=2)                                 # [B,8,8]
    h8 = torch.linalg.solve_ex(A, dst_p.reshape(B, 8, 1)).result.reshape(B, 8)
    return torch.cat([h8, torch.ones(B, 1, **kw)], dim=1).reshape(B, 3, 3)
