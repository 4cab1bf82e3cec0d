"""SmoothWarp network: joint two-view smoothing (port of ``models/smooth.py``).

Inputs per view are [B, T, GH+1, GW+1, 2]: the stitched meshes and the
transported temporal motions, which are cumsummed into paths. Parameter
names follow the reference's ``MotionPre`` (its unused ``embedding2`` is
left out).

``compute_dtype`` (float32 by default, as ``init_stitcher`` keeps it)
casts the inputs of the embeddings, runs the linear and Conv3D layers in
it and returns the deltas in float32, as the JAX package's
``SmoothNet(dtype=...)``.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from stabstitch2_tpu_torch.models.backbone import Conv3d, Linear


class MotionPrediction(nn.Module):
    """Embed -> Conv3D x3 -> decode."""

    def __init__(self, kernel_t: int = 5,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        pad = (kernel_t // 2, 1, 1)
        self.embedding1 = nn.Sequential(Linear(2, 32), nn.ReLU())
        self.embedding3 = nn.Sequential(Linear(2, 32), nn.ReLU())
        self.MotionConv3D = nn.Sequential(
            Conv3d(128, 128, (kernel_t, 3, 3), padding=pad), nn.ReLU(),
            Conv3d(128, 128, (kernel_t, 3, 3), padding=pad), nn.ReLU(),
            Conv3d(128, 128, (kernel_t, 3, 3), padding=pad), nn.ReLU())
        self.decoding = nn.Sequential(Linear(128, 4))
        self.compute_dtype = compute_dtype

    def forward(self, smesh1, smesh2, tsflow1, tsflow2):
        smesh1, smesh2, tsflow1, tsflow2 = (
            x.to(self.compute_dtype) for x in (smesh1, smesh2, tsflow1, tsflow2))
        h1 = torch.cat([self.embedding1(smesh1), self.embedding3(tsflow1)], -1)
        h2 = torch.cat([self.embedding1(smesh2), self.embedding3(tsflow2)], -1)
        h = torch.cat([h1, h2], -1).permute(0, 4, 1, 2, 3)   # [B, 128, T, H, W]
        h = self.MotionConv3D(h).permute(0, 2, 3, 4, 1)
        return self.decoding(h).float()                     # [B, T, H, W, 4]


class SmoothNet(nn.Module):
    """Returns (smesh1, smesh2, ori_path1, ori_path2, delta1, delta2)."""

    def __init__(self, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.MotionPre = MotionPrediction(compute_dtype=compute_dtype)

    def forward(self, smesh1, smesh2, tsmotion1, tsmotion2
                ) -> Tuple[torch.Tensor, ...]:
        tsflow1 = torch.cumsum(tsmotion1, dim=1)
        tsflow2 = torch.cumsum(tsmotion2, dim=1)
        delta = self.MotionPre(smesh1, smesh2, tsflow1, tsflow2)
        return smesh1, smesh2, tsflow1, tsflow2, delta[..., 0:2], delta[..., 2:4]


def smooth_outputs(net_outputs) -> dict:
    """smooth_path = ori_path + delta; smooth_mesh = ori_mesh - delta."""
    smesh1, smesh2, path1, path2, d1, d2 = net_outputs
    return {
        "ori_mesh1": smesh1, "ori_mesh2": smesh2,
        "ori_path1": path1, "ori_path2": path2,
        "smooth_path1": path1 + d1, "smooth_path2": path2 + d2,
        "smooth_mesh1": smesh1 - d1, "smooth_mesh2": smesh2 - d2,
    }
