"""Spatial and temporal motion, chunked (port of ``pipeline/motion.py``).

PyTorch runs eagerly, so the chunks are plain slices: no padding to a
compiled shape and no fused program. The temporal net takes both views of
a chunk in one batch, as the JAX package's fused motion program does, so
each temporal chunk is one K1 launch at [2 * chunk, H/8, W/8, 128].
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from stabstitch2_tpu_torch.models import SpatialNet, TemporalNet
from stabstitch2_tpu_torch.models.spatial import spatial_motions


@dataclasses.dataclass
class MotionEstimator:
    """The two alignment nets, run chunk by chunk (inference only)."""

    spatial_net: SpatialNet
    temporal_net: TemporalNet
    chunk: int = 8

    def _chunks(self, n: int):
        for s in range(0, n, self.chunk):
            yield s, min(s + self.chunk, n)

    @torch.no_grad()
    def spatial(self, frames1: torch.Tensor, frames2: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """frames*: [T, H, W, 3] in [-1, 1]. Returns (motion1, motion2)."""
        m1, m2 = [], []
        for s, e in self._chunks(frames1.shape[0]):
            a, b = frames1[s:e], frames2[s:e]
            off1, mref, mtgt = self.spatial_net(a, b)
            out = spatial_motions(off1, mref, mtgt, a.shape[1], a.shape[2])
            m1.append(out["motion1"])
            m2.append(out["motion2"])
        return torch.cat(m1, 0), torch.cat(m2, 0)

    @torch.no_grad()
    def temporal_pair(self, frames1: torch.Tensor, frames2: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Both views' temporal motions [T, GH+1, GW+1, 2], zeros at t = 0."""
        T = frames1.shape[0]
        f1, f2 = [], []
        for s, e in self._chunks(T):
            f = self.temporal_net.features(torch.cat([frames1[s:e],
                                                      frames2[s:e]], 0))
            f1.append(f[:e - s])
            f2.append(f[e - s:])
        f1, f2 = torch.cat(f1, 0), torch.cat(f2, 0)
        m1, m2 = [], []
        for s, e in self._chunks(T - 1):
            prev = torch.cat([f1[s:e], f2[s:e]], 0)
            nxt = torch.cat([f1[s + 1:e + 1], f2[s + 1:e + 1]], 0)
            m = self.temporal_net.motion_from_features(prev, nxt)
            m1.append(m[:e - s])
            m2.append(m[e - s:])
        zero = torch.zeros_like(m1[0][:1])
        return torch.cat([zero] + m1, 0), torch.cat([zero] + m2, 0)

