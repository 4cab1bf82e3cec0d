"""Spatial and temporal motion, chunked (port of ``pipeline/motion.py``).

PyTorch runs eagerly, so the chunks are plain slices: no padding to a
compiled shape and no fused program. The temporal net takes both views of
a chunk in one batch, as the JAX package's fused motion program does, so
each temporal chunk is one K1 launch at [2 * chunk, H/8, W/8, 128].

The bulk path (:meth:`MotionEstimator.spatial`, ``temporal_pair``) slices
whole videos into chunks; the stream upload
(``pipeline/stitcher.py``) hands over chunk by chunk
(:meth:`MotionEstimator.spatial_chunk`, ``features_chunk``, then
``temporal_from_features``). Both make the same calls on batches of the
same composition, so cuDNN picks the same algorithms and the two give
the same bits.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch

from stabstitch2_tpu_torch.models import SpatialNet, TemporalNet
from stabstitch2_tpu_torch.models.spatial import spatial_motions


@dataclasses.dataclass
class MotionEstimator:
    """The two alignment nets, run chunk by chunk (inference only)."""

    spatial_net: SpatialNet
    temporal_net: TemporalNet
    chunk: int = 8

    def chunks(self, n: int):
        for s in range(0, n, self.chunk):
            yield s, min(s + self.chunk, n)

    def split(self, frames: torch.Tensor) -> List[torch.Tensor]:
        """``frames`` [T, ...] as the chunk slices the nets run on."""
        return [frames[s:e] for s, e in self.chunks(frames.shape[0])]

    @torch.no_grad()
    def spatial_chunk(self, a: torch.Tensor, b: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One chunk of both views [c, H, W, 3] in [-1, 1]: (motion1,
        motion2)."""
        off1, mref, mtgt = self.spatial_net(a, b)
        out = spatial_motions(off1, mref, mtgt, a.shape[1], a.shape[2])
        return out["motion1"], out["motion2"]

    @torch.no_grad()
    def features_chunk(self, a: torch.Tensor, b: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The temporal trunk's features of one chunk of both views, in one
        batch [2c]: (features1, features2)."""
        f = self.temporal_net.features(torch.cat([a, b], 0))
        return f[:a.shape[0]], f[a.shape[0]:]

    def spatial_chunks(self, chunks1: Sequence[torch.Tensor],
                       chunks2: Sequence[torch.Tensor]
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Both views' spatial motions [T, GH+1, GW+1, 2] from their chunk
        lists (:meth:`spatial_chunk` on each pair of chunks)."""
        m1, m2 = zip(*(self.spatial_chunk(a, b)
                       for a, b in zip(chunks1, chunks2)))
        return torch.cat(m1, 0), torch.cat(m2, 0)

    def features_chunks(self, chunks1: Sequence[torch.Tensor],
                        chunks2: Sequence[torch.Tensor]
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Both views' temporal features [T, ...] from their chunk lists
        (:meth:`features_chunk` on each pair of chunks)."""
        f1, f2 = zip(*(self.features_chunk(a, b)
                       for a, b in zip(chunks1, chunks2)))
        return torch.cat(f1, 0), torch.cat(f2, 0)

    @torch.no_grad()
    def temporal_from_features(self, f1: torch.Tensor, f2: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Both views' temporal motions [T, GH+1, GW+1, 2], zeros at t = 0,
        from their features; both views of a chunk in one batch."""
        T = f1.shape[0]
        m1, m2 = [], []
        for s, e in self.chunks(T - 1):
            prev = torch.cat([f1[s:e], f2[s:e]], 0)
            nxt = torch.cat([f1[s + 1:e + 1], f2[s + 1:e + 1]], 0)
            m = self.temporal_net.motion_from_features(prev, nxt)
            m1.append(m[:e - s])
            m2.append(m[e - s:])
        zero = torch.zeros_like(m1[0][:1])
        return torch.cat([zero] + m1, 0), torch.cat([zero] + m2, 0)

    def spatial(self, frames1: torch.Tensor, frames2: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """frames*: [T, H, W, 3] in [-1, 1]. Returns (motion1, motion2)."""
        return self.spatial_chunks(self.split(frames1), self.split(frames2))

    def temporal_pair(self, frames1: torch.Tensor, frames2: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Both views' temporal motions [T, GH+1, GW+1, 2], zeros at t = 0."""
        return self.temporal_from_features(*self.features_chunks(
            self.split(frames1), self.split(frames2)))
