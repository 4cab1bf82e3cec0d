"""Spatial and temporal motion, chunked (port of ``pipeline/motion.py``).

PyTorch runs eagerly, so the chunks are plain slices: no padding to a
compiled shape and no fused program. The temporal net takes both views of
a chunk in one batch, as the JAX package's fused motion program does, so
each temporal chunk is one K1 launch at [2 * chunk, H/8, W/8, 128].

The nets run on a list of chunks, chunk k on replica k mod N of the nets
(one replica per device; N is 1 unless the stitcher was built with
``n_devices``), and the motions are gathered on the first replica's
device. Each chunk runs at the shape and through the kernels it has on
one device, so N replicas give the motions of one bit for bit. A
temporal pair chunk reads the next frame chunk's first features (the
one-frame halo), copied to its device.

The bulk path hands over whole videos (:meth:`MotionEstimator.split`
deals them) or chunk lists; the stream upload (``pipeline/stitcher.py``)
hands over chunk by chunk (:meth:`MotionEstimator.spatial_chunk`,
``features_chunk``, then ``temporal_from_features``). Both make the same
calls on batches of the same composition, so cuDNN picks the same
algorithms and the two give the same bits.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple, Union

import torch

from stabstitch2_tpu_torch.models import SpatialNet, TemporalNet
from stabstitch2_tpu_torch.models.spatial import spatial_motions

# a video's frames: one tensor, or its chunks (each on its own device)
Frames = Union[torch.Tensor, List[torch.Tensor]]


@dataclasses.dataclass
class MotionEstimator:
    """The two alignment nets, one replica per device, run chunk by chunk
    (inference only)."""

    replicas: Sequence[Tuple[SpatialNet, TemporalNet]]
    chunk: int = 8

    @property
    def devices(self) -> List[torch.device]:
        return [next(s.parameters()).device for s, _ in self.replicas]

    def chunks(self, n: int):
        for s in range(0, n, self.chunk):
            yield s, min(s + self.chunk, n)

    def owner(self, k: int) -> int:
        """The replica that runs chunk ``k``."""
        return k % len(self.replicas)

    def split(self, frames: Frames) -> List[torch.Tensor]:
        """``frames`` [T, ...] as the chunks the nets run on, chunk k on
        its replica's device (a chunk list passes as it is)."""
        if isinstance(frames, list):
            return frames
        devices = self.devices
        return [frames[s:e].to(devices[self.owner(k)], non_blocking=True)
                for k, (s, e) in enumerate(self.chunks(frames.shape[0]))]

    def views(self, parts: Sequence[torch.Tensor], T: int
              ) -> List[torch.Tensor]:
        """The chunks of a T-frame video from one tensor per replica, each
        holding that replica's chunks in order (what a dealt upload
        makes): chunk k is part k mod N at (k // N) * chunk."""
        n = len(self.replicas)
        return [parts[k % n][(k // n) * self.chunk:][:e - s]
                for k, (s, e) in enumerate(self.chunks(T))]

    def gather(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        """Per-chunk results, concatenated on the first device."""
        first = self.devices[0]
        return torch.cat([x.to(first, non_blocking=True) for x in xs], 0)

    @torch.no_grad()
    def spatial_chunk(self, a: torch.Tensor, b: torch.Tensor, k: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Chunk ``k`` of both views [c, H, W, 3] in [-1, 1], on its
        replica's device: (motion1, motion2) there."""
        net = self.replicas[self.owner(k)][0]
        off1, mref, mtgt = net(a, b)
        out = spatial_motions(off1, mref, mtgt, a.shape[1], a.shape[2])
        return out["motion1"], out["motion2"]

    @torch.no_grad()
    def features_chunk(self, a: torch.Tensor, b: torch.Tensor, k: int = 0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The temporal trunk's features of chunk ``k`` of both views, in
        one batch [2c]: (features1, features2) on its replica's device."""
        net = self.replicas[self.owner(k)][1]
        f = net.features(torch.cat([a, b], 0))
        return f[:a.shape[0]], f[a.shape[0]:]

    def spatial(self, frames1: Frames, frames2: Frames
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Both views' spatial motions [T, GH+1, GW+1, 2] on the first
        device, from whole videos in [-1, 1] or their chunk lists."""
        m1, m2 = zip(*(self.spatial_chunk(a, b, k) for k, (a, b) in
                       enumerate(zip(self.split(frames1),
                                     self.split(frames2)))))
        return self.gather(m1), self.gather(m2)

    def features(self, frames1: Frames, frames2: Frames
                 ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """Both views' temporal features, one per chunk on its device."""
        f1, f2 = zip(*(self.features_chunk(a, b, k) for k, (a, b) in
                       enumerate(zip(self.split(frames1),
                                     self.split(frames2)))))
        return list(f1), list(f2)

    @torch.no_grad()
    def temporal_from_features(self, f1: Sequence[torch.Tensor],
                               f2: Sequence[torch.Tensor]
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Both views' temporal motions [T, GH+1, GW+1, 2], zeros at t = 0,
        on the first device, from their per-chunk features (chunk k on
        replica k's device). Pair chunk k (frames s..e-1 against s+1..e)
        runs on frame chunk k's replica, both views in one batch; frame e
        is the next chunk's first (the halo)."""
        T = sum(f.shape[0] for f in f1)
        m1, m2 = [], []
        for k, (s, e) in enumerate(self.chunks(T - 1)):
            n, dev = e - s, f1[k].device

            def nxt(f):
                x = f[k][1:n + 1]
                if x.shape[0] < n:
                    x = torch.cat([x, f[k + 1][:n - x.shape[0]].to(
                        dev, non_blocking=True)], 0)
                return x

            net = self.replicas[self.owner(k)][1]
            m = net.motion_from_features(torch.cat([f1[k][:n], f2[k][:n]], 0),
                                         torch.cat([nxt(f1), nxt(f2)], 0))
            m1.append(m[:n])
            m2.append(m[n:])
        zero = torch.zeros_like(m1[0][:1], device=self.devices[0])
        return self.gather([zero] + m1), self.gather([zero] + m2)

    def temporal_pair(self, frames1: Frames, frames2: Frames
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Both views' temporal motions [T, GH+1, GW+1, 2], zeros at t = 0."""
        return self.temporal_from_features(*self.features(frames1, frames2))
