"""Spatial and temporal motion, chunked (port of ``pipeline/motion.py``).

The nets run chunk by chunk, in two programs per chunk k: the spatial
motion of both views together with the temporal trunk's features of both
views (:meth:`MotionEstimator.motion_chunk`), and the temporal motions of
the chunk's frame pairs, both views in one batch [2c], so that each pair
chunk is one K1 launch at [2c, H/8, W/8, 128]
(:meth:`MotionEstimator.pair_chunk`). Pair chunk k holds the pairs (t,
t+1) of frame chunk k's frames t; its last frame pairs with the next
chunk's first (the one-frame halo) and the video's last frame with
itself, a motion that is dropped, as the JAX package's fused motion
program shifts its features.

Given a :class:`~stabstitch2_tpu_torch.utils.graphs.GraphCache` (the
stitcher's ``fused_motion``, the default), each program runs at the one
chunk shape, a short last chunk padded with its last frame and cropped
after (motion at t depends on frames <= t + 1 only, and the pad repeats
frame T - 1), through the cache: on a card a CUDA graph per program, shape
and replica, the counterpart of the ``lax.map`` body of the JAX package's
``_motion_fused``. Without one they run eagerly at the true chunk sizes.
Where T is a multiple of the chunk the two run the same kernels on the
same shapes.

The chunks are dealt over the replicas of the nets (one per device; N is
1 unless the stitcher was built with ``n_devices``), chunk k on replica k
mod N, and the motions are gathered on the first replica's device. Each
chunk runs at the shape and through the kernels it has on one device, so
N replicas give the motions of one bit for bit.

The bulk path hands over whole videos (:meth:`MotionEstimator.split`
deals them) or chunk lists; the stream upload (``pipeline/stitcher.py``) hands over chunk by chunk
(:meth:`MotionEstimator.motion_chunk`, then ``temporal_from_features``),
always eagerly. Both make the same calls on batches of the same
composition, so cuDNN picks the same algorithms and the two give the same
bits.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch

from stabstitch2_tpu_torch.models import SpatialNet, TemporalNet
from stabstitch2_tpu_torch.models.spatial import spatial_motions
from stabstitch2_tpu_torch.utils.graphs import GraphCache

# a video's frames: one tensor, or its chunks (each on its own device)
Frames = Union[torch.Tensor, List[torch.Tensor]]


def pad_to(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` [m, ...] padded to [n, ...] by repeating its last frame."""
    if x.shape[0] == n:
        return x
    return torch.cat([x, x[-1:].expand(n - x.shape[0], *x.shape[1:])], 0)


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

    def _run(self, name: str, k: int, program: Callable,
             graphs: Optional[GraphCache], *chunks: torch.Tensor):
        """``program(*chunks)`` of chunk ``k``: eagerly without ``graphs``;
        else at the chunk shape (padded, then cropped) through ``graphs``,
        keyed on chunk k's replica."""
        if graphs is None:
            return program(*chunks)
        n = chunks[0].shape[0]
        outs = graphs.run(name, program,
                          *(pad_to(x, self.chunk) for x in chunks),
                          modules=self.replicas[self.owner(k)])
        return tuple(o[:n] for o in outs)

    def motion_chunk(self, a: torch.Tensor, b: torch.Tensor, k: int = 0,
                     graphs: Optional[GraphCache] = None
                     ) -> Tuple[torch.Tensor, ...]:
        """Chunk ``k`` of both views: (motion1, motion2, features1,
        features2) on its replica's device, in one program."""
        return self._run("motion", k, lambda a, b: (
            *self.spatial_chunk(a, b, k), *self.features_chunk(a, b, k)),
            graphs, a, b)

    @torch.no_grad()
    def pair_chunk(self, p1: torch.Tensor, p2: torch.Tensor,
                   n1: torch.Tensor, n2: torch.Tensor, k: int = 0,
                   graphs: Optional[GraphCache] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Both views' temporal motions from features p* to n* (chunk
        ``k``'s pairs, on its replica's device), in one batch [2c]."""
        net = self.replicas[self.owner(k)][1]

        def program(p1, p2, n1, n2):
            m = net.motion_from_features(torch.cat([p1, p2], 0),
                                         torch.cat([n1, n2], 0))
            return m[:p1.shape[0]], m[p1.shape[0]:]

        return self._run("pair", k, program, graphs, p1, p2, n1, n2)

    def spatial(self, frames1: Frames, frames2: Frames
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Both views' spatial motions [T, GH+1, GW+1, 2] on the first
        device, from whole videos in [-1, 1] or their chunk lists."""
        m1, m2 = zip(*(self.spatial_chunk(a, b, k) for k, (a, b) in
                       enumerate(zip(self.split(frames1),
                                     self.split(frames2)))))
        return self.gather(m1), self.gather(m2)

    @torch.no_grad()
    def temporal_from_features(self, f1: Sequence[torch.Tensor],
                               f2: Sequence[torch.Tensor],
                               graphs: Optional[GraphCache] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Both views' temporal motions [T, GH+1, GW+1, 2], zeros at t = 0,
        on the first device, from their per-chunk features (chunk k on
        replica k's device): pair chunk k (:meth:`pair_chunk`) on frame
        chunk k's replica, its next features those of frames s+1..e, frame
        e the next chunk's first (the halo) or, at the video's end, the
        last frame again (that motion is dropped)."""
        T = sum(f.shape[0] for f in f1)
        m1, m2 = [], []
        for k in range(len(f1)):
            dev = f1[k].device

            def nxt(f):
                last = (f[k + 1][:1].to(dev, non_blocking=True)
                        if k + 1 < len(f) else f[k][-1:])
                return torch.cat([f[k][1:], last], 0)

            a, b = self.pair_chunk(f1[k], f2[k], nxt(f1), nxt(f2), k, graphs)
            m1.append(a)
            m2.append(b)
        zero = torch.zeros_like(m1[0][:1], device=self.devices[0])
        return self.gather([zero] + m1)[:T], self.gather([zero] + m2)[:T]

    def temporal_pair(self, frames1: Frames, frames2: Frames
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Both views' temporal motions [T, GH+1, GW+1, 2], zeros at t = 0."""
        f1, f2 = zip(*(self.features_chunk(a, b, k) for k, (a, b) in
                       enumerate(zip(self.split(frames1),
                                     self.split(frames2)))))
        return self.temporal_from_features(f1, f2)
