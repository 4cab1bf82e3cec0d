"""Streaming two-view stitcher (port of ``pipeline/online.py``).

Push one synchronized frame pair at a time; stabilized panoramas come out
with a latency of ``window - 1`` frames:

- each push runs one step on that pair (:meth:`OnlineStitcher._step`,
  the port of the JAX package's fused ``_step``): the I420 unpack, the
  model input, ``SpatialNet`` on the pair, ``TemporalNet.features`` on
  both views with the previous push's features kept, the temporal motion
  (K1), the transport into the stitched frame (zero on the stream's first
  frame, chosen on the device by ``torch.where`` from a flag), the
  window's roll buffers and ``SmoothNet`` on the one window. The stream's
  state (features, motion, buffers, flag) lives in tensors that the step
  updates in place (the JAX step returns new ones). With the stitcher's
  ``fused_motion`` (the default) the step goes through a
  ``utils/graphs.py:GraphCache`` of its own: on a card one CUDA graph per
  input shape and format, captured at the first push and replayed by one
  launch at every later one (on the CPU the step runs directly);
  ``fused_motion=False`` runs it eagerly. The composite and its one fetch
  stay outside, as the JAX package's "plus one composite dispatch" does;
- nothing is emitted for the first ``window - 1`` pushes; the push that
  fills the window composites all of its frames in one batch, and every
  later push composites the window's last frame;
- the canvas is causal: sized from the first window's meshes times a
  margin, and re-anchored when the content leaves it (a pan moves the
  anchor and keeps the size; growth makes a new canvas). This is the one
  deliberate deviation from the reference, whose offline script sizes the
  canvas from every frame's meshes.

The composite takes the batch compositor's routes
(``pipeline/compositor.py``): K2 by default, K3 and K4 with
``fused_warp=False``. A push enqueues the composite together with the
meshes' extent, copies both into page-locked buffers without blocking, and
waits for the card once; only a batch whose content left the canvas is
composited again after re-anchoring. A canvas past the compositor's cap
for the frames' size (``compositor.canvas_cap``) raises. Under a profiler
a push is the ``push`` span, around its ``upload`` (the pair's ``stage``
copy into one page-locked buffer and the copy to the card), ``composite`` (the
composite's enqueue and the copies of its planes to the host; the
``emit_bytes`` counter adds the panorama bytes fetched), ``wait`` and
``pack`` spans (``utils/profiling.py``). The TPU package's overflow repair is
not ported: the card's gathers cannot overflow.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from stabstitch2_tpu_torch.data.video_io import pack_i420_host
from stabstitch2_tpu_torch.models.smooth import smooth_outputs
from stabstitch2_tpu_torch.models.spatial import spatial_motions
from stabstitch2_tpu_torch.ops.mesh import rigid_mesh
from stabstitch2_tpu_torch.ops.yuv import bgr_u8_to_yuv420, unpack_i420_u8
from stabstitch2_tpu_torch.pipeline.compositor import (Canvas, canvas_cap,
                                                       chains_yuv420,
                                                       check_canvas,
                                                       composite_chunk,
                                                       copy_to_host, fetch,
                                                       fused_route,
                                                       host_buffer,
                                                       record_event,
                                                       scale_meshes, wait)
from stabstitch2_tpu_torch.pipeline.stitcher import model_input
from stabstitch2_tpu_torch.pipeline.transport import transport
from stabstitch2_tpu_torch.utils.graphs import GraphCache
from stabstitch2_tpu_torch.utils.profiling import annotate, count
from stabstitch2_tpu_torch.utils.transfer import constant, pinned_frames


def check_frame(name: str, h: np.ndarray) -> None:
    """A pushed frame must be BGR [H, W, 3] or packed I420 [H*3//2, W]
    with H and W even."""
    if h.ndim == 2:
        H15, W = h.shape
        if H15 % 3 or (H15 * 2 // 3) % 2 or W % 2:
            raise ValueError(
                f"{name} shape {h.shape} is not packed I420: need "
                f"[H*3//2, W] with H and W even; BGR frames must be "
                f"[H, W, 3]")
    elif h.ndim != 3 or h.shape[-1] != 3:
        raise ValueError(f"{name} shape {h.shape}: expected [H, W, 3] uint8 "
                         f"BGR or packed I420 [H*3//2, W]")


class OnlineStitcher:
    """Streaming two-view stitcher with a ``window - 1`` frame latency.

    ``emit_format`` 'bgr' returns uint8 [oh, ow, 3] frames; 'i420' packed
    4:2:0 [oh*3//2, ow] (even sizes), half the bytes off the card.
    """

    def __init__(self, stitcher, canvas_margin: float = 1.25,
                 emit_format: str = "bgr"):
        if emit_format not in ("bgr", "i420"):
            raise ValueError(f"unknown emit_format {emit_format!r}")
        self.s = stitcher
        self.cfg = stitcher.config
        self.device = stitcher.device
        self.canvas_margin = canvas_margin
        self.emit_format = emit_format
        self._fused = fused_route(self.cfg)
        self._chain_yuv = chains_yuv420(
            self.cfg, "yuv420" if emit_format == "i420" else "bgr")
        self.mh, self.mw = stitcher.model_h, stitcher.model_w
        self._rigid = rigid_mesh(self.mh, self.mw, device=self.device)
        # the stream's state, updated in place by the step (a captured
        # step reads and writes these very tensors): the previous push's
        # features (the trunk's output [2, ceil(mh/8), ceil(mw/8), 128] in
        # its compute dtype; each stride-2 stage halves with a ceil) and
        # spatial motions, the roll buffers [view, window, GH+1, GW+1, 2]
        # and the first-frame flag
        dev, mesh = self.device, self._rigid.shape
        self._prev_feat = torch.zeros(
            (2, -(-self.mh // 8), -(-self.mw // 8), 128), device=dev,
            dtype=stitcher.temporal_net.feature_extractor_stage1.compute_dtype)
        self._prev_smotion = torch.zeros((2, *mesh), device=dev)
        self._buf_smesh = torch.zeros((2, self.cfg.window, *mesh), device=dev)
        self._buf_ts = torch.zeros_like(self._buf_smesh)
        self._first = torch.zeros((), dtype=torch.bool, device=dev)
        self.graphs = GraphCache() if stitcher.fused_motion else None
        # host waits for the card (each on an event after page-locked
        # copies); a push in steady state makes one
        self.waits = 0
        self.reset()

    def reset(self) -> None:
        """Forget the stream: the next push is its first frame."""
        self._t = 0
        for state in (self._prev_feat, self._prev_smotion, self._buf_smesh,
                      self._buf_ts):
            state.zero_()
        self._pending: List[torch.Tensor] = []   # device BGR pairs
        self.canvas: Optional[Canvas] = None
        self._offset: Optional[torch.Tensor] = None
        # the current window's smooth meshes (view 1, view 2), each
        # [window, GH+1, GW+1, 2] at model resolution; None until the
        # window is full
        self.window_smooth = None
        # pushes (0-based) at which the canvas was re-anchored
        self.reanchor_frames: List[int] = []

    # -- canvas ------------------------------------------------------------

    def _establish_canvas(self, ext: np.ndarray, cap=None) -> None:
        """A canvas around the extent (x_min, x_max, y_min, y_max) times
        the margin, padded to the bucket; even sizes for i420. Raises past
        ``cap`` (padded height, width), where given."""
        cx = (ext[0] + ext[1]) / 2.0
        cy = (ext[2] + ext[3]) / 2.0
        half_w = (ext[1] - ext[0]) / 2.0 * self.canvas_margin
        half_h = (ext[3] - ext[2]) / 2.0 * self.canvas_margin
        bucket = self.cfg.canvas_bucket
        out_w = int(np.ceil(2 * half_w))
        out_h = int(np.ceil(2 * half_h))
        if self.emit_format == "i420":
            # 4:2:0 needs even sizes: round up, so the canvas describes
            # the emitted frames and no content is cropped
            out_w += out_w % 2
            out_h += out_h % 2
        canvas = Canvas(out_h=out_h, out_w=out_w,
                        pad_h=-(-out_h // bucket) * bucket,
                        pad_w=-(-out_w // bucket) * bucket,
                        x_min=float(cx - half_w), y_min=float(cy - half_h))
        if cap is not None:
            check_canvas(canvas, cap)
        self._set_canvas(canvas)

    def _set_canvas(self, canvas: Canvas) -> None:
        self.canvas = canvas
        self._offset = constant([canvas.x_min, canvas.y_min], torch.float32,
                                self.device)

    def _reanchor(self, ext: np.ndarray, cap=None) -> None:
        """The content left the canvas: centre on it. If it still fits the
        canvas's size only the anchor moves (same padded shape); else a
        larger canvas is made (no larger than ``cap``)."""
        c = self.canvas
        need_w = (ext[1] - ext[0]) * self.canvas_margin
        need_h = (ext[3] - ext[2]) * self.canvas_margin
        if need_w <= c.out_w and need_h <= c.out_h:
            cx = (ext[0] + ext[1]) / 2.0
            cy = (ext[2] + ext[3]) / 2.0
            self._set_canvas(Canvas(out_h=c.out_h, out_w=c.out_w,
                                    pad_h=c.pad_h, pad_w=c.pad_w,
                                    x_min=float(cx - c.out_w / 2.0),
                                    y_min=float(cy - c.out_h / 2.0)))
        else:
            self._establish_canvas(ext, cap)
        self.reanchor_frames.append(self._t)

    def _ext_fits(self, ext: np.ndarray) -> bool:
        c = self.canvas
        return bool(ext[0] >= c.x_min and ext[1] <= c.x_min + c.out_w
                    and ext[2] >= c.y_min and ext[3] <= c.y_min + c.out_h)

    # -- composite ---------------------------------------------------------

    def _fetch(self, tensors) -> List[torch.Tensor]:
        """The compositor's one-wait fetch, counted in ``waits``."""
        self.waits += 1
        return fetch(tensors, self.device)

    def _wait(self) -> None:
        """Wait for the card past everything enqueued (one event), counted
        in ``waits``."""
        self.waits += 1
        wait(record_event(self.device))

    def _enqueue_fetch(self, h1s, h2s, m1, m2, extra=()
                       ) -> List[torch.Tensor]:
        """One batch's composite and the copies of its planes (then of
        ``extra`` tensors) into page-locked host buffers, which it returns
        (valid after :meth:`_wait`); the planes' bytes go to the
        ``emit_bytes`` counter."""
        planes = self._enqueue_composite(h1s, h2s, m1, m2)
        count("emit_bytes", sum(p.numel() * p.element_size() for p in planes))
        tensors = planes + list(extra)
        host = [host_buffer(t.shape, t.dtype, self.device) for t in tensors]
        copy_to_host(host, tensors)
        return host

    def _enqueue_composite(self, h1s, h2s, m1, m2) -> List[torch.Tensor]:
        """One batch's composite against the current canvas, cropped to
        the emitted size: the device planes (Y, U, V or BGR)."""
        c = self.canvas
        fmt = ("yuv420" if self.emit_format == "i420" and not self._chain_yuv
               else "bgr")
        out = composite_chunk(h1s, h2s, m1, m2, self._offset,
                              (c.pad_h, c.pad_w), self.cfg.fusion_mode,
                              (np.float32(c.out_h), np.float32(c.out_w)),
                              warp_mode=self.cfg.warp_mode, out_format=fmt,
                              coord_stride=self.cfg.coord_stride,
                              fused_warp=self._fused)
        if self._chain_yuv:
            out = bgr_u8_to_yuv420(out)
        oh, ow = c.out_h, c.out_w
        if self.emit_format == "i420":
            y, u, v = out
            return [y[:, :oh, :ow], u[:, :oh // 2, :ow // 2],
                    v[:, :oh // 2, :ow // 2]]
        return [out[:, :oh, :ow]]

    def _composite_many(self, h1s: torch.Tensor, h2s: torch.Tensor,
                        meshes1: torch.Tensor, meshes2: torch.Tensor
                        ) -> List[np.ndarray]:
        """Composite a batch: h*s [B, H, W, 3] uint8 on the device,
        meshes* [B, GH+1, GW+1, 2] at model resolution. Enqueued against
        the current anchor; the meshes' extent comes back with the frames
        in one wait, and only content that left the canvas re-anchors and
        composites the batch again."""
        B, H, W = h1s.shape[:3]
        cap = canvas_cap(self.cfg, (H, W), (self.mh, self.mw))
        with annotate("composite"):
            m1 = scale_meshes(meshes1, H, W, self.mh, self.mw)
            m2 = scale_meshes(meshes2, H, W, self.mh, self.mw)
            m = torch.stack([m1, m2])
            ext = torch.stack([m[..., 0].amin(), m[..., 0].amax(),
                               m[..., 1].amin(), m[..., 1].amax()])
            if self.canvas is None:
                self._establish_canvas(self._fetch([ext])[0].numpy(), cap)
            *planes, ext_h = self._enqueue_fetch(h1s, h2s, m1, m2, [ext])
        self._wait()
        ext_h = ext_h.numpy()
        if not self._ext_fits(ext_h):
            self._reanchor(ext_h, cap)
            with annotate("composite"):
                planes = self._enqueue_fetch(h1s, h2s, m1, m2)
            self._wait()
        with annotate("pack"):
            planes = [p.numpy() for p in planes]
            if self.emit_format == "i420":
                return [pack_i420_host(*(p[i] for p in planes))
                        for i in range(B)]
            return list(planes[0])

    # -- the stream ----------------------------------------------------------

    def _step(self, frames: torch.Tensor):
        """One push's motion and smoothing on the device, the port of the
        JAX package's ``_step``: ``frames`` [2, H, W, 3] BGR or packed I420
        [2, H*3//2, W] uint8 -> (the BGR pair, the window's smooth meshes of
        view 1 and view 2 [window, GH+1, GW+1, 2]); the state tensors are
        updated in place. Reads nothing from the host, so that it can be
        captured: the first frame's zero trajectory is a ``torch.where`` on
        the device flag ``_first``."""
        s, mh, mw = self.s, self.mh, self.mw
        pair = unpack_i420_u8(frames) if frames.dim() == 3 else frames
        lo = model_input(pair, mh, mw)
        off, mref, mtgt = s.spatial_net(lo[0:1], lo[1:2])
        sp = spatial_motions(off, mref, mtgt, mh, mw)
        smotion = torch.cat([sp["motion1"], sp["motion2"]])   # [view, ...]
        feat = s.temporal_net.features(lo)
        tmotion = s.temporal_net.motion_from_features(self._prev_feat, feat)
        # the first frame has no predecessor: its trajectory is zero (the
        # transport runs anyway, from the rigid mesh, as in the JAX step)
        ts = torch.where(self._first, 0.0,
                         transport(tmotion, self._prev_smotion, smotion,
                                   mh, mw))
        self._prev_feat.copy_(feat)
        self._prev_smotion.copy_(smotion)
        self._buf_smesh.copy_(torch.cat(
            [self._buf_smesh[:, 1:], (self._rigid + smotion)[:, None]], 1))
        self._buf_ts.copy_(torch.cat([self._buf_ts[:, 1:], ts[:, None]], 1))
        # each window's first trajectory is zero (it re-bases there)
        ts_w = self._buf_ts.clone()
        ts_w[:, 0] = 0.0
        d = smooth_outputs(s.smooth_net(self._buf_smesh[0:1],
                                        self._buf_smesh[1:2],
                                        ts_w[0:1], ts_w[1:2]))
        return pair, d["smooth_mesh1"][0], d["smooth_mesh2"][0]

    @torch.no_grad()
    def push(self, hi1: np.ndarray, hi2: np.ndarray) -> List[np.ndarray]:
        """Feed one synchronized frame pair; returns the panoramas that
        became available (none, the whole first window, or one).

        Frames are uint8 BGR [H, W, 3] or packed I420 [H*3//2, W]; each
        crosses to the card once and the composite reads that copy.
        """
        with annotate("push"):
            return self._push(hi1, hi2)

    def _push(self, hi1: np.ndarray, hi2: np.ndarray) -> List[np.ndarray]:
        check_frame("hi1", hi1)
        check_frame("hi2", hi2)
        s = self.s
        with annotate("upload"):
            frames = pinned_frames([hi1, hi2], self.device).to(
                self.device, non_blocking=True)
        self._first.fill_(self._t == 0)
        if self.graphs is None:
            pair, sm1w, sm2w = self._step(frames)
        else:
            pair, sm1w, sm2w = self.graphs.run(
                "online_step", self._step, frames,
                modules=(s.spatial_net, s.temporal_net, s.smooth_net))
        self._pending.append(pair)
        self._t += 1
        window = self.cfg.window
        if self._t < window:
            return []
        self.window_smooth = (sm1w, sm2w)
        if self._t == window:       # the first window, in one batch
            pairs = torch.stack(self._pending)
            outs = self._composite_many(pairs[:, 0], pairs[:, 1], sm1w, sm2w)
        else:                       # the window's last frame
            outs = self._composite_many(pair[0:1], pair[1:2], sm1w[-1:],
                                        sm2w[-1:])
        self._pending = []
        return outs
