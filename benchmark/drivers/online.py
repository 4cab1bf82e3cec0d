"""Online two-view stitching: one live stream, closed loop. Each frame pair
is pushed into ``OnlineStitcher.push`` (the stitcher the CLI builds, BGR
in and out) as soon as the previous push returns; a steady push replays
the captured step and composites the window's last frame (B = 1).

Traffic (the mix): a continuous camera path of ``path_frames`` frame
pairs made from the seed, played forward, backward, forward... so the
motion never jumps. The first window's burst (the ``window``-th push
composites all its frames) and ``warm_pushes`` steady pushes are set-up.

End to end: ``push_p95_ms``, the 95th percentile of the host time
around every push of the window, failed ones included: the stutter a
live rig feels. Spans: the same host times, whose median, 98th
percentile and mean (the window's seconds over its pushes) are per-layer
metrics. The profiled slice (``--trace 1``) is ``slice_pushes`` more
pushes after the window.

``correct``: pushes sampled from the seed; for each, the reference works
the smooth meshes of the window that ends at that push out from the
same seven frame pairs and weights (``mesh_gap_px``, against the
program's ``window_smooth``, every frame of the window: the stream's
state is in them), the program's meshes of the pushed frame must lie
inside the program's canvas (``canvas_outside_px``), and the reference
composites them onto that canvas, the judge of the emitted panorama
(``frame_gap``).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from benchmark.lib import compare, lower, program
from benchmark.lib.sampling import Reservoir, stream_seed
from benchmark.lib.trace import Slice
from benchmark.lib.weights import for_run
from benchmark.reference import nets as N
from benchmark.reference import pipeline as R
from benchmark.traffic import clips


# the online stitcher's canvas margin around its first window's content
MARGIN = 1.25


# what control.py puts in the program's place
CONTROL = lower.DESCRIPTION


def make_path(cfg: dict, mix: dict, seed: int):
    """The stream's camera path: both views' frames, from the seed."""
    return clips.make_clip(2, mix["path_frames"], cfg["frame_h"],
                           cfg["frame_w"], mix["overlap"], mix["shake_px"],
                           stream_seed(seed, 0))


class Driver:
    def __init__(self, run):
        self.run = run
        self.cfg, self.mix = run.cfg, run.mix

    def setup(self):
        from stabstitch2_tpu_torch.pipeline.online import OnlineStitcher

        run, cfg, mix = self.run, self.cfg, self.mix
        self.weights = for_run(run)
        self.st = program.stitcher(cfg, self.weights, run.device)
        self.online = OnlineStitcher(self.st, emit_format="bgr")
        self.path = make_path(cfg, mix, run.seed)
        self.sample = Reservoir(mix["check_pushes"],
                                np.random.default_rng([run.seed, 1]))
        self.pushes = 0
        for _ in range(cfg["window"] + mix["warm_pushes"]):
            self.push()

    def frame(self, i):
        j = clips.bounce(i, self.mix["path_frames"])
        return self.path[0][j], self.path[1][j]

    def push(self):
        out = self.online.push(*self.frame(self.pushes))
        self.pushes += 1
        return out

    def window(self, seconds):
        lat, pads, failed = [], [], 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            p = self.pushes
            a = time.perf_counter()
            try:
                out = self.push()
            except Exception as e:  # noqa: BLE001 - counted and reported
                lat.append((time.perf_counter() - a) * 1e3)
                print(f"push {p} failed: {type(e).__name__}: {e}",
                      file=sys.stderr)
                failed += 1
                self.pushes = p + 1
                continue
            lat.append((time.perf_counter() - a) * 1e3)
            pads.append((self.online.canvas.pad_h, self.online.canvas.pad_w))
            if len(out) != 1:
                failed += 1
                continue
            o = self.online
            self.sample.offer(lambda: {
                "push": p, "frame": np.array(out[0]),
                "canvas": program.canvas_fields(o.canvas),
                "mesh1": o.window_smooth[0], "mesh2": o.window_smooth[1]})
        window_s = time.perf_counter() - t0
        run = self.run
        run.attempted, run.failed = len(lat), failed
        run.end_to_end["push_p95_ms"] = float(np.percentile(lat, 95))
        q = np.array_split(np.array(lat), 4)
        print("push p50 / p95 ms by quarter of the window:",
              [[round(float(np.percentile(x, p)), 3) for p in (50, 95)]
               for x in q], file=sys.stderr)
        run.layer.update(window_s=window_s, push_ms=lat, pads=pads)

    def traced_slice(self):
        pads = []
        with Slice() as s:
            for _ in range(self.mix["slice_pushes"]):
                self.push()
                pads.append((self.online.canvas.pad_h,
                             self.online.canvas.pad_w))
        if s.summary is not None:
            s.summary.units = len(pads)
            s.summary.notes["pads"] = pads
        return s.summary

    def release(self):
        del self.online, self.st

    def check(self):
        return check(self.run, self.path, self.sample.items, self.weights)


def window_views(cfg: dict, mix: dict, path, push: int, dev):
    """The window of frame pairs that ends at push ``push`` [window, H, W,
    3], both views, on ``dev``."""
    idx = [clips.bounce(i, mix["path_frames"])
           for i in range(push - cfg["window"] + 1, push + 1)]
    return [torch.from_numpy(path[v][idx]).to(dev) for v in (0, 1)]


def canvas_around(cfg: dict, meshes) -> R.Canvas:
    """A panorama's canvas around its frame-resolution meshes, with the
    stitcher's margin and bucket."""
    ext = torch.stack(list(meshes)).cpu().numpy().reshape(-1, 2)
    lo, hi = ext.min(0), ext.max(0)
    half = (hi - lo) / 2.0 * MARGIN
    out_w, out_h = int(np.ceil(2 * half[0])), int(np.ceil(2 * half[1]))
    b = cfg["canvas_bucket"]
    return R.Canvas(out_h=out_h, out_w=out_w, pad_h=-(-out_h // b) * b,
                    pad_w=-(-out_w // b) * b,
                    x_min=float((lo[0] + hi[0]) / 2 - half[0]),
                    y_min=float((lo[1] + hi[1]) / 2 - half[1]),
                    span_h=float(out_h), span_w=float(out_w))


@torch.no_grad()
def reference_push(cfg: dict, nets, views, meshes=None, canvas=None,
                   stats=None, dtype=torch.float32):
    """The reference's outputs of one push: the smooth meshes of its
    window (``R.window_mesh``), and the panorama of the pushed frame
    composited from ``meshes`` (the window's, model resolution; its own
    where none are given) onto ``canvas`` (a program canvas's fields; one
    around the content where none is given) in ``dtype``. Returns (its
    window meshes, the frame-resolution meshes of the frame, the canvas,
    the BGR panorama [1, oh, ow, 3])."""
    mh, mw = cfg["model_h"], cfg["model_w"]
    own = R.window_mesh(nets, *(R.lo_of(v, mh, mw) for v in views))
    scaled = [R.scale_meshes(m[-1:], cfg["frame_h"], cfg["frame_w"], mh, mw)
              for m in (own if meshes is None else meshes)]
    if canvas is None:
        canvas = canvas_around(cfg, scaled)
    else:
        canvas = R.Canvas(span_h=float(canvas["out_h"]),
                          span_w=float(canvas["out_w"]), **canvas)
    frame = R.composite([v[-1:] for v in views], scaled, canvas,
                        cfg["fusion_mode"], "bgr", stats, dtype)
    return own, scaled, canvas, frame


@torch.no_grad()
def check(run, path, kept, weights) -> dict:
    """``mesh_gap_px``, ``canvas_outside_px`` and ``frame_gap`` of the kept
    pushes (module docstring)."""
    dev = run.device
    nets = N.build(run.cfg, weights, dev)
    out = {"mesh_gap_px": 0.0, "canvas_outside_px": 0.0, "frame_gap": 0.0}
    stats = {}
    for item in kept:
        item = {k: program.host_copy(v) if torch.is_tensor(v) else v
                for k, v in item.items()}
        (r1, r2), scaled, _, frame = reference_push(
            run.cfg, nets,
            window_views(run.cfg, run.mix, path, item["push"], dev),
            [torch.from_numpy(item[m]).to(dev) for m in ("mesh1", "mesh2")],
            item["canvas"], stats)
        out["mesh_gap_px"] = max(out["mesh_gap_px"],
                                 compare.mesh_gap(item["mesh1"], r1.cpu()),
                                 compare.mesh_gap(item["mesh2"], r2.cpu()))
        out["canvas_outside_px"] = max(
            out["canvas_outside_px"],
            compare.canvas_outside(item["canvas"], [m.cpu() for m in scaled]))
        out["frame_gap"] = max(out["frame_gap"], compare.frame_gap(
            item["frame"][None], frame.cpu().numpy()))
    run.layer["live_share"] = stats["live"] / stats["pixels"]
    return out


def control(run, weights):
    """The control (``CONTROL``): :func:`reference_push` in the program's
    place at the lower precisions, at as many pushes as a run keeps, drawn
    from the seed over a stream of ``control_pushes``. Returns (the path,
    its outputs as :func:`check` reads the program's)."""
    cfg, mix, dev = run.cfg, run.mix, run.device
    path = make_path(cfg, mix, run.seed)
    nets = N.build(cfg, weights, dev, lower.NETS)
    first = cfg["window"] + mix["warm_pushes"]
    rng = np.random.default_rng([run.seed, 1])
    kept = []
    for p in rng.choice(mix["control_pushes"], mix["check_pushes"],
                        replace=False) + first:
        (m1, m2), _, canvas, frame = reference_push(
            cfg, nets, window_views(cfg, mix, path, int(p), dev),
            dtype=lower.COMPOSITE)
        kept.append({"push": int(p), "frame": frame[0].cpu().numpy(),
                     "canvas": program.canvas_fields(canvas),
                     "mesh1": m1.cpu().numpy(), "mesh2": m2.cpu().numpy()})
    return path, kept
