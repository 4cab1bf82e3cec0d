"""Offline two-view stitching, closed loop, two deep: ``cli stitch``'s own
loop (``cli.stitch_stream`` over ``VideoStitcher.stitch_begin`` /
``stitch_finish``) on the CLI's stitcher, fed from host memory and
finished into a sink that keeps nothing but the sampled results. Decode
and encode stay out of the window: the loop is what the card's work
moves.

Traffic (the mix): a pool of clips made from the seed in set-up, held as
packed I420, their lengths in the mix's fixed order, cycled until the
window closes; the video in flight then is finished and counted. The
pool is stitched ``warm_passes`` times in set-up, so every length and
canvas is warm.

End to end: ``stitch_fps``, the frames downloaded over the window's
seconds. The profiled slice (``--trace 1``) is one more pass over the
pool after the window; the device time of each of the stitcher's phase
annotations is read from it. (``StitchResult.ms``, the phase marks, are
not read: two deep, a video's ``warp_fuse`` mark is taken after the next
video's begin, whose marks wait for the card, so it holds that begin.)

``correct``: a sample of the window's videos drawn from the seed, the
longest length among them; for each, the reference works the meshes out
from the same frames and weights: the smooth meshes (``mesh_gap_px``)
and the smoothing's own part of them, smooth minus original
(``delta_gap_px``, which a fault of the smoothing alone moves by far
more than the motion's rounding does). The canvas of the program's own
meshes must be the program's canvas (``canvas_rule_px``), and the
reference composites the program's meshes onto that canvas, as the
judge of the frames the program emitted for them (``frame_gap``).
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
from benchmark.reference import geometry as G
from benchmark.reference import nets as N
from benchmark.reference import pipeline as R
from benchmark.traffic import clips


# the stitcher's phase annotations (``utils/profiling.py:annotate``)
PHASES = ("upload", "spatial", "temporal", "smooth", "composite")


def make_pool(cfg: dict, mix: dict, seed: int):
    """The pool: per clip, its views' frames as I420 [T, H*3//2, W], with
    the mix's lengths in the mix's order (the order of lengths sets how
    the two-deep loop overlaps videos: every seed gets the same one) and
    the content drawn from the seed."""
    pool = []
    for k, T in enumerate(mix["lengths"]):
        views = clips.make_clip(cfg["views"], int(T),
                                cfg["frame_h"], cfg["frame_w"],
                                mix["overlap"], mix["shake_px"],
                                stream_seed(seed, k))
        pool.append([clips.to_i420(v) for v in views])
    return pool


def quarters(videos, window_s):
    """Frames finished in each quarter of the window (a drift shows)."""
    out = [0, 0, 0, 0]
    for v in videos:
        out[min(int(4 * v["done"] / window_s), 3)] += v["T"]
    return out


# what control.py puts in the program's place
CONTROL = lower.DESCRIPTION


class Driver:
    command = "stitch"      # the CLI command whose defaults build the stitcher

    def __init__(self, run):
        self.run = run
        self.cfg, self.mix = run.cfg, run.mix

    def setup(self):
        run = self.run
        self.weights = for_run(run)
        self.st = program.stitcher(self.cfg, self.weights, run.device,
                                   command=self.command)
        self.pool = make_pool(self.cfg, self.mix, run.seed)
        self.longest = max(p[0].shape[0] for p in self.pool)
        rng = np.random.default_rng([run.seed, 1])
        self.sample = Reservoir(self.mix["check_videos"], rng)
        self.sample_long = Reservoir(1, rng)
        self.loop(self.items(self.mix["warm_passes"] * len(self.pool)),
                  lambda *done: None)

    def items(self, n, deadline=None):
        for i in range(n):
            if deadline is not None and time.perf_counter() >= deadline:
                return
            k = i % len(self.pool)
            yield f"{k}.{i}", self.arrays(k), None

    def arrays(self, k):
        v = self.pool[k]
        return v[0], None, v[1], None

    def loop(self, items, sink):
        """``cli stitch``'s two-deep loop over ``items``; each finished
        video goes to ``sink(name, frames, canvas, result)``."""
        from stabstitch2_tpu_torch import cli

        return cli.stitch_stream(self.st, items, lambda name, r: sink(
            name, r.frames, r.canvas, r))

    def sampled(self, k, frames, canvas, result):
        # references only: a copy, or a fetch that waits for the card,
        # inside the window would stall the two-deep loop
        return {"k": k, "frames": frames,
                "canvas": program.canvas_fields(canvas),
                "mesh1": result.smooth_mesh1, "mesh2": result.smooth_mesh2,
                "ori1": result.ori_mesh1, "ori2": result.ori_mesh2}

    def keep(self, name, frames, canvas, result):
        k, T = int(name.split(".")[0]), len(frames)
        self.frames += T
        self.videos.append({"T": T, "done": time.perf_counter() - self.t0,
                            "pad": (canvas.pad_h, canvas.pad_w)})

        def make():
            return self.sampled(k, frames, canvas, result)

        self.sample.offer(make)
        if T == self.longest:
            self.sample_long.offer(make)

    def window(self, seconds):
        self.frames, self.videos = 0, []
        t0 = self.t0 = time.perf_counter()
        done, failed = self.loop(self.items(10 ** 9, t0 + seconds),
                                 self.keep)
        window_s = time.perf_counter() - t0
        run = self.run
        run.attempted, run.failed = done + failed, failed
        run.end_to_end["stitch_fps"] = self.frames / window_s
        print("frames by quarter of the window:",
              quarters(self.videos, window_s), file=sys.stderr)
        run.layer.update(window_s=window_s, frames=self.frames,
                         videos=self.videos)

    def traced_slice(self):
        videos = []

        def record(name, frames, canvas, result):
            videos.append({"T": len(frames),
                           "pad": (canvas.pad_h, canvas.pad_w)})

        with Slice(PHASES) as s:
            done, failed = self.loop(self.items(len(self.pool)), record)
        self.run.attempted += done + failed
        self.run.failed += failed
        if s.summary is not None:
            s.summary.units = sum(v["T"] for v in videos)
            s.summary.notes["videos"] = videos
        return s.summary

    def release(self):
        del self.st

    def check(self):
        """The readings of the sampled videos (module docstring)."""
        return check(self.run, self.pool,
                     self.sample.items + self.sample_long.items,
                     self.weights)


def decode(pool, k, dev):
    """Clip ``k`` of the pool as uint8 BGR views on ``dev``."""
    return [G.i420_to_bgr_u8(torch.from_numpy(v).to(dev)) for v in pool[k]]


@torch.no_grad()
def reference_video(cfg: dict, nets, views, meshes=None, stats=None,
                    dtype=torch.float32):
    """The reference's outputs of one two-view video: its meshes from the
    views (``R.video_meshes``), and the frames of ``meshes`` (its own
    smooth meshes where none are given) composited onto their canvas in
    ``dtype``. Returns (its meshes, the canvas, the frames)."""
    mh, mw = cfg["model_h"], cfg["model_w"]
    ref = R.video_meshes(nets, *(R.lo_of(v, mh, mw) for v in views),
                         cfg["window"])
    if meshes is None:
        meshes = (ref["smooth_mesh1"], ref["smooth_mesh2"])
    scaled = [R.scale_meshes(m, cfg["frame_h"], cfg["frame_w"], mh, mw)
              for m in meshes]
    canvas = R.plan_canvas(scaled, cfg["canvas_bucket"],
                           cfg["download_format"] == "yuv420")
    return ref, canvas, R.composite_video(views, scaled, canvas, cfg, stats,
                                          dtype)


@torch.no_grad()
def check(run, pool, kept, weights) -> dict:
    """``mesh_gap_px``, ``delta_gap_px``, ``canvas_rule_px`` and
    ``frame_gap`` of the kept results (module docstring); the live share
    of the composites goes to ``run.layer['live_share']``."""
    dev = run.device
    nets = N.build(run.cfg, weights, dev)
    out = {"mesh_gap_px": 0.0, "delta_gap_px": 0.0, "canvas_rule_px": 0.0,
           "frame_gap": 0.0}
    stats = {}
    for item in kept:
        item = {k: program.host_copy(v) if torch.is_tensor(v) else v
                for k, v in item.items()}
        ref, canvas, frames = reference_video(
            run.cfg, nets, decode(pool, item["k"], dev),
            [torch.from_numpy(item[m]).to(dev) for m in ("mesh1", "mesh2")],
            stats)
        for v in "12":
            out["mesh_gap_px"] = max(out["mesh_gap_px"], compare.mesh_gap(
                item["mesh" + v], ref["smooth_mesh" + v].cpu()))
            out["delta_gap_px"] = max(out["delta_gap_px"], compare.mesh_gap(
                item["mesh" + v] - item["ori" + v],
                (ref["smooth_mesh" + v] - ref["ori_mesh" + v]).cpu()))
        out["canvas_rule_px"] = max(out["canvas_rule_px"],
                                    compare.canvas_rule(item["canvas"],
                                                        canvas))
        out["frame_gap"] = max(out["frame_gap"], compare.frame_gap(
            item["frames"], frames.cpu().numpy()))
    run.layer["live_share"] = stats["live"] / stats["pixels"]
    return out


def control_picks(pool, mix, seed):
    """The pool clips a control compares: as many as a run keeps, drawn
    from the seed, a longest clip among them."""
    rng = np.random.default_rng([seed, 1])
    picks = list(rng.choice(len(pool), mix["check_videos"], replace=False))
    lengths = [p[0].shape[0] for p in pool]
    return picks + [lengths.index(max(lengths))]


def control(run, weights):
    """The control (``CONTROL``): :func:`reference_video` in the program's
    place at the lower precisions; returns (the pool, its outputs as
    :func:`check` reads the program's)."""
    pool = make_pool(run.cfg, run.mix, run.seed)
    nets = N.build(run.cfg, weights, run.device, lower.NETS)
    kept = []
    for k in control_picks(pool, run.mix, run.seed):
        m, canvas, frames = reference_video(
            run.cfg, nets, decode(pool, k, run.device),
            dtype=lower.COMPOSITE)
        kept.append({"k": int(k), "frames": frames.cpu().numpy(),
                     "canvas": program.canvas_fields(canvas),
                     **{k2: m[k1].cpu().numpy() for k1, k2 in (
                         ("smooth_mesh1", "mesh1"), ("smooth_mesh2", "mesh2"),
                         ("ori_mesh1", "ori1"), ("ori_mesh2", "ori2"))}})
    return pool, kept
