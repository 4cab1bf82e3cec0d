"""Offline N-view stitching, closed loop, two deep: ``cli stitch-multi``'s
loop (``cli.two_deep`` over ``threeview.stitch_multi_begin`` /
``stitch_multi_finish``) on the CLI's stitcher, fed from host memory.

Traffic, end to end, spans and the slice as ``offline.py``: a pool of
N-view clips as packed I420, cycled; ``stitch_fps`` over the window.
The three-view path returns no ``StitchResult`` (no phase marks).

``correct``: for each sampled video the reference chains the adjacent
pairs' smooth meshes, which it works out from the same frames and
weights, and composites every view onto the program's canvas
(``frame_gap``: the frames the program emitted against these). The
canvas itself is not compared: the control moves its anchor no more than
the program's rounding does.
"""

from __future__ import annotations

import dataclasses

import torch

from benchmark.drivers import offline
from benchmark.lib import compare, lower, program
from benchmark.reference import nets as N
from benchmark.reference import pipeline as R


# what control.py puts in the program's place
CONTROL = lower.DESCRIPTION


class Driver(offline.Driver):
    command = "stitch-multi"

    def arrays(self, k):
        return self.pool[k]

    def loop(self, items, sink):
        """``cli stitch-multi``'s two-deep loop over ``items``; each
        finished video goes to ``sink(name, frames, canvas, None)``."""
        from stabstitch2_tpu_torch import cli
        from stabstitch2_tpu_torch.pipeline.threeview import (
            stitch_multi_begin, stitch_multi_finish)

        def finish(name, pending, t0):
            frames, _ = stitch_multi_finish(pending)
            sink(name, frames, pending.composite.canvas, None)

        return cli.two_deep(items, lambda his: stitch_multi_begin(self.st,
                                                                  his),
                            finish)

    def sampled(self, k, frames, canvas, result):
        return {"k": k, "frames": frames,
                "canvas": program.canvas_fields(canvas)}

    def check(self):
        return check(self.run, self.pool,
                     self.sample.items + self.sample_long.items,
                     self.weights)


@torch.no_grad()
def reference_video(cfg: dict, nets, views, canvas=None, stats=None,
                    dtype=torch.float32):
    """The reference's outputs of one N-view video: the adjacent pairs'
    smooth meshes from the views, chained (``R.chain``), their canvas, and
    the frames composited onto ``canvas`` (a program canvas's fields; the
    reference's own where none is given) in ``dtype``. Returns (its own
    canvas, the frames)."""
    mh, mw = cfg["model_h"], cfg["model_w"]
    los = [R.lo_of(v, mh, mw) for v in views]
    pairs = []
    for a, b in zip(los[:-1], los[1:]):
        m = R.video_meshes(nets, a, b, cfg["window"])
        pairs.append((m["smooth_mesh1"], m["smooth_mesh2"]))
    meshes = R.chain(pairs, cfg["frame_h"], cfg["frame_w"], mh, mw)
    own = R.plan_canvas([torch.cat(meshes)], cfg["canvas_bucket"],
                        cfg["download_format"] == "yuv420")
    onto = own if canvas is None else dataclasses.replace(own, **canvas)
    return own, R.composite_video(views, meshes, onto, cfg, stats, dtype)


@torch.no_grad()
def check(run, pool, kept, weights) -> dict:
    """``frame_gap`` of the kept results (module docstring)."""
    nets = N.build(run.cfg, weights, run.device)
    out = {"frame_gap": 0.0}
    stats = {}
    for item in kept:
        _, frames = reference_video(
            run.cfg, nets, offline.decode(pool, item["k"], run.device),
            item["canvas"], stats)
        out["frame_gap"] = max(out["frame_gap"], compare.frame_gap(
            item["frames"], frames.cpu().numpy()))
    run.layer["live_share"] = stats["live"] / stats["pixels"]
    return out


def control(run, weights):
    """The control (``CONTROL``): :func:`reference_video` in the program's
    place at the lower precisions; returns (the pool, its outputs as
    :func:`check` reads the program's)."""
    pool = offline.make_pool(run.cfg, run.mix, run.seed)
    nets = N.build(run.cfg, weights, run.device, lower.NETS)
    kept = []
    for k in offline.control_picks(pool, run.mix, run.seed):
        canvas, frames = reference_video(
            run.cfg, nets, offline.decode(pool, k, run.device),
            dtype=lower.COMPOSITE)
        kept.append({"k": int(k), "frames": frames.cpu().numpy(),
                     "canvas": program.canvas_fields(canvas)})
    return pool, kept
