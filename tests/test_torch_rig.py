"""Rig-size frames (``benchmark/configs/ssd-1080p.json``: 1080x1920 camera
pairs through a 360x480 model) on the CPU, at a third of that size where
the nets run: a 128x160 model and frames three times as large.

- The canvas cap follows the frames (``compositor.canvas_cap``): frames
  at the model's size keep ``StitchConfig``'s 1024x1280, two and three
  1080x1920 views side by side pass, a runaway mesh raises, on the batch,
  chain and online paths.
- ``OnlineStitcher`` on 384x480 frames with the benchmark's seeded
  weights against the benchmark's plain reference
  (``benchmark/drivers/online.py:reference_push``): the window's smooth
  meshes and the emitted panorama within the online cells' limits.
- ``VideoStitcher.stitch_begin``/``stitch_finish`` on such frames, with
  a canvas past the configured cap, against the reference composite of
  the program's own meshes (the offline cells' limits).

``model_input``'s 3x shrink against ``jax.image.resize`` is a case of
``tests/test_torch_stitch.py::TestModelInput``.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from stabstitch2_tpu_torch.config import StitchConfig
from stabstitch2_tpu_torch.pipeline import stitcher as stitcher_mod
from stabstitch2_tpu_torch.pipeline import threeview
from stabstitch2_tpu_torch.pipeline.compositor import (canvas_cap,
                                                       plan_canvas)
from stabstitch2_tpu_torch.pipeline.online import OnlineStitcher
from stabstitch2_tpu_torch.pipeline.stitcher import init_stitcher

from synthetic import make_two_view_clip

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MH, MW = 128, 160
FH, FW = 3 * MH, 3 * MW


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads (tests/test_torch_entry.py: tier-1's workers
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def views_side_by_side(n_views, h, w, overlap=0.5, jitter=0.0, seed=0):
    """Frame-resolution meshes [1, 7, 9, 2] of ``n_views`` views of h x w
    placed ``1 - overlap`` of a view apart, as a rig's cameras lie."""
    rng = np.random.default_rng(seed)
    base = np.stack(np.meshgrid(np.linspace(0.0, w, 9),
                                np.linspace(0.0, h, 7)), -1)
    return [torch.from_numpy((base + [k * w * (1.0 - overlap), 0.0]
                              + rng.normal(0, jitter, base.shape))[None]
                             .astype(np.float32)) for k in range(n_views)]


class TestCanvasCap:
    def test_the_cap_follows_the_frames(self):
        cfg = StitchConfig()
        assert canvas_cap(cfg, (360, 480), (360, 480)) == (1024, 1280)
        assert canvas_cap(cfg, (1080, 1920), (360, 480)) == (3072, 5120)
        assert canvas_cap(cfg, (FH, FW), (MH, MW)) == (3072, 3840)
        # never below the configured cap, on either axis
        assert canvas_cap(cfg, (96, 120), (128, 160)) == (1024, 1280)
        assert canvas_cap(cfg, (360, 1920), (360, 480)) == (1024, 5120)

    def test_model_size_frames_keep_the_configured_cap(self):
        """At 360x480 a canvas one bucket past 1024 rows raises, as it did
        before; at 1024 it passes."""
        cfg = StitchConfig()
        for rows, ok in ((1024, True), (1056, False)):
            m = views_side_by_side(1, rows - 8, 480)
            if ok:
                canvas, _ = plan_canvas(m[0], m[0], cfg, (360, 480))
                assert canvas.pad_h == rows
            else:
                with pytest.raises(ValueError, match="exceeds configured"):
                    plan_canvas(m[0], m[0], cfg, (360, 480))
        with pytest.raises(ValueError, match="exceeds configured"):
            plan_canvas(m[0], m[0], cfg)      # no frame size: the model's

    @pytest.mark.parametrize("n_views,pad", [(2, (1088, 2880)),
                                             (3, (1088, 3840))])
    def test_rig_views_pass(self, n_views, pad):
        """Two and three 1080x1920 views at 0.5 overlap pass the cap the
        CLI's defaults give, where the fixed 1024x1280 refused them."""
        cfg = StitchConfig(download_format="yuv420")
        meshes = views_side_by_side(n_views, 1080, 1920, jitter=3.0)
        stacked = torch.cat(meshes)
        canvas, _ = plan_canvas(stacked, stacked, cfg, (1080, 1920))
        assert (canvas.pad_h, canvas.pad_w) >= pad
        with pytest.raises(ValueError, match="exceeds configured"):
            plan_canvas(stacked, stacked, cfg)    # the model's size

    def test_a_runaway_mesh_raises(self):
        meshes = views_side_by_side(2, 1080, 1920)
        runaway = meshes[1] * torch.tensor([3.0, 1.0])
        with pytest.raises(ValueError, match="exceeds configured"):
            plan_canvas(meshes[0], runaway, StitchConfig(), (1080, 1920))

    def test_the_chain_caps_for_its_frames(self):
        """Three views of 3x-model frames through the chain composite: the
        cap scales with the frames over ``model_size`` (a configured cap
        of 160x352 allows 480x1056 here); the same canvas over the
        default 360x480 model size raises."""
        cfg = StitchConfig(max_canvas_h=160, max_canvas_w=352)
        meshes = views_side_by_side(3, FH, FW)
        imgs = [np.full((1, FH, FW, 3), 100 + 40 * k, np.uint8)
                for k in range(3)]
        frames = threeview.composite_chain(imgs, meshes, cfg,
                                           model_size=(MH, MW))
        assert frames.shape == (1, FH, 2 * FW, 3) and frames.max() > 100
        with pytest.raises(ValueError, match="exceeds configured"):
            threeview.composite_chain(imgs, meshes, cfg)

    def test_online_canvas_is_capped(self):
        """The online stitcher sizes its canvas itself; past the cap of
        its frames it raises, below it it composites."""
        st = init_stitcher(0, StitchConfig(canvas_bucket=32), MH, MW, 4,
                           compute_dtype=torch.float32, device="cpu")
        img = torch.zeros((1, FH, FW, 3), dtype=torch.uint8)
        scale = torch.tensor([MW / FW, MH / FH])     # to model resolution
        m1, m2 = views_side_by_side(2, FH, FW)
        out = OnlineStitcher(st)._composite_many(img, img, m1 * scale,
                                                 m2 * scale)
        assert out[0].shape[1] > 1280 // 2
        o = OnlineStitcher(st)
        with pytest.raises(ValueError, match="exceeds configured"):
            o._composite_many(img, img, m1 * scale,
                              m2 * scale * torch.tensor([8.0, 1.0]))
        assert o.canvas is None


def rig_cfg():
    """``ssd-1080p``'s configuration at the CPU's size: the model 128x160,
    the frames three times as large."""
    from benchmark import harness

    cfg = harness.load_json(os.path.join(ROOT, "benchmark", "configs",
                                         "ssd-1080p.json"))
    return dict(cfg, model_h=MH, model_w=MW, frame_h=FH, frame_w=FW)


def limits(cell):
    from benchmark import harness

    return harness.load_json(os.path.join(ROOT, "benchmark", "limits",
                                          cell + ".json"))


def test_online_rig_frames_match_the_reference(monkeypatch):
    """The benchmark's program (the CLI's stitcher, bf16 trunks, K2, BGR
    emission) with the benchmark's seeded weights, pushed a 3x-model
    camera path; the last push against ``reference_push``: every frame
    of the window's smooth meshes, the content inside the canvas, and
    the panorama composited by the reference from the program's meshes
    onto the program's canvas, each within ``ssd-1080p.online``'s
    limits."""
    import functools

    from benchmark.drivers import online as drv
    from benchmark.lib import compare, program
    from benchmark.lib.weights import make_state_dicts
    from benchmark.reference import nets as N

    monkeypatch.setattr(stitcher_mod, "init_stitcher", functools.partial(
        stitcher_mod.init_stitcher, model_h=MH, model_w=MW))
    cfg, seed = rig_cfg(), 2 ** 31 + 5
    mix = {"path_frames": 10, "overlap": 0.5, "shake_px": 12.0}
    weights = make_state_dicts(cfg, seed, "cpu")
    st = program.stitcher(cfg, weights, "cpu")
    online = OnlineStitcher(st, emit_format="bgr")
    path = drv.make_path(cfg, mix, seed)
    pushes = cfg["window"] + 3
    for i in range(pushes):
        out = online.push(path[0][clip_index(i, mix)],
                          path[1][clip_index(i, mix)])
    assert len(out) == 1 and out[0].shape[:2] == (online.canvas.out_h,
                                                  online.canvas.out_w)
    assert online.canvas.out_w > FW         # the canvas at frame scale
    nets = N.build(cfg, weights, "cpu")
    (r1, r2), scaled, _, frame = drv.reference_push(
        cfg, nets, drv.window_views(cfg, mix, path, pushes - 1, "cpu"),
        list(online.window_smooth), program.canvas_fields(online.canvas))
    lim = limits("ssd-1080p.online")
    gap = max(compare.mesh_gap(online.window_smooth[0], r1),
              compare.mesh_gap(online.window_smooth[1], r2))
    assert gap <= lim["mesh_gap_px"], gap
    assert compare.canvas_outside(program.canvas_fields(online.canvas),
                                  scaled) <= lim["canvas_outside_px"]
    fgap = compare.frame_gap(out[0][None], frame.numpy())
    assert fgap <= lim["frame_gap"], fgap
    assert out[0].max() > 10


def clip_index(i, mix):
    from benchmark.traffic import clips

    return clips.bounce(i, mix["path_frames"])


def test_batch_stitch_past_the_configured_cap_matches_the_reference():
    """``stitch_begin``/``stitch_finish`` on 3x-model frames with I420
    down (the CLI's), under a configured cap of 256x320 that the canvas
    passes: the cap scaled for the frames admits it, and the frames
    equal the reference's composite of the program's own meshes onto the
    canvas the rule gives for them (the offline cells' limit)."""
    from benchmark.lib import compare
    from benchmark.reference import pipeline as R

    cfg = StitchConfig(download_format="yuv420", max_canvas_h=256,
                       max_canvas_w=320)
    st = init_stitcher(0, cfg, MH, MW, chunk=4, compute_dtype=torch.float32,
                       device="cpu")
    v1, v2 = make_two_view_clip(num_frames=8, height=FH, width=FW,
                                overlap=0.5, shake_px=12.0, seed=7)
    res = st.stitch_finish(st.stitch_begin(v1, None, v2, None))
    c = res.canvas
    assert c.pad_h > 256 and c.pad_w > 320
    meshes = [R.scale_meshes(m, FH, FW, MH, MW)
              for m in (res.smooth_mesh1, res.smooth_mesh2)]
    ref_canvas = R.plan_canvas(meshes, cfg.canvas_bucket, even=True)
    assert compare.canvas_rule(dataclasses.asdict(c), ref_canvas) == 0.0
    want = R.composite_video(
        [torch.from_numpy(v) for v in (v1, v2)], meshes, ref_canvas,
        {"download_format": "yuv420", "fusion_mode": cfg.fusion_mode,
         "chunk": 4})
    assert res.frame_format == "i420"
    gap = compare.frame_gap(res.frames, want.numpy())
    assert gap <= limits("ssd-2view.offline")["frame_gap"], gap


def test_pinned_frames_stack_and_check_shapes():
    """A pushed pair is staged as one [2, ...] uint8 tensor holding both
    frames; frames of different shapes raise (a smaller one would
    otherwise broadcast into the buffer)."""
    from stabstitch2_tpu_torch.utils.transfer import pinned_frames

    rng = np.random.default_rng(0)
    a, b = (rng.integers(0, 255, (FH, FW, 3), dtype=np.uint8)
            for _ in range(2))
    got = pinned_frames([a, b], "cpu")
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.stack([a, b]))
    with pytest.raises(ValueError, match="different shapes"):
        pinned_frames([a, b[:1]], "cpu")
