"""The benchmark's plain reference held against the program, on the CPU at
a small size (128x160), float32 on both sides: the nets, a whole video's
smooth meshes and frames, an online window, the three-view chain and the
colour conversions. With the same weights and inputs the two must agree
to float32 rounding; the benchmark's limits sit far above that (they
judge the program in bfloat16 on the card)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.lib.weights import make_state_dicts
from benchmark.reference import geometry as G
from benchmark.reference import nets as N
from benchmark.reference import pipeline as R
from benchmark.traffic import clips

CFG = {"model_h": 128, "model_w": 160, "grid_h": 6, "grid_w": 8,
       "window": 7, "weights": {
           "scale": {"spatial.regressNet1_part2.4.weight": 0.2,
                     "smooth.MotionPre.decoding.0.weight": 0.02}}}
H, W = 128, 160
# float32 on both sides, summed in other orders: meshes to 1e-3 px
MESH_ATOL = 1e-3


@pytest.fixture(scope="module")
def weights():
    torch.set_num_threads(2)
    return make_state_dicts(CFG, 5, "cpu")


@pytest.fixture(scope="module")
def program(weights):
    from stabstitch2_tpu_torch.config import StitchConfig
    from stabstitch2_tpu_torch.pipeline.stitcher import init_stitcher

    st = init_stitcher(rng_seed=0, model_h=H, model_w=W,
                       config=StitchConfig(download_format="yuv420"),
                       compute_dtype=torch.float32, device="cpu")
    for net, name in ((st.spatial_net, "spatial"),
                      (st.temporal_net, "temporal"),
                      (st.smooth_net, "smooth")):
        net.load_state_dict(weights[name])
    st.replicate()
    return st


@pytest.fixture(scope="module")
def ref(weights):
    return N.build(CFG, weights, "cpu")


def test_nets_match_the_program(program, ref):
    g = torch.Generator().manual_seed(1)
    a, b = (torch.rand(3, H, W, 3, generator=g) * 2 - 1 for _ in range(2))
    with torch.no_grad():
        for got, want in zip(program.spatial_net(a, b),
                             ref["spatial"](a, b)):
            assert torch.allclose(got, want, atol=1e-3, rtol=1e-4)
        fp, fr = (net.features(a) for net in (program.temporal_net,
                                              ref["temporal"]))
        assert torch.allclose(fp, fr, atol=1e-4, rtol=1e-4)
        mp = program.temporal_net.motion_from_features(fp[:2], fp[1:])
        mr = ref["temporal"].motion_from_features(fr[:2], fr[1:])
        assert torch.allclose(mp, mr, atol=1e-4, rtol=1e-4)


def test_video_meshes_and_frames_match_the_program(program, ref):
    v1, v2 = (clips.to_i420(v) for v in clips.make_clip(2, 16, H, W, 0.5,
                                                        4.0, 3))
    res = program.stitch_arrays(v1, None, v2, None)
    u1, u2 = (G.i420_to_bgr_u8(torch.from_numpy(v)) for v in (v1, v2))
    m = R.video_meshes(ref, R.lo_of(u1, H, W), R.lo_of(u2, H, W), 7)
    for k in ("smooth_mesh1", "smooth_mesh2", "ori_mesh1", "ori_mesh2"):
        assert float((getattr(res, k) - m[k]).abs().max()) < MESH_ATOL, k
    # the program's frames from its own meshes: the reference's composite
    s1, s2 = (R.scale_meshes(x, H, W, H, W) for x in (res.smooth_mesh1,
                                                      res.smooth_mesh2))
    canvas = R.plan_canvas([s1, s2], 32, True)
    assert (canvas.out_h, canvas.out_w, canvas.pad_h, canvas.pad_w) == (
        res.canvas.out_h, res.canvas.out_w, res.canvas.pad_h,
        res.canvas.pad_w)
    frames = torch.cat([R.composite([u1[s:e], u2[s:e]], [s1[s:e], s2[s:e]],
                                    canvas, "AVERAGE", "i420")
                        for s, e in R.chunks(16, 8)]).numpy()
    assert frames.shape == res.frames.shape
    diff = np.abs(frames.astype(int) - res.frames.astype(int))
    assert diff.mean() < 1e-3 and diff.max() <= 1


def test_window_mesh_matches_the_online_stitcher(program, ref):
    from stabstitch2_tpu_torch.pipeline.online import OnlineStitcher

    v1, v2 = clips.make_clip(2, 10, H, W, 0.5, 4.0, 4)
    online = OnlineStitcher(program)
    for a, b in zip(v1, v2):
        out = online.push(a, b)
    r1, r2 = R.window_mesh(ref, R.lo_of(torch.from_numpy(v1[-7:]), H, W),
                           R.lo_of(torch.from_numpy(v2[-7:]), H, W))
    p1, p2 = online.window_smooth
    assert float((p1 - r1).abs().max()) < MESH_ATOL
    assert float((p2 - r2).abs().max()) < MESH_ATOL
    c = online.canvas
    canvas = R.Canvas(out_h=c.out_h, out_w=c.out_w, pad_h=c.pad_h,
                      pad_w=c.pad_w, x_min=c.x_min, y_min=c.y_min,
                      span_h=float(c.out_h), span_w=float(c.out_w))
    frame = R.composite([torch.from_numpy(v1[-1:]), torch.from_numpy(v2[-1:])],
                        [R.scale_meshes(p[-1:], H, W, H, W) for p in (p1, p2)],
                        canvas, "AVERAGE", "bgr")[0].numpy()
    diff = np.abs(frame.astype(int) - out[0].astype(int))
    assert diff.mean() < 1e-3 and diff.max() <= 1


def test_chain_matches_the_program():
    from stabstitch2_tpu_torch.pipeline.threeview import chain_meshes

    g = torch.Generator().manual_seed(2)
    rigid = G.rigid_mesh(H, W, 6, 8, "cpu")
    pairs = [(rigid + torch.randn(5, 7, 9, 2, generator=g) + dx,
              rigid + torch.randn(5, 7, 9, 2, generator=g) + dx - 80)
             for dx in (40.0, -40.0)]
    for got, want in zip(chain_meshes(pairs, 2 * H, 2 * W, H, W),
                         R.chain(pairs, 2 * H, 2 * W, H, W)):
        assert float((got - want).abs().max()) < MESH_ATOL


def test_colour_conversions_match_the_program():
    from stabstitch2_tpu_torch.ops.yuv import (bgr_to_yuv420, pack_i420,
                                               unpack_i420_u8)

    g = torch.Generator().manual_seed(3)
    f = torch.rand(2, 8, 12, 3, generator=g) * 255
    assert torch.equal(pack_i420(*bgr_to_yuv420(f)), G.bgr_to_i420(f))
    packed = torch.randint(0, 256, (2, 12, 12), generator=g,
                           dtype=torch.uint8)
    assert torch.equal(unpack_i420_u8(packed), G.i420_to_bgr_u8(packed))


def test_fp8_control_departs_from_float32(ref, weights):
    """The control's nets (float8 e4m3 trunks) move the meshes by far more
    than float32 rounding."""
    q = N.build(CFG, weights, "cpu", quant="fp8")
    lo1, lo2 = (R.lo_of(torch.from_numpy(v), H, W)
                for v in clips.make_clip(2, 8, H, W, 0.5, 4.0, 5))
    a = R.video_meshes(ref, lo1, lo2, 7)["smooth_mesh1"]
    b = R.video_meshes(q, lo1, lo2, 7)["smooth_mesh1"]
    assert float((a - b).abs().max()) > 10 * MESH_ATOL


def test_training_steps_match_the_program(weights):
    """Three spatial training steps (train-mode BatchNorm, the loss, the
    backward, the clip and Adam) from the same weights, batches and
    augmentation factors: the losses to float32 rounding, the first
    gradients and the parameters' changes to a small share of their
    norms."""
    from stabstitch2_tpu_torch.config import SpatialTrainConfig
    from stabstitch2_tpu_torch.models import SpatialNet
    from stabstitch2_tpu_torch.train.common import make_optimizer
    from stabstitch2_tpu_torch.train.spatial import spatial_train_step

    from benchmark.drivers.train import draw_factors
    from benchmark.reference import train as RT

    tcfg = SpatialTrainConfig(batch_size=2)
    recipe = {"lr": tcfg.learning_rate, "b1": tcfg.b1, "b2": tcfg.b2,
              "eps": tcfg.eps, "clip": tcfg.grad_clip_norm,
              "grid_weight": tcfg.grid_weight}
    clip = clips.make_clip(2, 6, H, W, 0.5, 4.0, 9)
    gen = torch.Generator().manual_seed(3)
    batches = [(torch.from_numpy(clip[0][k:k + 2]),
                torch.from_numpy(clip[1][k:k + 2]), draw_factors(gen))
               for k in (0, 2, 4)]
    net = SpatialNet(H, W)
    net.load_state_dict(weights["spatial"])
    net.train()
    opt = make_optimizer(net.parameters(), tcfg, 10)
    losses, first = [], {}
    for a, b, f in batches:
        losses.append(float(spatial_train_step(net, opt, a, b, f, tcfg)[
            "total"]))
        first = first or {n: float(opt.adam.state[p]["exp_avg"].norm())
                          / (1 - tcfg.b1) for n, p in net.named_parameters()}
    ref = RT.train_steps(CFG, recipe, weights["spatial"], batches, "cpu")
    assert np.allclose(losses, ref["losses"], rtol=1e-5)
    for n, p in net.named_parameters():
        assert first[n] == pytest.approx(ref["grad_norm"][n], rel=1e-3,
                                         abs=1e-7), n
        change = float((p.detach() - weights["spatial"][n]).norm())
        assert change == pytest.approx(ref["change_norm"][n], rel=2e-2,
                                       abs=1e-6), n
