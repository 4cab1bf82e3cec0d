"""The training slice's pieces against the JAX package on the CPU.

Same seeded numpy inputs through the JAX function and the port's: the
bicubic resize (and ``goldens/bicubic.npz``), the homography warp with
its mask, VGG-19 (``goldens/vgg_parity.npz``), each loss term, train-mode
BatchNorm's running statistics, the optimizer over three steps, the
smooth trainer's transport, the datasets' batches, the motion export,
the checkpointer and loop resume, and ``cli train``/``export-motions`` on
``--device cpu``. Tolerances are given at each test.
"""

import os
import shutil

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stabstitch2_tpu.train import losses as jl
from stabstitch2_tpu_torch.train import losses as tl

from synthetic import write_clip_dirs

MH, MW = 128, 160


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: tier-1 runs six workers on eight cores
    (see tests/test_torch_entry.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def rel(a, b) -> float:
    a, b = float(a), float(b)
    return abs(a - b) / max(abs(b), 1e-30)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------


class TestResizeBicubic:
    @pytest.mark.parametrize("align", [True, False])
    def test_golden_and_jax(self, goldens, align):
        from stabstitch2_tpu.ops.resize import resize_bicubic as j_resize
        from stabstitch2_tpu_torch.ops.resize import resize_bicubic

        g = goldens("bicubic")
        x = np.transpose(g["x"], (0, 2, 3, 1))
        got = resize_bicubic(t(x), (28, 36), align_corners=align).numpy()
        ref = np.transpose(g["up_true" if align else "up_false"], (0, 2, 3, 1))
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
        jx = np.asarray(j_resize(jnp.asarray(x), (28, 36), align))
        np.testing.assert_allclose(got, jx, rtol=0, atol=1e-5)

    def test_downscale_mask_against_jax(self):
        """The perceptual term's use: a [B, H, W, 1] mask to 1/4 size."""
        from stabstitch2_tpu.ops.resize import resize_bicubic as j_resize
        from stabstitch2_tpu_torch.ops.resize import resize_bicubic

        m = np.random.default_rng(0).uniform(0, 1, (2, 40, 48, 1))
        m = m.astype(np.float32)
        got = resize_bicubic(t(m), (10, 12), align_corners=False).numpy()
        ref = np.asarray(j_resize(jnp.asarray(m), (10, 12), False))
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_homo_warp_with_mask_matches_jax():
    """On the same theta the two sides' sample coordinates differ only
    through the output grid (torch.linspace and jnp.linspace round
    differently, <= 1 ulp; the product itself is bit-equal), 2.4e-7 here.
    On a uniform-noise image (slope up to 2 per pixel) that moves values by
    up to 1.7e-5, so they are held at the homography warp's parity bound
    (1e-4, tests/test_torch_ops.py); the mask within 1e-6."""
    from stabstitch2_tpu.ops.homography import (homo_sample_coords as j_hc,
                                                homo_warp_with_mask as j_hw,
                                                normalize_homography as j_nh)
    from stabstitch2_tpu_torch.ops.homography import (homo_sample_coords,
                                                      homo_warp_with_mask,
                                                      normalize_homography)

    rng = np.random.default_rng(1)
    im = rng.uniform(-1, 1, (2, 48, 64, 3)).astype(np.float32)
    H = np.tile(np.eye(3, dtype=np.float32), (2, 1, 1))
    H[:, :2, :] += rng.normal(0, 0.02, (2, 2, 3)).astype(np.float32)
    H[:, :2, 2] = rng.normal(0, 4, (2, 2)).astype(np.float32)
    theta = np.array(j_nh(jnp.asarray(H), 48, 64))
    np.testing.assert_allclose(normalize_homography(t(H), 48, 64).numpy(),
                               theta, rtol=0, atol=1e-6)
    for j, g in zip(j_hc(jnp.asarray(theta), (48, 64)),
                    homo_sample_coords(t(theta), (48, 64))):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=0,
                                   atol=1e-6)
    jw, jm = j_hw(jnp.asarray(im), jnp.asarray(theta), (48, 64))
    w, m = homo_warp_with_mask(t(im), t(theta), (48, 64))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=0, atol=1e-4)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=0, atol=1e-6)


def test_vgg_features_golden(goldens):
    """JAX tests/test_models.py::TestVGGParity's tolerance."""
    from stabstitch2_tpu_torch.models.vgg import (VGG19Features,
                                                  vgg19_state_dict)

    g = goldens("vgg_parity")
    sd = {k[len("sd::"):]: t(g[k]) for k in g.files if k.startswith("sd::")}
    net = VGG19Features()
    net.load_state_dict(vgg19_state_dict(sd), strict=True)
    with torch.no_grad():
        out = net(t(np.transpose(g["x"], (0, 2, 3, 1)))).numpy()
    np.testing.assert_allclose(out, np.transpose(g["y"], (0, 2, 3, 1)),
                               rtol=1e-4, atol=1e-3)


# ---------------------------------------------------------------------------
# losses (each within 1e-5 relative of the JAX term)
# ---------------------------------------------------------------------------


def _warps(seed, B=2, H=32, W=40, C=4):
    rng = np.random.default_rng(seed)
    out = rng.uniform(-1, 1, (4, B, H, W, C)).astype(np.float32)
    out[..., 3] = (rng.uniform(0, 1, (4, B, H, W)) > 0.3) * rng.uniform(
        0.5, 1, (4, B, H, W))
    return list(out)


class TestLosses:
    def test_inter_grid_loss_4d(self, goldens):
        g = goldens("grid_losses")
        got = tl.inter_grid_loss(t(g["mesh4"]))
        assert rel(got, g["inter4"]) <= 1e-5
        mesh = np.random.default_rng(2).normal(0, 30, (3, 5, 7, 9, 2))
        mesh = (mesh + np.stack(np.meshgrid(np.arange(9) * 60.0,
                                            np.arange(7) * 60.0), -1))
        mesh = mesh.astype(np.float32)
        assert rel(tl.inter_grid_loss(t(mesh)),
                   jl.inter_grid_loss(jnp.asarray(mesh))) <= 1e-5

    def test_spatial_photometric(self):
        w = _warps(3)
        assert rel(tl.spatial_photometric_loss(*map(t, w)),
                   jl.spatial_photometric_loss(*map(jnp.asarray, w))) <= 1e-5

    def test_perceptual_random_vgg(self):
        """With random VGG weights (a JAX init carried across with
        ``utils/weights.py:vgg19_mapping``): the mask resize, the 0..255
        mapping and the 3:1 weighting."""
        from stabstitch2_tpu.models.vgg import VGG19Features as JVGG
        from stabstitch2_tpu.train.spatial import make_vgg_apply
        from stabstitch2_tpu_torch.models.vgg import VGG19Features
        from stabstitch2_tpu_torch.utils import weights as W

        w = _warps(5, H=32, W=48)
        variables = JVGG().init(jax.random.PRNGKey(4),
                                jnp.zeros((1, 32, 48, 3)))
        ref = jl.perceptual_loss(make_vgg_apply(variables),
                                 *map(jnp.asarray, w))
        net = VGG19Features()
        net.load_state_dict(W.flax_to_state_dict(
            jax.tree_util.tree_map(np.asarray, variables),
            W.vgg19_mapping()), strict=True)
        with torch.no_grad():
            got = tl.perceptual_loss(net, *map(t, w))
        assert rel(got, ref) <= 1e-5

    def test_spatial_loss_with_the_perceptual_term(self):
        """The tra recipe's total adds 1e-3 x the perceptual term, which
        reaches the mesh heads (the frozen VGG has no parameter grads)."""
        from stabstitch2_tpu_torch.config import spatial_train_preset
        from stabstitch2_tpu_torch.models import SpatialNet, VGG19Features
        from stabstitch2_tpu_torch.models.backbone import init_weights
        from stabstitch2_tpu_torch.train.spatial import (frozen_vgg,
                                                         spatial_loss_fn)

        gen = torch.Generator().manual_seed(6)
        vgg = VGG19Features()
        init_weights(vgg, gen)
        vgg = frozen_vgg(vgg.state_dict(), "cpu")
        net = SpatialNet(MH, MW)
        init_weights(net, gen)
        a, b = (torch.rand(2, MH, MW, 3, generator=gen) * 2 - 1
                for _ in range(2))
        cfg = spatial_train_preset("tra")
        total, m = spatial_loss_fn(net.train(), a, b, None, cfg, vgg)
        assert float(m["perception"]) > 0
        assert rel(total, m["overlap"] + m["nonoverlap"]
                   + 1e-3 * m["perception"]) <= 1e-6
        total.backward()
        assert float(net.regressNet2_part2_ref[4].weight.grad.abs().sum()) > 0
        assert all(p.grad is None for p in vgg.parameters())

    def test_temporal_photometric(self):
        rng = np.random.default_rng(6)
        prev = rng.uniform(-1, 1, (2, 24, 32, 3)).astype(np.float32)
        warped = rng.uniform(-1, 1, (2, 24, 32, 6)).astype(np.float32)
        warped[..., 3:] = rng.uniform(0, 1, (2, 24, 32, 1)) > 0.4
        assert rel(tl.temporal_photometric_loss(t(prev), t(warped)),
                   jl.temporal_photometric_loss(jnp.asarray(prev),
                                                jnp.asarray(warped))) <= 1e-5

    def test_brightness_balanced_l1(self):
        rng = np.random.default_rng(7)
        a, b = rng.uniform(-1, 1, (2, 2, 24, 32, 3)).astype(np.float32)
        ov = (rng.uniform(0, 1, (2, 24, 32, 1)) > 0.3).astype(np.float32)
        assert rel(tl.brightness_balanced_l1(t(a), t(b), t(ov)),
                   jl.brightness_balanced_l1(*map(jnp.asarray,
                                                  (a, b, ov)))) <= 1e-5

    def test_online_collaboration(self):
        rng = np.random.default_rng(8)
        paths = list(rng.normal(0, 5, (3, 2, 7, 7, 9, 2)).astype(np.float32))
        assert rel(tl.online_collaboration_loss([t(p) for p in paths]),
                   jl.online_collaboration_loss(
                       [jnp.asarray(p) for p in paths])) <= 1e-5


# ---------------------------------------------------------------------------
# BatchNorm, optimizer, augmentation
# ---------------------------------------------------------------------------


class TestBatchNorm:
    def test_running_stats_match_flax(self):
        """B=2 on an 8x10 map: n = 160, where the unbiased variance
        (x n/(n-1) = 1.0063) would miss the 1e-5 bound by far."""
        import flax.linen as fnn
        from stabstitch2_tpu_torch.models.backbone import BatchNorm2d

        rng = np.random.default_rng(9)
        x = (rng.normal(0.3, 1.7, (2, 8, 10, 16))).astype(np.float32)
        bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                           epsilon=1e-5)
        v = bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
        y, upd = bn.apply(v, jnp.asarray(x), mutable=["batch_stats"])
        port = BatchNorm2d(16).train()
        got = port(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(y),
                                   rtol=1e-5, atol=1e-5)
        st = upd["batch_stats"]
        np.testing.assert_allclose(port.running_mean.numpy(),
                                   np.asarray(st["mean"]), rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(port.running_var.numpy(),
                                   np.asarray(st["var"]), rtol=1e-5)
        unbiased = 0.9 + 0.1 * x.reshape(-1, 16).var(0, ddof=1)
        assert np.abs(unbiased / np.asarray(st["var"]) - 1).max() > 1e-4

    def test_eval_mode_is_nn_batchnorm(self):
        from stabstitch2_tpu_torch.models.backbone import BatchNorm2d

        gen = torch.Generator().manual_seed(10)
        ours, plain = BatchNorm2d(8), torch.nn.BatchNorm2d(8)
        for bn in (ours, plain):
            bn.running_mean.copy_(torch.arange(8.0) * 0.1)
            bn.running_var.copy_(torch.arange(8.0) * 0.2 + 0.5)
            bn.weight.data.fill_(1.3)
            bn.eval()
        x = torch.randn(2, 8, 6, 7, generator=gen)
        assert set(ours.state_dict()) == set(plain.state_dict())
        with torch.no_grad():
            assert torch.equal(ours(x), plain(x))


def test_optimizer_matches_optax():
    """Three steps across an epoch boundary (steps_per_epoch 2), the
    second with clipping active (global norm > 3): params within 1e-7."""
    import optax
    from stabstitch2_tpu.config import TrainConfig as JCfg
    from stabstitch2_tpu.train.common import make_optimizer as j_make
    from stabstitch2_tpu_torch.config import TrainConfig
    from stabstitch2_tpu_torch.train.common import make_optimizer

    rng = np.random.default_rng(11)
    shapes = {"a": (4, 5), "b": (7,), "c": (3, 3, 2)}
    p0 = {k: rng.normal(0, 0.5, s).astype(np.float32)
          for k, s in shapes.items()}
    grads = [{k: rng.normal(0, s_, shp).astype(np.float32)
              for k, shp in shapes.items()} for s_ in (0.1, 2.0, 0.3)]
    norms = [np.sqrt(sum((g ** 2).sum() for g in gs.values())) for gs in grads]
    assert norms[1] > 3.0 > max(norms[0], norms[2])

    tx = j_make(JCfg(), 2)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    for gs in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in gs.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)

    tp = {k: torch.nn.Parameter(t(v.copy())) for k, v in p0.items()}
    opt = make_optimizer(tp.values(), TrainConfig(), 2)
    for gs in grads:
        for k, p in tp.items():
            p.grad = t(gs[k].copy())
        opt.step()
    assert opt.step_count == 3 and opt.lr(2) == pytest.approx(1e-4 * 0.97)
    for k in shapes:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=0, atol=1e-7, err_msg=k)


def test_apply_aug_with_jax_draws():
    """JAX's drawn factors through ``apply_aug`` give JAX's images."""
    from stabstitch2_tpu.train.common import data_aug_pair
    from stabstitch2_tpu_torch.train.common import apply_aug, draw_aug

    rng = np.random.default_rng(12)
    a, b = rng.uniform(-1, 1, (2, 2, 8, 9, 3)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    ja, jb = data_aug_pair(key, jnp.asarray(a), jnp.asarray(b))
    got = apply_aug(t(a), t(b), jax_factors(key))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ja))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(jb))
    f = draw_aug(torch.Generator().manual_seed(0))
    assert [x.shape for x in f] == [(), (), (3,), (3,)]
    assert all(float(x.min()) >= 0.7 and float(x.max()) <= 1.3 for x in f)


def jax_factors(key):
    """The factors ``train/common.py:data_aug_pair`` draws from ``key``."""
    k = jax.random.split(key, 4)
    draws = (jax.random.uniform(k[0], (), minval=0.7, maxval=1.3),
             jax.random.uniform(k[1], (), minval=0.7, maxval=1.3),
             jax.random.uniform(k[2], (3,), minval=0.7, maxval=1.3),
             jax.random.uniform(k[3], (3,), minval=0.7, maxval=1.3))
    return tuple(t(np.asarray(d)) for d in draws)


def test_transport_window_matches_jax():
    from stabstitch2_tpu.train.smooth import transport_window as j_tw
    from stabstitch2_tpu_torch.train.smooth import transport_window

    rng = np.random.default_rng(13)
    tm = rng.normal(0, 2, (2, 7, 7, 9, 2)).astype(np.float32)
    sm = rng.normal(0, 8, (2, 7, 7, 9, 2)).astype(np.float32)
    got = transport_window(t(tm), t(sm), 360, 480).numpy()
    ref = np.asarray(j_tw(jnp.asarray(tm), jnp.asarray(sm), 360, 480))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-3)
    assert np.all(got[:, 0] == 0)


# ---------------------------------------------------------------------------
# datasets, export, checkpoints, loop, CLI
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Three two-view videos at 128x160 (14, 16, 13 frames) with motion
    npy streams, the last one's views of unequal length."""
    root = str(tmp_path_factory.mktemp("train_tree"))
    rng = np.random.default_rng(14)
    for i, n in enumerate((14, 16, 13)):
        vd = write_clip_dirs(root, num_frames=n, height=MH, width=MW,
                             seed=20 + i, video_name=f"v{i}")
        for name in ("TemporalMotion1", "TemporalMotion2", "SpatialMotion1",
                     "SpatialMotion2"):
            os.makedirs(os.path.join(vd, name))
            for f in range(n):
                np.save(os.path.join(vd, name, f"{f:06d}.npy"),
                        rng.normal(0, 3, (7, 9, 2)).astype(np.float32))
    os.remove(os.path.join(root, "v2", "video1", "000012.jpg"))
    return root


def _batches(mod, kind, root, seed, n_batches=3):
    size = (MH, MW)
    if kind == "spatial":
        ds = mod.SpatialPairDataset(root, training=True, seed=seed,
                                    model_size=size)
    elif kind == "temporal":
        ds = mod.TemporalPairDataset(root, 4, seed=seed, model_size=size)
    else:
        ds = mod.SmoothWindowDataset(root, selected_frames=8,
                                     train_frame_num=12, seed=seed,
                                     model_size=size)
    out = []
    for i, b in enumerate(mod.batch_iterator(ds, 4, seed=seed + 1)):
        if i >= n_batches:
            break
        out.append(b)
    return len(ds), out


@pytest.mark.parametrize("kind", ["spatial", "temporal", "smooth"])
def test_datasets_equal_jax_cv2_path(tree, kind, monkeypatch):
    from stabstitch2_tpu.data import datasets as jd
    from stabstitch2_tpu.data import native
    from stabstitch2_tpu_torch.data import datasets as td
    from stabstitch2_tpu_torch.data import native as t_native

    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(t_native, "available", lambda: False)
    n_j, ref = _batches(jd, kind, tree, seed=5)
    n_t, got = _batches(td, kind, tree, seed=5)
    assert n_j == n_t > 0 and len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        for x, y in zip(g, r):
            np.testing.assert_array_equal(x, y)


def test_batch_iterator_abandoned_stops_its_thread(tree):
    import threading

    from stabstitch2_tpu_torch.data.datasets import (TemporalPairDataset,
                                                     batch_iterator)

    before = threading.active_count()
    it = batch_iterator(TemporalPairDataset(tree, 4, model_size=(MH, MW)), 2)
    next(it)
    it.close()
    assert threading.active_count() == before


@pytest.fixture(scope="module")
def stitchers():
    """A float32 random-weight JAX stitcher at 128x160 and the port's with
    its weights (``utils/weights.py:from_jax_params``)."""
    from stabstitch2_tpu.models import SmoothNet, SpatialNet, TemporalNet
    from stabstitch2_tpu.pipeline.stitcher import VideoStitcher
    from stabstitch2_tpu_torch.pipeline.stitcher import init_stitcher
    from stabstitch2_tpu_torch.utils.weights import from_jax_params

    # init_stitcher's nets, initialized under jit (a third of the eager
    # init's time at this size)
    nets = (SpatialNet(dtype=jnp.float32), TemporalNet(dtype=jnp.float32),
            SmoothNet())
    img, mesh = jnp.zeros((1, MH, MW, 3)), jnp.zeros((1, 7, 7, 9, 2))
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    variables = (
        jax.jit(lambda k: nets[0].init(k, img, img, False))(keys[0]),
        jax.jit(lambda k: nets[1].init(k, img, img, False))(keys[1]),
        jax.jit(lambda k: nets[2].init(k, mesh, mesh, mesh, mesh))(keys[2]))
    js = VideoStitcher(nets[0], variables[0], nets[1], variables[1], nets[2],
                       variables[2], chunk=4, model_h=MH, model_w=MW)
    tonp = lambda v: jax.tree_util.tree_map(np.asarray, v)  # noqa: E731
    sds = from_jax_params(tonp(js.spatial_vars), tonp(js.temporal_vars),
                          tonp(js.smooth_vars))
    ts = init_stitcher(model_h=MH, model_w=MW, chunk=4,
                       compute_dtype=torch.float32, device="cpu")
    for net, sd in zip((ts.spatial_net, ts.temporal_net, ts.smooth_net), sds):
        net.load_state_dict(sd, strict=True)
    return js, ts


def test_export_motions_match_jax(tree, stitchers, tmp_path):
    """The JAX export's files, values within the motions' parity bounds
    (tests/test_torch_models.py: atol 2e-4 spatial, 1e-4 temporal)."""
    from stabstitch2_tpu.train import export as jx
    from stabstitch2_tpu_torch.train import export as tx

    js, ts = stitchers
    roots = {}
    for side in ("jax", "port"):
        roots[side] = str(tmp_path / side)
        for v in ("v0", "v2"):
            shutil.copytree(os.path.join(tree, v),
                            os.path.join(roots[side], v),
                            ignore=shutil.ignore_patterns("*Motion*"))
    counts_j = (jx.export_spatial_motions(js, roots["jax"]),
                jx.export_temporal_motions(js, roots["jax"]))
    counts_t = (tx.export_spatial_motions(ts, roots["port"]),
                tx.export_temporal_motions(ts, roots["port"]))
    assert counts_j == counts_t == (14 + 12, 2 * (14 + 12))
    for v in ("v0", "v2"):
        for name, atol in (("SpatialMotion1", 2e-4), ("SpatialMotion2", 2e-4),
                           ("TemporalMotion1", 1e-4),
                           ("TemporalMotion2", 1e-4)):
            dj = os.path.join(roots["jax"], v, name)
            dt = os.path.join(roots["port"], v, name)
            assert sorted(os.listdir(dj)) == sorted(os.listdir(dt))
            for f in sorted(os.listdir(dj)):
                np.testing.assert_allclose(np.load(os.path.join(dt, f)),
                                           np.load(os.path.join(dj, f)),
                                           rtol=1e-4, atol=atol,
                                           err_msg=f"{v}/{name}/{f}")


def test_checkpointer_keeps_three_and_restores_latest(tmp_path):
    from stabstitch2_tpu_torch.utils.checkpoint import (
        TrainCheckpointer, load_reference_state_dict)

    ck = TrainCheckpointer(str(tmp_path / "m"))
    assert ck.restore() is None
    for step in (3, 6, 9, 12):
        ck.save(step, {"model": {"w": torch.full((2,), float(step))},
                       "optimizer": {}, "step": step, "epoch": step // 3})
    assert ck.steps() == [6, 9, 12]
    got = ck.restore()
    assert got["step"] == 12 and float(got["model"]["w"][0]) == 12.0
    # a trainer's file reads as a reference checkpoint
    assert set(load_reference_state_dict(ck.path(12))) == {"w"}


def test_loop_saves_resumes_and_continues_the_step(tree, tmp_path):
    """Two steps, a checkpoint, then a second epoch resumed from it."""
    from stabstitch2_tpu_torch.config import TemporalTrainConfig
    from stabstitch2_tpu_torch.train import loop

    cfg = TemporalTrainConfig(batch_size=2, max_epoch=1)
    steps = []
    run = loop.train_temporal(tree, cfg, model_dir=str(tmp_path / "m"),
                              max_steps_per_epoch=2, model_h=MH, model_w=MW,
                              device="cpu",
                              on_step=lambda s, m: steps.append(s))
    assert steps == [1, 2] and run.checkpointer.steps() == [2]
    assert np.isfinite(float(run.metrics["total"]))
    first = {k: v.clone() for k, v in run.net.state_dict().items()}
    cfg2 = TemporalTrainConfig(batch_size=2, max_epoch=2)
    run2 = loop.train_temporal(tree, cfg2, model_dir=str(tmp_path / "m"),
                               max_steps_per_epoch=2, model_h=MH, model_w=MW,
                               device="cpu",
                               on_step=lambda s, m: steps.append(s))
    assert steps == [1, 2, 3, 4] and run2.opt.step_count == 4
    assert run2.checkpointer.steps() == [2, 4]
    assert run2.opt.lr(3) == pytest.approx(1e-4 * 0.97)
    moved = any(not torch.equal(first[k], v)
                for k, v in run2.net.state_dict().items()
                if v.dtype.is_floating_point)
    assert moved


def test_loop_refuses_multi_device_and_tra_without_vgg(tree, tmp_path):
    from stabstitch2_tpu_torch.config import (SpatialTrainConfig,
                                              spatial_train_preset)
    from stabstitch2_tpu_torch.train import loop

    with pytest.raises(ValueError, match="batch_size 2 is not divisible "
                                         "by n_devices 3"):
        loop.train_spatial(tree, cfg=SpatialTrainConfig(batch_size=2),
                           model_dir=str(tmp_path / "a"), n_devices=3,
                           model_h=MH, model_w=MW, device="cpu")
    with pytest.raises(ValueError, match="perception_weight"):
        loop.train_spatial(tree, cfg=spatial_train_preset("tra"),
                           model_dir=str(tmp_path / "b"), device="cpu")


def test_cli_train_and_export_on_cpu(tree, tmp_path, monkeypatch):
    """``cli train`` (each stage) and ``export-motions`` parse and run on
    ``--device cpu``, at 128x160 (the loops' and the stitcher's model
    size patched; the presets' batch of 8 stays), and a trained triad
    loads through ``--reference_pth_dir``."""
    import functools

    from stabstitch2_tpu_torch import cli
    from stabstitch2_tpu_torch.pipeline import stitcher as stitcher_mod
    from stabstitch2_tpu_torch.train import loop
    from stabstitch2_tpu_torch.utils.checkpoint import TrainCheckpointer

    for name in ("train_spatial", "train_temporal", "train_smooth"):
        monkeypatch.setattr(loop, name, functools.partial(
            getattr(loop, name), model_h=MH, model_w=MW))
    real_init = stitcher_mod.init_stitcher
    monkeypatch.setattr(stitcher_mod, "init_stitcher", functools.partial(
        real_init, model_h=MH, model_w=MW, chunk=4,
        compute_dtype=torch.float32))
    data = str(tmp_path / "data")
    shutil.copytree(tree, data,
                    ignore=shutil.ignore_patterns("*Motion*"))
    dirs = {s: str(tmp_path / s) for s in ("spatial", "temporal", "smooth")}
    common = ["--max_epoch", "1", "--max_steps_per_epoch", "1",
              "--device", "cpu"]
    for stage in ("spatial", "temporal"):
        assert cli.main(["train", stage, "--train_path", data,
                         "--model_dir", dirs[stage]] + common) == 0
    triad = tmp_path / "triad"
    triad.mkdir()
    for stage, name in (("spatial", "spatial_warp.pth"),
                        ("temporal", "temporal_warp.pth")):
        ck = TrainCheckpointer(dirs[stage])
        shutil.copy(ck.path(ck.latest_step()), triad / name)
    assert cli.main(["export-motions", "--train_path", data,
                     "--reference_pth_dir", str(triad),
                     "--device", "cpu"]) == 0
    assert len(os.listdir(os.path.join(data, "v0", "SpatialMotion1"))) == 14
    assert cli.main(["train", "smooth", "--train_path", data,
                     "--model_dir", dirs["smooth"]] + common) == 0
    ck = TrainCheckpointer(dirs["smooth"])
    shutil.copy(ck.path(ck.latest_step()), triad / "smooth_warp.pth")
    args = cli.make_parser().parse_args(
        ["stitch", "--test_path", data, "--output_path", str(tmp_path / "o"),
         "--reference_pth_dir", str(triad), "--device", "cpu"])
    st = cli.build_stitcher(args)
    trained = torch.load(triad / "smooth_warp.pth", weights_only=True)
    for k, v in st.smooth_net.state_dict().items():
        assert torch.equal(v, trained["model"][k]), k


def test_cli_train_and_export_default_to_the_card(tree):
    """``cli train`` and ``export-motions`` run on the card unless asked
    for the CPU, and raise where there is none."""
    from stabstitch2_tpu_torch import cli

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["train", "temporal", "--train_path", tree,
                  "--model_dir", os.path.join(tree, "..", "m_default")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["export-motions", "--train_path", tree])
