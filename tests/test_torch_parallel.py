"""Multi-device runs of the port on the CPU (``stabstitch2_tpu_torch/parallel``).

Inference: N replicas on the CPU (``init_stitcher(n_devices=N,
device='cpu')``) against one, bit for bit: ``stitch_arrays`` in bulk and
stream upload, BGR and packed I420, at 10 frames in chunks of 4 (a tail
chunk, a device with two chunks, temporal pairs across devices); weights
loaded after the replicas were made (``stitcher_from_checkpoint``);
``stitch_multi_view``, ``evaluate_video`` and the ``export-motions``
files. The JAX package is held to one replica by the other test files.
An ``n_devices`` above the visible cards raises.

Training goes through the trainer loops (``train/loop.py``) on one
synthetic clip at 128x160, B = 8. One spawn of four gloo ranks runs,
each case through ``parallel/train.py:_train_rank`` on a group of its own
(the rank function of ``run_training``; a probe module the ranks import
adds each rank's state and plants the faults): the temporal loop's first
step on four and on two ranks and the spatial loop's on two, each
resumed from the JAX init (a ``step_0.pth``), against the JAX package's
single-device ``value_and_grad`` on the same batch and augmentation
draws (the port's draws fed to JAX's ``data_aug_pair``; computed while
the ranks run), with tests/test_torch_train_steps.py's bounds: the loss
within 1e-4 relative, every gradient (clipped as optax clips) within
1e-3 relative L2 (the trunks, ``feature_extractor*``, 3e-2), the
BatchNorm running statistics within 1e-5; the planted fault "each rank's
own BatchNorm statistics" must break them. The same spawn runs the
temporal loop for two steps (two epochs of one) on four ranks, and on two
with the planted fault "no gradient average"; ``train_temporal
(n_devices=2)``, through its entry point, likewise. These are held to one
process's loop: each step's loss within 1e-4, the parameters within rtol
2e-3, atol 5e-4 (the JAX package's mesh-against-single bound,
tests/test_entry_and_multiview.py::TestTrainerOnMesh), and per tensor
the second step's gradients and the update theta_after - theta_init
within LOOP_GRAD_RTOL_L2 and UPDATE_RTOL_L2 relative L2, which the
planted fault must break. Every case checks that rank 0 alone writes the
checkpoint and that the ranks end with equal states and import no JAX.
A rendezvous fails after JOIN_S and a collective after GROUP_S; the
entry-point run outlasts a rendezvous bound of RENDEZVOUS_S, which
bounds the rendezvous alone.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stabstitch2_tpu_torch.config import (SpatialTrainConfig, StitchConfig,
                                          TemporalTrainConfig)
from stabstitch2_tpu_torch.data.video_io import bgr_to_i420
from stabstitch2_tpu_torch.parallel import (backend_for, resolve_devices,
                                            train as ptrain)
from stabstitch2_tpu_torch.pipeline.stitcher import init_stitcher
from stabstitch2_tpu_torch.utils import weights as W

from synthetic import make_two_view_clip, write_clip_dirs
from test_torch_multiview import views, write_views
from test_torch_train_steps import (GRAD_RTOL_L2, LOSS_RTOL,
                                    TRUNK_GRAD_RTOL_L2)

MH, MW, CHUNK, T = 128, 160, 4, 10
B = 8
BN_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 2e-3, 5e-4
# the loop runs' second step against one process's, relative L2 per
# tensor: the gradients and the update theta_after - theta_init. Adam's
# first step moves every weight by +-lr whatever its gradient's size, so
# a rounding-level difference in a near-zero gradient moves that weight
# by 2 lr: sound runs read up to 0.10 and 0.15 (two ranks), the planted
# fault (no gradient average) up to 2.6 and 0.94 (module docstring)
LOOP_GRAD_RTOL_L2 = 0.3
UPDATE_RTOL_L2 = 0.4
# a rendezvous or collective that hangs fails within these bounds rather
# than eat the tier-1 clock (tier-1 runs six workers on eight cores)
JOIN_S, GROUP_S = 120.0, 240.0
# the loop test's rendezvous bound, which its run outlasts
RENDEZVOUS_S = 5.0
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread, as each spawned rank runs
    (tests/test_torch_train_steps.py: the trunk's backward reads ~1e-3 off
    with two on this CPU build)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# inference: N replicas against one
# ---------------------------------------------------------------------------


def stitcher(n, seed=0):
    return init_stitcher(seed, StitchConfig(canvas_bucket=32), MH, MW, CHUNK,
                         compute_dtype=torch.float32, n_devices=n,
                         device="cpu")


@pytest.fixture(scope="module")
def stitchers():
    return {n: stitcher(n) for n in (1, 2, 3)}


@pytest.fixture(scope="module")
def clip():
    return make_two_view_clip(num_frames=T, height=MH, width=MW, overlap=0.6,
                              shake_px=2.0, seed=5)


def assert_same(a, b):
    assert a.frames.shape == b.frames.shape
    np.testing.assert_array_equal(a.frames, b.frames)
    for k in ("smooth_mesh1", "smooth_mesh2", "ori_mesh1", "ori_mesh2"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k


@pytest.mark.parametrize("packed", [False, True], ids=["bgr", "i420"])
@pytest.mark.parametrize("mode", ["bulk", "stream"])
def test_replicas_stitch_arrays_bit_equal(stitchers, clip, mode, packed):
    v1, v2 = clip
    if packed:
        v1, v2 = bgr_to_i420(v1), bgr_to_i420(v2)
    got = {}
    for n, st in stitchers.items():
        st.upload_mode = mode
        try:
            got[n] = st.stitch_arrays(v1, None, v2, None)
        finally:
            st.upload_mode = "bulk"
    assert got[1].frames.max() > 10
    assert [len(stitchers[n]._motion.replicas) for n in got] == [1, 2, 3]
    assert_same(got[2], got[1])
    assert_same(got[3], got[1])


def test_replicas_take_weights_loaded_later(clip, tmp_path):
    """A triad loaded after the stitcher was made (``.pth`` files through
    ``stitcher_from_checkpoint``) reaches every replica."""
    from stabstitch2_tpu_torch.utils.checkpoint import (TRIAD,
                                                        stitcher_from_checkpoint)

    other = stitcher(1, seed=3)
    for net, name in zip((other.spatial_net, other.temporal_net,
                          other.smooth_net), TRIAD):
        torch.save(net.state_dict(), tmp_path / name)
    kw = dict(reference_pth_dir=str(tmp_path), rng_seed=0, model_h=MH,
              model_w=MW, chunk=CHUNK, compute_dtype=torch.float32,
              config=StitchConfig(canvas_bucket=32), device="cpu")
    two = stitcher_from_checkpoint(n_devices=2, **kw)
    one = stitcher_from_checkpoint(**kw)
    ref = other.stitch_arrays(clip[0], None, clip[1], None)
    assert_same(two.stitch_arrays(clip[0], None, clip[1], None), ref)
    assert_same(one.stitch_arrays(clip[0], None, clip[1], None), ref)


def test_replicas_stitch_multi_view_bit_equal(stitchers, tmp_path):
    from stabstitch2_tpu_torch.pipeline.threeview import stitch_multi_view

    clip_dir = str(tmp_path / "clip")
    write_views(clip_dir, views(9, seed=3))
    one = stitch_multi_view(stitchers[1], clip_dir)
    assert one.max() > 10
    np.testing.assert_array_equal(stitch_multi_view(stitchers[2], clip_dir),
                                  one)


@pytest.mark.parametrize("upload", ["bgr", "i420"])
def test_replicas_evaluate_video_equal(stitchers, clip, upload):
    from stabstitch2_tpu_torch.metrics.harness import evaluate_video

    one = evaluate_video(stitchers[1], *clip, upload=upload)
    assert np.isfinite(list(one.values())).all()
    assert evaluate_video(stitchers[2], *clip, upload=upload) == one
    assert evaluate_video(stitchers[3], *clip, upload=upload) == one


def test_replicas_export_motions_equal(stitchers, tmp_path):
    import shutil

    from stabstitch2_tpu_torch.train.export import (export_spatial_motions,
                                                    export_temporal_motions)

    roots = {n: str(tmp_path / f"d{n}") for n in (1, 2)}
    write_clip_dirs(roots[1], num_frames=9, height=MH, width=MW, seed=8,
                    video_name="v0")
    shutil.copytree(roots[1], roots[2])
    counts = {n: (export_spatial_motions(stitchers[n], roots[n]),
                  export_temporal_motions(stitchers[n], roots[n]))
              for n in roots}
    assert counts[1] == counts[2] == (9, 18)
    for name in ("SpatialMotion1", "SpatialMotion2", "TemporalMotion1",
                 "TemporalMotion2"):
        d1, d2 = (os.path.join(roots[n], "v0", name) for n in (1, 2))
        files = sorted(os.listdir(d1))
        assert files == sorted(os.listdir(d2)) and len(files) == 9
        for f in files:
            np.testing.assert_array_equal(np.load(os.path.join(d1, f)),
                                          np.load(os.path.join(d2, f)))


def test_devices_resolve_without_fallback(monkeypatch, tmp_path):
    """N replicas on the CPU, an explicit list as it is, and more cards
    than are visible raising in the stitcher, the CLI and the trainers
    (one card made visible here)."""
    from stabstitch2_tpu_torch import cli
    from stabstitch2_tpu_torch.train import loop

    assert resolve_devices(3, "cpu") == [CPU] * 3
    assert resolve_devices(None, ["cpu", "cpu"]) == [CPU, CPU]
    with pytest.raises(ValueError, match="n_devices=3"):
        resolve_devices(3, ["cpu", "cpu"])
    with pytest.raises(ValueError, match=">= 1"):
        resolve_devices(0, "cpu")
    cards = [torch.device("cuda", i) for i in range(2)]
    assert backend_for(cards) == "nccl"
    assert backend_for([cards[0], cards[0]]) == "gloo"
    assert backend_for([CPU, CPU]) == "gloo"

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 2 cards, but 1"):
        init_stitcher(model_h=MH, model_w=MW, n_devices=2)
    with pytest.raises(RuntimeError, match="needs 2 cards, but 1"):
        cli.main(["stitch", "--test_path", str(tmp_path), "--n_devices", "2"])
    with pytest.raises(RuntimeError, match="needs 2 cards, but 1"):
        loop.train_temporal(str(tmp_path), TemporalTrainConfig(),
                            model_dir=str(tmp_path / "m"), n_devices=2)




# ---------------------------------------------------------------------------
# training: the loops' ranks against JAX's single-device step
# ---------------------------------------------------------------------------

SEED = 0
# the spawned ranks import this module, written to a temporary directory
# (it imports the port alone): several loop runs in one spawn, each on
# ranks 0 .. world - 1 under a group of their own, some with a fault
# planted in the package
PROBE = '''"""Trainer loops on the ranks of one spawn."""
import datetime
import sys

import torch
import torch.distributed as dist

from stabstitch2_tpu_torch.models import backbone
from stabstitch2_tpu_torch.parallel.train import Rank, _train_rank
from stabstitch2_tpu_torch.train import common, loop


def _no_average(self):
    pass


def _per_rank_bn(net, group):
    backbone.set_process_group(net, None)


FAULTS = {"no_grad_average": (common.Optimizer, "average_grads", _no_average),
          "per_rank_bn": (loop, "set_process_group", _per_rank_bn)}


def cases(rank, cases):
    groups = [dist.new_group(list(range(c["world"])),
                             timeout=datetime.timedelta(seconds=240))
              for c in cases]
    out = []
    for case, group in zip(cases, groups):
        if rank.rank >= case["world"]:
            out.append(None)
            continue
        nets = []

        def run(**kwargs):
            done = case["fn"](**kwargs)
            nets.append(done.net)
            return done

        owner, name, fault = FAULTS.get(case["fault"], (None, "", None))
        real = getattr(owner, name, None)
        if owner is not None:
            setattr(owner, name, fault)
        try:
            res = _train_rank(Rank(rank.rank, case["world"], rank.device,
                                   group), run, case["kwargs"])
        finally:
            if owner is not None:
                setattr(owner, name, real)
        res["state"] = {k: v.detach().cpu()
                        for k, v in nets[0].state_dict().items()}
        res["tf32"] = (torch.backends.cudnn.allow_tf32,
                       torch.backends.cuda.matmul.allow_tf32)
        res["imports_jax"] = any(m.split(".")[0] in ("jax", "stabstitch2_tpu")
                                 for m in sys.modules)
        out.append(res)
    return out
'''


def tonp(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module", autouse=True)
def rank_timeouts():
    """A rendezvous or collective that hangs fails within JOIN_S or
    GROUP_S."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ptrain, "RANK_TIMEOUT_S", JOIN_S)
        mp.setattr(ptrain, "GROUP_TIMEOUT_S", GROUP_S)
        yield


@pytest.fixture(scope="module")
def train_data(tmp_path_factory):
    """One synthetic clip at 128x160: 17 temporal pairs and 18 spatial
    pairs, two batches of B each."""
    root = tmp_path_factory.mktemp("train")
    data = str(root / "data")
    write_clip_dirs(data, num_frames=20, height=MH, width=MW, seed=30,
                    video_name="v0")
    return root, data


def first_batch(dataset):
    """The first batch of the loops' first epoch (``batch_iterator``)."""
    from stabstitch2_tpu_torch.data.datasets import batch_iterator

    it = batch_iterator(dataset, B, seed=SEED)
    try:
        return next(it)
    finally:
        it.close()


def given_factors(factors, img1, img2):
    """The JAX package's ``data_aug_pair`` with the factors given in place
    of its key: the port's draws fed to the JAX step."""
    b1, b2, c1, c2 = factors
    return (jnp.clip(img1 * b1 * c1, -1.0, 1.0),
            jnp.clip(img2 * b2 * c2, -1.0, 1.0))


def clipped(grads, max_norm=3.0):
    """``optax.clip_by_global_norm``: the gradients as the port's net
    holds them after a step."""
    norm = float(np.sqrt(sum(float((g.double() ** 2).sum())
                             for g in grads.values())))
    scale = 1.0 if norm < max_norm else max_norm / norm
    return {k: (g.double() * scale).float() for k, g in grads.items()}


class JaxStep:
    """One stage's JAX init (carried into a ``step_0.pth`` the loop
    resumes from, :meth:`seeded_dir`) and the JAX package's single-device
    ``value_and_grad`` on the loop's first batch and augmentation draws
    (:meth:`run`)."""

    def __init__(self, stage, data):
        from stabstitch2_tpu import models as jmodels
        from stabstitch2_tpu.config import SpatialTrainConfig as JSpatialCfg
        from stabstitch2_tpu.config import TemporalTrainConfig as JTemporalCfg
        from stabstitch2_tpu.train import spatial as jspatial
        from stabstitch2_tpu.train import temporal as jtemporal
        from stabstitch2_tpu_torch.data.datasets import (SpatialPairDataset,
                                                         TemporalPairDataset)
        from stabstitch2_tpu_torch.models import SpatialNet, TemporalNet
        from stabstitch2_tpu_torch.train.common import draw_aug

        if stage == "temporal":
            self.cfg = TemporalTrainConfig(batch_size=B, max_epoch=1)
            self.j_cfg, self.module = JTemporalCfg(batch_size=B), jtemporal
            self.j_net, self.net = jmodels.TemporalNet(), TemporalNet
            self.mapping = W.temporal_mapping()
            self.loss = jtemporal.temporal_loss_fn
            dataset = TemporalPairDataset(data, self.cfg.train_frame_num,
                                          seed=SEED, model_size=(MH, MW))
        else:
            self.cfg = SpatialTrainConfig(batch_size=B, max_epoch=1)
            self.j_cfg, self.module = JSpatialCfg(batch_size=B), jspatial
            self.j_net, self.net = jmodels.SpatialNet(), SpatialNet
            self.mapping = W.spatial_mapping()
            self.loss = jspatial.spatial_loss_fn
            dataset = SpatialPairDataset(data, training=True, seed=SEED,
                                         model_size=(MH, MW))
        self.stage, self.data = stage, data
        self.batch = first_batch(dataset)
        self.factors = draw_aug(torch.Generator().manual_seed(SEED))
        x = jnp.zeros((1, MH, MW, 3), jnp.float32)
        self.variables = tonp(jax.jit(
            lambda k: self.j_net.init(k, x, x, False))(jax.random.PRNGKey(0)))

    def seeded_dir(self, path):
        """A model directory holding the JAX init as a step-0 checkpoint."""
        from stabstitch2_tpu_torch.train.common import make_optimizer
        from stabstitch2_tpu_torch.utils.checkpoint import TrainCheckpointer

        net = self.net(MH, MW)
        net.load_state_dict(W.flax_to_state_dict(self.variables,
                                                 self.mapping), strict=True)
        opt = make_optimizer(net.parameters(), self.cfg, 1)
        TrainCheckpointer(path).save(0, {
            "model": net.state_dict(), "optimizer": opt.state_dict(),
            "step": 0, "epoch": 0})
        return path

    def kwargs(self, model_dir):
        """The loop's arguments for one step from ``model_dir``."""
        kw = dict(train_path=self.data, cfg=self.cfg, model_dir=model_dir,
                  seed=SEED, max_steps_per_epoch=1, model_h=MH, model_w=MW)
        if self.stage == "spatial":
            kw["test_path"] = None
        return kw

    def run(self):
        """The loss, the clipped gradients and the BatchNorm statistics
        after the step's forward."""
        a, b = (jnp.asarray(x) for x in self.batch)
        factors = tuple(jnp.asarray(f.numpy()) for f in self.factors)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(self.module, "data_aug_pair", given_factors)
            f = jax.jit(jax.value_and_grad(self.loss, has_aux=True),
                        static_argnames=("net", "cfg"))
            (loss, (new_bs, _)), grads = f(
                self.variables["params"], self.variables["batch_stats"],
                self.j_net, a, b, factors, self.j_cfg)
        return {"loss": float(loss),
                "grads": clipped(W.flax_grads_to_named(tonp(grads),
                                                       self.mapping)),
                "buffers": W.flax_to_state_dict(
                    {"params": self.variables["params"],
                     "batch_stats": tonp(new_bs)}, self.mapping)}


def temporal_loop_kwargs(data, model_dir):
    """The loop runs: two epochs of one step from the port's init."""
    return dict(train_path=data, cfg=TemporalTrainConfig(batch_size=B,
                                                         max_epoch=2),
                model_dir=model_dir, seed=SEED, max_steps_per_epoch=1,
                model_h=MH, model_w=MW)


# name: (ranks, stage or the loop runs, planted fault)
CASES = {"temporal-4": (4, "temporal", None),
         "loop-4": (4, "loop", None),
         "temporal-2": (2, "temporal", None),
         "spatial-2": (2, "spatial", None),
         "temporal-2-per-rank-bn": (2, "temporal", "per_rank_bn"),
         "loop-2-no-grad-average": (2, "loop", "no_grad_average")}


@pytest.fixture(scope="module")
def ranks(train_data):
    """Every case of CASES in one spawn of four gloo ranks, the JAX steps
    computed meanwhile: each case's results from its ranks in rank order,
    and each stage's JAX step."""
    import concurrent.futures
    import importlib
    import sys

    from stabstitch2_tpu_torch.train import loop

    root, data = train_data
    steps = {s: JaxStep(s, data) for s in ("temporal", "spatial")}
    probe_dir = root / "probe"
    probe_dir.mkdir()
    (probe_dir / "loop_rank_cases.py").write_text(PROBE)
    cases = []
    for name, (world, stage, fault) in CASES.items():
        model_dir = str(root / name)
        if stage == "loop":
            fn, kwargs = loop.train_temporal, temporal_loop_kwargs(
                data, model_dir)
        else:
            fn = getattr(loop, f"train_{stage}")
            kwargs = steps[stage].kwargs(steps[stage].seeded_dir(model_dir))
        cases.append(dict(world=world, fn=fn, kwargs=kwargs, fault=fault))
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False    # what cli train sets
    sys.path.insert(0, str(probe_dir))          # the ranks inherit it
    try:
        probe = importlib.import_module("loop_rank_cases")
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            spawn = pool.submit(ptrain.run_ranks, probe.cases, [CPU] * 4,
                                (cases,), str(root))
            jax_steps = {s: step.run() for s, step in steps.items()}
            per_rank = spawn.result()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
        sys.path.remove(str(probe_dir))
    return ({name: [r[i] for r in per_rank if r[i] is not None]
             for i, name in enumerate(CASES)}, jax_steps)


def grad_gap(grads, ref):
    """The worst gradient's relative L2 gap over its bound: the trunks
    (``feature_extractor*``) at TRUNK_GRAD_RTOL_L2, the heads at
    GRAD_RTOL_L2 (module docstring)."""
    worst = 0.0
    for k, g in ref.items():
        bound = (TRUNK_GRAD_RTOL_L2 if k.startswith("feature_extractor")
                 else GRAD_RTOL_L2)
        worst = max(worst, rel_l2(grads[k], g) / bound)
    return worst


def excess(res, ref):
    """Rank 0's first step against a JAX step, each gap over its bound:
    (loss, worst gradient, worst BatchNorm statistic)."""
    loss = res["steps"][0][1]["total"]
    stats = 0.0
    for k, r in ref["buffers"].items():
        if k.endswith(("running_mean", "running_var")):
            gap = (res["model"][k] - r).abs() / (BN_RTOL * r.abs().max())
            stats = max(stats, float(gap.max()))
    return (abs(loss - ref["loss"]) / abs(ref["loss"]) / LOSS_RTOL,
            grad_gap(res["grads"], ref["grads"]), stats)


def check_ranks(res, world, steps):
    """A case's ranks: ``world`` of them, none importing JAX, each with
    the caller's TF32 settings and rank 0's state after ``steps`` steps;
    rank 0 alone saved, once."""
    assert len(res) == world
    assert not any(r["imports_jax"] for r in res)
    assert all(r["tf32"] == (False, False) for r in res)   # the caller's
    assert [s for s, _ in res[0]["steps"]] == list(range(1, steps + 1))
    for r in res[1:]:
        for k, v in r["state"].items():
            assert torch.equal(v, res[0]["state"][k]), k
    assert [os.path.basename(p) for p in res[0]["saved"]] == [
        f"step_{steps}.pth"]
    assert all(r["saved"] == [] for r in res[1:])


@pytest.mark.parametrize("name", ["temporal-4", "temporal-2"])
def test_ranks_temporal_step_matches_jax_single_device(ranks, name):
    """The temporal loop's first step on N ranks, resumed from the JAX
    init, against JAX's step on the whole batch with the same draws."""
    res, jax_steps = ranks[0][name], ranks[1]
    check_ranks(res, CASES[name][0], 1)
    assert set(res[0]["grads"]) == set(jax_steps["temporal"]["grads"])
    gap = excess(res[0], jax_steps["temporal"])
    assert max(gap) <= 1.0, (name, gap)


def test_ranks_spatial_step_matches_jax_single_device(ranks):
    """The spatial loop's first step (K1's and K3's autograd paths, the
    global BatchNorm) on two ranks against JAX's step."""
    res, jax_steps = ranks[0]["spatial-2"], ranks[1]
    check_ranks(res, 2, 1)
    assert set(res[0]["grads"]) == set(jax_steps["spatial"]["grads"])
    gap = excess(res[0], jax_steps["spatial"])
    assert max(gap) <= 1.0, gap


def test_planted_per_rank_batchnorm_breaks_the_bounds(ranks):
    """Each rank's own BatchNorm statistics (what ``nn.BatchNorm2d`` under
    DDP keeps): the gradients and the running statistics leave their
    bounds."""
    _, grad, stats = excess(ranks[0]["temporal-2-per-rank-bn"][0],
                            ranks[1]["temporal"])
    assert grad > 1.0 and stats > 1.0, (grad, stats)


def summary(run, steps):
    """A ``TrainRun`` as a rank reports one: the steps' loss terms, the
    weights, the last step's gradients."""
    return {"steps": steps, "model": run.net.state_dict(),
            "grads": {k: p.grad for k, p in run.net.named_parameters()
                      if p.grad is not None}}


def recorder(steps):
    return lambda s, m: steps.append((s, {k: float(v) for k, v in m.items()}))


@pytest.fixture(scope="module")
def one_process(train_data):
    """The loop runs' reference: one process on the whole batches, and
    the init they start from."""
    from stabstitch2_tpu_torch.models import TemporalNet
    from stabstitch2_tpu_torch.models.backbone import init_weights
    from stabstitch2_tpu_torch.train import loop

    root, data = train_data
    steps = []
    run = loop.train_temporal(**temporal_loop_kwargs(data, str(root / "m1")),
                              device="cpu", on_step=recorder(steps))
    net = TemporalNet(MH, MW)
    init_weights(net, torch.Generator().manual_seed(SEED))
    return dict(summary(run, steps), init=net.state_dict())


def rel_l2(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def loop_gaps(res, one):
    """A loop run against one process's, each gap over its bound: (worst
    step loss, and per tensor in relative L2 the worst last-step gradient
    and the worst update theta_after - theta_init)."""
    losses = max(abs(a[1]["total"] - b[1]["total"]) / abs(b[1]["total"])
                 for a, b in zip(res["steps"], one["steps"])) / LOSS_RTOL
    grads = max(rel_l2(res["grads"][k], g) for k, g in one["grads"].items())
    init = one["init"]
    update = max(rel_l2(res["model"][k] - init[k], one["model"][k] - init[k])
                 for k in one["grads"])
    return losses, grads / LOOP_GRAD_RTOL_L2, update / UPDATE_RTOL_L2


def check_params(state, ref):
    """The JAX package's mesh-against-single bound on every float tensor."""
    for k, v in ref.items():
        if v.dtype.is_floating_point:
            np.testing.assert_allclose(state[k].numpy(), v.numpy(),
                                       rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                       err_msg=k)


@pytest.mark.parametrize("name", ["temporal-4"])
def test_ranks_two_steps_match_one_process(ranks, one_process, name):
    """The temporal loop's two steps on four ranks (``run_training``'s
    rank function) against one process."""
    res = ranks[0]["loop-4"]
    check_ranks(res, 4, 2)
    gaps = loop_gaps(res[0], one_process)
    assert max(gaps) <= 1.0, gaps
    check_params(res[0]["model"], one_process["model"])


def test_planted_no_grad_average_breaks_the_bounds(ranks, one_process):
    """Each rank stepping on its own rows' gradients: the loop runs'
    gradient and update bounds fail."""
    _, grads, update = loop_gaps(ranks[0]["loop-2-no-grad-average"][0],
                                 one_process)
    assert grads > 1.0 and update > 1.0, (grads, update)


def test_loop_two_ranks_matches_one_process(one_process, train_data,
                                            monkeypatch):
    """``train_temporal(n_devices=2)`` against one process: the steps'
    losses, the last step's gradients and the update within their bounds,
    the parameters within the JAX package's mesh-against-single bound;
    one checkpoint, written by rank 0 alone. The run outlasts the
    rendezvous bound, which bounds the rendezvous alone."""
    import time

    from stabstitch2_tpu_torch.train import loop

    root, data = train_data
    monkeypatch.setattr(ptrain, "RANK_TIMEOUT_S", RENDEZVOUS_S)
    steps = []
    t0 = time.perf_counter()
    two = loop.train_temporal(**temporal_loop_kwargs(data, str(root / "m2")),
                              n_devices=2, device="cpu",
                              on_step=recorder(steps))
    assert time.perf_counter() - t0 > RENDEZVOUS_S
    path = two.checkpointer.path(2)
    assert two.saved_by_rank == [[path], []]
    assert two.checkpointer.steps() == [2] and two.opt.step_count == 2
    assert [s for s, _ in steps] == [1, 2]
    assert [set(n) for n in two.launches_by_rank] == [
        {"cost_volume", "fused_warp", "tps_coords", "patch_gather"}] * 2
    gaps = loop_gaps(summary(two, steps), one_process)
    assert max(gaps) <= 1.0, gaps
    saved = torch.load(path, weights_only=True)["model"]
    for k, v in two.net.state_dict().items():
        assert torch.equal(saved[k], v), k
    check_params(saved, one_process["model"])
    assert not [f for f in os.listdir(root / "m2")
                if f.startswith(".rendezvous_")]
