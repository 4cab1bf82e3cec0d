"""The trainers' steps as a host part and a device body (``train/common.py``)
that the loops capture as one CUDA graph on the card, held on the CPU.

A CPU cannot capture, so these tests hold what a capture needs and what a
replay must reproduce:

- **No host synchronization in the body.** Each stage's body runs under a
  ``TorchDispatchMode`` that records ``aten._local_scalar_dense``
  (``.item()``, ``float(t)``), ``aten.is_nonzero`` (a branch on a tensor)
  and ``aten.nonzero``: none may appear. Adam is left out of the mode
  (run right after it): on the CPU it is not ``capturable`` and reads its
  step with ``.item()``; on the card ``capturable=True`` and the capture
  itself holds it (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase
  ``train``). The mode covers the rest: forward, backward, clip and the
  device-side rate.
- **No Python state moves in the body**: ``opt.step_count`` and the
  kernels' ``LAUNCHES`` stay as they were.
- **The device-side rate** (``Optimizer.rate``) equals ``Optimizer.lr``
  (float64, rounded to float32) exactly and optax's
  ``exponential_decay(staircase=True)`` within 1 float32 ulp, across two
  epoch boundaries and after a save and resume; Adam's update takes it.
- **The step against JAX's jitted ``*_train_step``** (the package's own
  jitted functions; one call per stage and module, at 128x160 and B=2 as
  ``tests/test_torch_train_steps.py`` and ``test_torch_train_smooth.py``,
  the same random weights, carried to JAX with ``utils/torch_import.py:
  convert_state_dict``; spatial on JAX's augmentation draws through
  ``apply_aug``): the loss terms within 1e-4 relative; the gradients, read
  as Adam's first moment ``(1 - b1) * clip(g)`` on both sides, within the
  per-parameter relative L2 bounds of those files (1e-3; the spatial
  trunk 3e-2, the smooth net 1e-2, for the float32 conditioning their
  docstrings measure); the BatchNorm statistics within 1e-5; the updated
  parameters as Adam's first step leaves them, within the bounds on an
  Adam step of ``tests/test_torch_parallel.py`` (module constants below).
- **The loops' plumbing**: ``loop.train_temporal`` with
  ``capture_step=True`` and ``False`` gives identical state dicts.
"""

import collections
import io

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from stabstitch2_tpu.config import SmoothTrainConfig as JSmoothCfg
from stabstitch2_tpu.config import SpatialTrainConfig as JSpatialCfg
from stabstitch2_tpu.config import TemporalTrainConfig as JTemporalCfg
from stabstitch2_tpu.models import SmoothNet as JSmoothNet
from stabstitch2_tpu.models import SpatialNet as JSpatialNet
from stabstitch2_tpu.models import TemporalNet as JTemporalNet
from stabstitch2_tpu.train.common import create_train_state
from stabstitch2_tpu.train.smooth import smooth_train_step as j_smooth_step
from stabstitch2_tpu.train.spatial import spatial_train_step as j_spatial_step
from stabstitch2_tpu.train.temporal import (temporal_train_step as
                                            j_temporal_step)
from stabstitch2_tpu.utils import torch_import as ti
from stabstitch2_tpu_torch.config import (SmoothTrainConfig,
                                          SpatialTrainConfig,
                                          TemporalTrainConfig, TrainConfig)
from stabstitch2_tpu_torch.models import SmoothNet, SpatialNet, TemporalNet
from stabstitch2_tpu_torch.models.backbone import init_weights
from stabstitch2_tpu_torch.train.common import make_optimizer
from stabstitch2_tpu_torch.train.smooth import smooth_step_body
from stabstitch2_tpu_torch.train.spatial import spatial_step_body
from stabstitch2_tpu_torch.train.temporal import temporal_step_body
from stabstitch2_tpu_torch.utils import graphs
from stabstitch2_tpu_torch.utils import weights as W

from synthetic import make_two_view_clip, write_clip_dirs
from test_torch_train_ops import jax_factors

MH, MW, B = 128, 160, 2
STEPS_PER_EPOCH = 2
LOSS_RTOL = 1e-4
GRAD_RTOL_L2 = 1e-3
SPATIAL_TRUNK_GRAD_RTOL_L2 = 3e-2
SMOOTH_GRAD_RTOL_L2 = 1e-2
BN_RTOL = 1e-5
# tests/test_torch_parallel.py's bound on the update after an Adam step,
# and the JAX package's mesh-against-single bound on the parameters
# (tests/test_entry_and_multiview.py::TestTrainerOnMesh)
UPDATE_RTOL_L2 = 0.4
PARAM_RTOL, PARAM_ATOL = 2e-3, 5e-4
SYNC_OPS = ("aten._local_scalar_dense", "aten.is_nonzero", "aten.nonzero")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread, as ``tests/test_torch_train_steps.py`` runs
    (its docstring: two threads read the trunk's backward ~1e-3 off)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def quick_jax_compiles():
    """XLA's optimizations off for this module's three step programs."""
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", False)


class HostSyncs(TorchDispatchMode):
    """Records every operator that reads a tensor's value on the host."""

    def __init__(self):
        super().__init__()
        self.seen = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func.overloadpacket)
        if name in SYNC_OPS:
            self.seen[name] += 1
        return func(*args, **(kwargs or {}))


def tonp(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def run_body(body, inputs, opt):
    """``body(*inputs)`` with Adam's step deferred, under
    :class:`HostSyncs`; then Adam's step. Returns the loss terms, the
    host syncs seen, and whether the step count or a kernel's launches
    moved."""
    steps = opt.step_count
    launches = [collections.Counter(m.LAUNCHES) for m in graphs.COUNTED]
    deferred = []
    opt.adam.step = lambda *a, **k: deferred.append(1)
    try:
        with HostSyncs() as mode:
            metrics = body(*inputs)
    finally:
        del opt.adam.step
    assert deferred == [1]
    opt.adam.step()
    moved = (opt.step_count != steps
             or launches != [collections.Counter(m.LAUNCHES)
                             for m in graphs.COUNTED])
    return {k: float(v) for k, v in metrics.items()}, mode.seen, moved


def jax_variables(net, mapping):
    params, stats = ti.convert_state_dict(
        {k: v.numpy().copy() for k, v in net.state_dict().items()}, mapping,
        strict=True)
    return ({"params": params, "batch_stats": stats} if stats
            else {"params": params})


def pair(seed):
    v1, v2 = make_two_view_clip(num_frames=2, height=MH, width=MW,
                                overlap=0.6, shake_px=2.0, seed=seed)
    return (v1.astype(np.float32) / 127.5 - 1.0,
            v2.astype(np.float32) / 127.5 - 1.0)


def smooth_batch():
    """``tests/test_torch_train_smooth.py``'s step inputs: B=2, L=8,
    motions at a tenth of a mesh cell."""
    L = 8
    rng = np.random.default_rng(0)
    v1, v2 = make_two_view_clip(num_frames=L, height=MH, width=MW, seed=2)
    to = lambda v: (v.astype(np.float32) / 127.5 - 1.0)[None]  # noqa: E731
    return (rng.normal(0, 0.5, (B, L, 7, 9, 2)).astype(np.float32),
            rng.normal(0, 0.5, (B, L, 7, 9, 2)).astype(np.float32),
            rng.normal(0, 2.0, (B, L, 7, 9, 2)).astype(np.float32),
            rng.normal(0, 2.0, (B, L, 7, 9, 2)).astype(np.float32),
            np.tile(to(v1), (B, 1, 1, 1, 1)),
            np.tile(to(v2), (B, 1, 1, 1, 1)))


def stage_case(name):
    """One step of the stage's body in the port (:func:`run_body`) and one
    of JAX's jitted step on the same weights and inputs."""
    if name == "spatial":
        net, mapping = SpatialNet(MH, MW), W.spatial_mapping()
        cfg, j_cfg = SpatialTrainConfig(batch_size=B), JSpatialCfg(
            batch_size=B)
        key = jax.random.PRNGKey(1)
        inputs = pair(0)
        factors = jax_factors(key)
        make_body, j_net = spatial_step_body, JSpatialNet()

        def j_step(state):
            return j_spatial_step(state, *map(jnp.asarray, inputs), key,
                                  j_net, j_cfg)
    elif name == "temporal":
        net, mapping = TemporalNet(MH, MW), W.temporal_mapping()
        cfg, j_cfg = TemporalTrainConfig(batch_size=B), JTemporalCfg(
            batch_size=B)
        key = jax.random.PRNGKey(2)
        inputs = pair(4)
        factors = jax_factors(key)
        make_body, j_net = temporal_step_body, JTemporalNet()

        def j_step(state):
            return j_temporal_step(state, *map(jnp.asarray, inputs), key,
                                   j_net, j_cfg)
    else:
        net, mapping = SmoothNet(), W.smooth_mapping()
        cfg = SmoothTrainConfig(batch_size=B, frame_num=7, train_sqe=2)
        j_cfg = JSmoothCfg(batch_size=B, frame_num=7, train_sqe=2)
        inputs = smooth_batch()
        factors = ()
        make_body, j_net = smooth_step_body, JSmoothNet()

        def j_step(state):
            return j_smooth_step(state, tuple(map(jnp.asarray, inputs)),
                                 j_net, j_cfg)

    init_weights(net, torch.Generator().manual_seed(0))
    variables = jax_variables(net, mapping)
    net.train()
    before = {k: v.detach().clone() for k, v in net.named_parameters()}
    opt = make_optimizer(net.parameters(), cfg, STEPS_PER_EPOCH)
    body = make_body(net, opt, cfg)
    metrics, seen, moved = run_body(
        body, tuple(torch.from_numpy(x) for x in inputs) + tuple(factors),
        opt)
    state = create_train_state(variables, j_cfg, STEPS_PER_EPOCH)
    new_state, j_metrics = j_step(state)
    adam = new_state.opt_state[1]
    j_vars = {"params": tonp(new_state.params)}
    if "batch_stats" in variables:
        j_vars["batch_stats"] = tonp(new_state.batch_stats)
    return {"net": net, "opt": opt, "before": before, "metrics": metrics,
            "seen": seen, "moved": moved, "j_metrics": tonp(j_metrics),
            "j_mu": W.flax_grads_to_named(tonp(adam.mu), mapping),
            "j_after": W.flax_to_state_dict(j_vars, mapping)}


@pytest.fixture(scope="module")
def spatial():
    return stage_case("spatial")


@pytest.fixture(scope="module")
def temporal():
    return stage_case("temporal")


@pytest.fixture(scope="module")
def smooth():
    return stage_case("smooth")


STAGES = ["spatial", "temporal", "smooth"]


@pytest.mark.parametrize("name", STAGES)
def test_body_makes_no_host_sync_and_moves_no_python_state(request, name):
    c = request.getfixturevalue(name)
    assert not c["seen"], dict(c["seen"])
    assert not c["moved"]
    assert c["opt"].step_count == 0 and int(c["opt"].count) == 1


@pytest.mark.parametrize("name", STAGES)
def test_body_loss_terms_equal_the_jax_step(request, name):
    c = request.getfixturevalue(name)
    assert set(c["metrics"]) == set(c["j_metrics"])
    for k, v in c["j_metrics"].items():
        got = c["metrics"][k]
        assert abs(got - float(v)) <= LOSS_RTOL * abs(float(v)) + 1e-7, (
            k, got, float(v))


def grad_bound(name, param):
    if name == "smooth":
        return SMOOTH_GRAD_RTOL_L2
    if name == "spatial" and param.startswith("feature_extractor"):
        return SPATIAL_TRUNK_GRAD_RTOL_L2
    return GRAD_RTOL_L2


@pytest.mark.parametrize("name", STAGES)
def test_body_gradients_equal_the_jax_step(request, name):
    """Adam's first moment after one step, ``(1 - b1) * clip(g)``, on both
    sides: the clipped gradients."""
    c = request.getfixturevalue(name)
    params = dict(c["net"].named_parameters())
    assert set(params) == set(c["j_mu"])
    bad = {}
    for k, p in params.items():
        got = c["opt"].adam.state[p]["exp_avg"].double()
        ref = c["j_mu"][k].double()
        gap = float((got - ref).norm() / ref.norm())
        if not gap <= grad_bound(name, k):
            bad[k] = gap
    assert not bad, bad


@pytest.mark.parametrize("name", STAGES)
def test_body_update_equals_the_jax_step(request, name):
    """Adam's first step moves each weight by the rate times the sign of
    its gradient, so a rounding-level difference in a near-zero gradient
    moves that weight by twice the rate: the update theta_after -
    theta_init per tensor within UPDATE_RTOL_L2 of JAX's (relative L2),
    no entry by more than the rate, the parameters within PARAM_RTOL /
    PARAM_ATOL; the BatchNorm statistics within BN_RTOL of each layer's
    largest."""
    c = request.getfixturevalue(name)
    sd = c["net"].state_dict()
    lr = TrainConfig().learning_rate
    bad = {}
    for k, p0 in c["before"].items():
        got, ref = sd[k] - p0, c["j_after"][k] - p0
        # the rate, and the rounding of theta_init + update in float32
        ulps = 2 * torch.finfo(torch.float32).eps * float(p0.abs().max())
        assert float(got.abs().max()) <= lr * (1 + 1e-5) + ulps, k
        gap = float((got - ref).norm() / ref.norm())
        if not gap <= UPDATE_RTOL_L2:
            bad[k] = gap
        np.testing.assert_allclose(sd[k].numpy(), c["j_after"][k].numpy(),
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=k)
    assert not bad, bad
    stats = [k for k in c["j_after"] if k.endswith(("running_mean",
                                                    "running_var"))]
    assert len(stats) == {"spatial": 30, "temporal": 20, "smooth": 0}[name]
    for k in stats:
        ref = c["j_after"][k].numpy()
        np.testing.assert_allclose(sd[k].numpy(), ref, rtol=BN_RTOL,
                                   atol=BN_RTOL * np.abs(ref).max(),
                                   err_msg=k)


def test_device_rate_follows_the_staircase_and_resumes():
    """Six updates at two steps per epoch (boundaries before updates 2 and
    4), the optimizer saved after update 3 and restored into a new one;
    a checkpoint without the device count restores it from the step."""
    import optax

    cfg = TrainConfig()
    schedule = optax.exponential_decay(cfg.learning_rate, STEPS_PER_EPOCH,
                                       cfg.lr_decay_per_epoch,
                                       staircase=True)
    p = torch.nn.Parameter(torch.zeros(4))     # updates stay exact-ish
    opt = make_optimizer([p], cfg, STEPS_PER_EPOCH)
    for step in range(6):
        if step == 3:
            buf = io.BytesIO()
            torch.save(opt.state_dict(), buf)
            p = torch.nn.Parameter(p.detach().clone())
            opt = make_optimizer([p], cfg, STEPS_PER_EPOCH)
            assert float(opt.rate()) == np.float32(cfg.learning_rate)
            opt.load_state_dict(torch.load(io.BytesIO(buf.getvalue())))
            assert opt.step_count == 3 and opt.loads == 1
        rate = opt.rate()
        assert rate.dtype == torch.float32 and rate.device == p.device
        assert float(rate) == np.float32(opt.lr(step)), step
        want = np.float32(schedule(step))
        assert abs(float(rate) - want) <= np.spacing(want), step
        before = p.detach().clone()
        p.grad = torch.full_like(p, 0.5)
        opt.step()
        # the first update with a constant gradient moves by the rate
        # (m_hat / sqrt(v_hat) = 1); later ones too (the moments stay g)
        np.testing.assert_allclose((before - p.detach()).numpy(),
                                   float(rate), rtol=1e-5)
    assert int(opt.count) == opt.step_count == 6
    legacy = opt.state_dict()
    del legacy["count"]
    fresh = make_optimizer([torch.nn.Parameter(torch.ones(4))], cfg,
                           STEPS_PER_EPOCH)
    fresh.load_state_dict(legacy)
    assert int(fresh.count) == 6
    assert float(fresh.rate()) == np.float32(fresh.lr(6))


def test_loop_captured_and_eager_steps_equal(tmp_path):
    """``capture_step`` True and False run the same body: the same state
    after two epochs of two steps."""
    from stabstitch2_tpu_torch.train import loop

    root = str(tmp_path / "data")
    write_clip_dirs(root, num_frames=7, height=MH, width=MW, seed=0)
    cfg = TemporalTrainConfig(batch_size=2, max_epoch=2)
    runs = [loop.train_temporal(root, cfg, model_dir=str(tmp_path / str(c)),
                                max_steps_per_epoch=2, model_h=MH,
                                model_w=MW, device="cpu", capture_step=c)
            for c in (True, False)]
    assert runs[0].graphs is not None and runs[1].graphs is None
    assert runs[0].graphs.captures == 0 and len(runs[0].graphs) == 0
    assert runs[0].opt.step_count == runs[1].opt.step_count == 4
    a, b = (r.net.state_dict() for r in runs)
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    for r in runs:
        assert int(r.opt.count) == 4


@pytest.mark.parametrize("pause_s", [0.0, 0.5])
def test_capped_epoch_draws_only_its_batches(tmp_path, pause_s):
    """A capped epoch's prefetch thread draws from the dataset's generator
    for the epoch's batches only (``batch_iterator``'s ``limit``), however
    long the consumer takes over a step: the captured step leaves the host
    idle sooner than the eager one, and the next epoch's samples must not
    depend on it. The generator ends where making the first batch's items
    by hand leaves it."""
    import time

    from stabstitch2_tpu_torch.data.datasets import (TemporalPairDataset,
                                                     batch_iterator)

    root = str(tmp_path / "data")
    write_clip_dirs(root, num_frames=12, height=MH, width=MW, seed=1)
    ds = TemporalPairDataset(root, 4, seed=0, model_size=(MH, MW))
    assert len(ds) >= 8
    it = batch_iterator(ds, 2, seed=3, limit=1)
    next(it)
    time.sleep(pause_s)     # room for a thread that would run ahead
    it.close()
    ref = TemporalPairDataset(root, 4, seed=0, model_size=(MH, MW))
    order = np.arange(len(ref))
    np.random.default_rng(3).shuffle(order)
    for i in order[:2]:
        ref[int(i)]
    assert ds.rng.bit_generator.state == ref.rng.bit_generator.state
