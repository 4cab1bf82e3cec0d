"""The smooth trainer, the port against the JAX package and the reference.

- One step at 128x160, B=2, L=8 (two shifted 7-frame windows): the same
  random SmoothNet weights (JAX init carried across), the same seeded
  motions and synthetic frames; one jitted ``value_and_grad`` of the JAX
  loss (module fixture) against the port's loss and ``backward``: the
  total and each term within 1e-4 relative, every parameter's gradient
  within 1e-2 relative L2.

  The motions are drawn at a tenth of a mesh cell (temporal 0.5 px,
  spatial 2 px on 20-px cells). At the 2 px / 8 px of
  tests/test_train.py's smoke step the meshes fold, and both packages'
  float32 TPS solves sit 1-2e-4 from the port run in float64 on the
  warped terms (align, trajectory), so the two differ by 3.3e-4. The
  gradient is ill-conditioned in float32 either way (the align term's
  L1, weighted 1000, through bilinear samples): at these inputs the JAX
  gradient is 2.9e-3 and the port's 2.6e-3 from the float64 port's, and
  the two 3.5e-3 apart; hence 1e-2.
- The six-term loss at 360x480 on ``goldens/smoothloss_parity.npz`` (the
  reference's own loss block with its weights): each term within 2e-3
  relative of the reference (tests/test_train.py's bound) and within 1e-4
  of the JAX package's.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stabstitch2_tpu.config import SmoothTrainConfig as JSmoothCfg
from stabstitch2_tpu.models import SmoothNet as JSmoothNet
from stabstitch2_tpu.train.smooth import smooth_loss_fn as j_smooth_loss
from stabstitch2_tpu.utils import torch_import as ti
from stabstitch2_tpu_torch.config import SmoothTrainConfig
from stabstitch2_tpu_torch.models import SmoothNet
from stabstitch2_tpu_torch.train.smooth import smooth_loss_fn
from stabstitch2_tpu_torch.utils import weights as W

from synthetic import make_two_view_clip

MH, MW = 128, 160
TERMS = ("total", "data", "smoothness", "shape", "trajectory", "online",
         "align")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tonp(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def step():
    B, L = 2, 8
    rng = np.random.default_rng(0)
    v1, v2 = make_two_view_clip(num_frames=L, height=MH, width=MW, seed=2)
    to = lambda v: (v.astype(np.float32) / 127.5 - 1.0)[None]  # noqa: E731
    batch = (rng.normal(0, 0.5, (B, L, 7, 9, 2)).astype(np.float32),
             rng.normal(0, 0.5, (B, L, 7, 9, 2)).astype(np.float32),
             rng.normal(0, 2.0, (B, L, 7, 9, 2)).astype(np.float32),
             rng.normal(0, 2.0, (B, L, 7, 9, 2)).astype(np.float32),
             np.tile(to(v1), (B, 1, 1, 1, 1)), np.tile(to(v2), (B, 1, 1, 1, 1)))
    j_net = JSmoothNet()
    mesh = jnp.zeros((1, 7, 7, 9, 2))
    variables = tonp(j_net.init(jax.random.PRNGKey(0), mesh, mesh, mesh, mesh))
    f = jax.jit(jax.value_and_grad(j_smooth_loss, has_aux=True),
                static_argnames=("net", "cfg"))
    (_, j_metrics), grads = f(variables["params"], j_net,
                              tuple(jnp.asarray(x) for x in batch),
                              JSmoothCfg(frame_num=7, train_sqe=2))
    net = SmoothNet()
    net.load_state_dict(W.flax_to_state_dict(variables, W.smooth_mapping()),
                        strict=True)
    total, metrics = smooth_loss_fn(net, [torch.from_numpy(x) for x in batch],
                                    SmoothTrainConfig(frame_num=7,
                                                      train_sqe=2))
    total.backward()
    return {"net": net, "metrics": metrics, "j_metrics": tonp(j_metrics),
            "j_grads": W.flax_grads_to_named(tonp(grads),
                                             W.smooth_mapping())}


@pytest.mark.parametrize("term", TERMS)
def test_step_loss_terms(step, term):
    got = float(step["metrics"][term])
    ref = float(step["j_metrics"][term])
    assert abs(got - ref) <= 1e-4 * abs(ref), (got, ref)


def test_step_every_gradient(step):
    params = dict(step["net"].named_parameters())
    assert set(params) == set(step["j_grads"])
    rel = {}
    for k, p in params.items():
        ref = step["j_grads"][k].double()
        assert float(ref.norm()) > 0, k
        rel[k] = float((p.grad.double() - ref).norm() / ref.norm())
    assert max(rel.values()) <= 1e-2, rel


@pytest.fixture(scope="module")
def golden_losses(goldens):
    """The six terms at 360x480 from the golden's reference weights and
    batch, through the port and through the JAX package."""
    g = goldens("smoothloss_parity")
    sd = {k[len("sd::"):]: g[k] for k in g.files if k.startswith("sd::")}
    tb = lambda x: np.ascontiguousarray(np.swapaxes(x, 0, 1))  # noqa: E731
    ib = lambda x: np.ascontiguousarray(  # noqa: E731
        np.transpose(x, (1, 0, 3, 4, 2)))
    batch = (tb(g["tmotion1"]), tb(g["tmotion2"]), tb(g["smotion1"]),
             tb(g["smotion2"]), ib(g["img1"]), ib(g["img2"]))
    params, _ = ti.convert_state_dict(sd, ti.smooth_mapping())
    # jitted: one compile costs less than the eager loss at 360x480
    j_loss = jax.jit(j_smooth_loss, static_argnames=("net", "cfg"))
    _, j_metrics = j_loss(params, JSmoothNet(),
                          tuple(jnp.asarray(x) for x in batch),
                          JSmoothCfg(frame_num=7, train_sqe=2))
    net = SmoothNet()
    net.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()
                         if not k.startswith("MotionPre.embedding2.")},
                        strict=True)
    with torch.no_grad():
        _, metrics = smooth_loss_fn(net, [torch.from_numpy(x) for x in batch],
                                    SmoothTrainConfig(frame_num=7,
                                                      train_sqe=2))
    return g, metrics, tonp(j_metrics)


@pytest.mark.parametrize("term", TERMS)
def test_six_terms_against_reference_and_jax(golden_losses, term):
    g, got, ref = golden_losses
    np.testing.assert_allclose(float(got[term]), float(g[term]), rtol=2e-3)
    np.testing.assert_allclose(float(got[term]), float(ref[term]), rtol=1e-4)
