"""The trainers' image panels, the port's loop against the JAX package's,
on the CPU.

Both loops resume from a ``step_299`` checkpoint of the same random
weights (a JAX init carried across with ``utils/weights.py``) and take
one step, so the run crosses step 300, where the writer gets the first
sample's panels from the net in eval mode. The steps themselves are
replaced on both sides by ones that only count (the steps are held
against JAX in ``tests/test_torch_train_steps.py``), so both loops draw
their panels from the same weights and the same batch (cv2 decodes on
both sides); a stub writer records what each loop writes. Keys and steps
must be equal; the pixels within 1e-4 (the bound of the homography warp
in ``tests/test_torch_train_ops.py``). After the run the port's net is
in train mode and its state, BatchNorm statistics included, is the
checkpoint's: the panels moved nothing.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stabstitch2_tpu.config import (SpatialTrainConfig as JSpatialCfg,
                                    TemporalTrainConfig as JTemporalCfg)
from stabstitch2_tpu.data import native as j_native
from stabstitch2_tpu.models import SpatialNet as JSpatialNet
from stabstitch2_tpu.models import TemporalNet as JTemporalNet
from stabstitch2_tpu.train import loop as jloop
from stabstitch2_tpu.train.common import create_train_state
from stabstitch2_tpu.utils.checkpoint import TrainCheckpointer as JCheckpointer
from stabstitch2_tpu_torch.config import (SpatialTrainConfig,
                                          TemporalTrainConfig)
from stabstitch2_tpu_torch.data import native as t_native
from stabstitch2_tpu_torch.models import SpatialNet, TemporalNet
from stabstitch2_tpu_torch.train import loop
from stabstitch2_tpu_torch.train import spatial as t_spatial
from stabstitch2_tpu_torch.train import temporal as t_temporal
from stabstitch2_tpu_torch.train.common import make_optimizer
from stabstitch2_tpu_torch.utils import weights as W
from stabstitch2_tpu_torch.utils.checkpoint import TrainCheckpointer

from synthetic import write_clip_dirs

MH, MW = 128, 160
PIXEL_ATOL = 1e-4


class StubWriter:
    """Records ``add_image`` calls: (key, step, HWC array)."""

    def __init__(self):
        self.images = []

    def add_scalar(self, *args):
        pass

    def add_image(self, key, img, step, dataformats):
        assert dataformats == "HWC"
        self.images.append((key, int(step), np.asarray(img)))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("panel_tree"))
    for seed in range(2):
        write_clip_dirs(root, num_frames=6, height=MH, width=MW, seed=seed,
                        video_name=f"v{seed}")
    return root


STAGES = {
    "spatial": (JSpatialNet, SpatialNet, JSpatialCfg, SpatialTrainConfig,
                W.spatial_mapping, t_spatial, "spatial_train_step"),
    "temporal": (JTemporalNet, TemporalNet, JTemporalCfg, TemporalTrainConfig,
                 W.temporal_mapping, t_temporal, "temporal_train_step"),
}


@pytest.mark.parametrize("stage", list(STAGES))
def test_panels_match_jax(stage, tree, tmp_path, monkeypatch):
    j_net_cls, net_cls, j_cfg_cls, cfg_cls, mapping, t_mod, step_name = (
        STAGES[stage])
    monkeypatch.setattr(j_native, "available", lambda: False)
    monkeypatch.setattr(t_native, "available", lambda: False)
    img = jnp.zeros((1, MH, MW, 3))
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k: j_net_cls().init(k, img, img, False))(
            jax.random.PRNGKey(0)))

    # step_299 checkpoints of the same weights, one per package
    j_cfg = j_cfg_cls(batch_size=2, max_epoch=300)
    state = create_train_state(variables, j_cfg, 1)
    JCheckpointer(str(tmp_path / "jax")).save(299, {
        "params": state.params, "batch_stats": state.batch_stats,
        "opt_state": state.opt_state, "step": jnp.asarray(299, jnp.int32)})
    cfg = cfg_cls(batch_size=2, max_epoch=300)
    net = net_cls(MH, MW)
    net.load_state_dict(W.flax_to_state_dict(variables, mapping()),
                        strict=True)
    opt = make_optimizer(net.parameters(), cfg, 1)
    opt.step_count = 299
    saved = {k: v.clone() for k, v in net.state_dict().items()}
    TrainCheckpointer(str(tmp_path / "port")).save(299, {
        "model": saved, "optimizer": opt.state_dict(), "step": 299,
        "epoch": 299})

    def port_step(net, opt, *args):
        opt.step_count += 1
        return {"total": torch.zeros(())}

    monkeypatch.setattr(t_mod, step_name, port_step)
    monkeypatch.setattr(jloop, step_name, lambda st, *a: (
        st.replace(step=st.step + 1), {"total": jnp.zeros(())}))
    writers = {"jax": StubWriter(), "port": StubWriter()}
    monkeypatch.setattr(jloop, "_writer", lambda d: writers["jax"])
    monkeypatch.setattr(loop, "_writer", lambda d: writers["port"])
    common = dict(summary_dir="unused", max_steps_per_epoch=1, model_h=MH,
                  model_w=MW)
    getattr(jloop, f"train_{stage}")(tree, cfg=j_cfg,
                                     model_dir=str(tmp_path / "jax"), **common)
    run = getattr(loop, f"train_{stage}")(tree, cfg=cfg,
                                          model_dir=str(tmp_path / "port"),
                                          device="cpu", **common)

    want, got = writers["jax"].images, writers["port"].images
    assert [(k, s) for k, s, _ in got] == [(k, s) for k, s, _ in want]
    assert len(got) == (4 if stage == "spatial" else 3)
    assert {s for _, s, _ in got} == {300}
    for (key, _, g), (_, _, w) in zip(got, want):
        assert g.shape == w.shape == (MH, MW, 3) and g.dtype == np.float32
        assert 0 <= g.min() and g.max() <= 1 and g.std() > 0.01, key
        np.testing.assert_allclose(g, w, rtol=0, atol=PIXEL_ATOL,
                                   err_msg=key)
    assert run.net.training
    for k, v in run.net.state_dict().items():
        assert torch.equal(v, saved[k]), k


def test_smooth_writes_no_panels(tmp_path, monkeypatch):
    """The smooth loop, resumed at step 299 and run past step 300, writes
    no panels (as in JAX)."""
    from stabstitch2_tpu_torch.config import SmoothTrainConfig
    from stabstitch2_tpu_torch.models import SmoothNet
    from stabstitch2_tpu_torch.train import smooth as t_smooth

    root = str(tmp_path / "data")
    rng = np.random.default_rng(0)
    vd = write_clip_dirs(root, num_frames=12, height=MH, width=MW, seed=3)
    for name in ("TemporalMotion1", "TemporalMotion2", "SpatialMotion1",
                 "SpatialMotion2"):
        (tmp_path / "data" / "clip0" / name).mkdir()
        for f in range(12):
            np.save(f"{vd}/{name}/{f:06d}.npy",
                    rng.normal(0, 3, (7, 9, 2)).astype(np.float32))
    cfg = SmoothTrainConfig(batch_size=1, max_epoch=300)
    net = SmoothNet()
    opt = make_optimizer(net.parameters(), cfg, 1)
    opt.step_count = 299
    TrainCheckpointer(str(tmp_path / "m")).save(299, {
        "model": net.state_dict(), "optimizer": opt.state_dict(),
        "step": 299, "epoch": 299})
    monkeypatch.setattr(t_smooth, "smooth_train_step",
                        lambda net, opt, *a: setattr(
                            opt, "step_count", opt.step_count + 1) or {})
    writer = StubWriter()
    monkeypatch.setattr(loop, "_writer", lambda d: writer)
    run = loop.train_smooth(root, cfg, model_dir=str(tmp_path / "m"),
                            summary_dir="unused", max_steps_per_epoch=1,
                            model_h=MH, model_w=MW, device="cpu")
    assert run.opt.step_count == 300 and writer.images == []
