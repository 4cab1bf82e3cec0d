"""The port's models against the reference goldens and the JAX package.

The golden fixtures carry the reference state_dicts under ``sd::`` keys;
the port's modules are named like the reference, so the state_dicts load
as they are. Random-weight JAX models are carried across with
``utils/weights.py:from_jax_params``, and that converter is checked as the
inverse of the JAX package's ``utils/torch_import.py:convert_state_dict``.
Tolerances are those of ``tests/test_models.py``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stabstitch2_tpu.models.spatial import spatial_motions as j_spatial_motions
from stabstitch2_tpu.models.temporal import TemporalNet as JTemporalNet
from stabstitch2_tpu.models.smooth import smooth_outputs as j_smooth_outputs
from stabstitch2_tpu.pipeline.stitcher import init_stitcher as j_init_stitcher
from stabstitch2_tpu.utils import torch_import as ti
from stabstitch2_tpu_torch.models import SmoothNet, SpatialNet, TemporalNet
from stabstitch2_tpu_torch.models.backbone import (ConvHead, MLPHead,
                                                   ResNetStage1, init_weights)
from stabstitch2_tpu_torch.models.smooth import smooth_outputs
from stabstitch2_tpu_torch.models.spatial import spatial_motions
from stabstitch2_tpu_torch.utils.weights import from_jax_params

MH, MW = 128, 160


@torch.no_grad()
def clip_motions(net, frames):
    """Whole-clip motions [T, GH+1, GW+1, 2] of frames [T, H, W, 3], with a
    zero motion for frame 0 (reference ``build_TemporalNet``)."""
    feats = net.features(frames)
    motion = net.motion_from_features(feats[:-1], feats[1:])
    return torch.cat([torch.zeros_like(motion[:1]), motion], 0)


def unpack_sd(golden, prefix="", drop=()):
    return {k[len("sd::") + len(prefix):]: torch.from_numpy(np.array(golden[k]))
            for k in golden.files
            if k.startswith("sd::" + prefix)
            and not any(k.startswith("sd::" + d) for d in drop)}


def nhwc(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 2, 3, 1))))


def loaded(net, sd):
    net.load_state_dict(sd, strict=True)
    return net.eval()


class TestGoldens:
    def test_stage1(self, goldens):
        g = goldens("stage1_parity")
        net = loaded(ResNetStage1(), unpack_sd(g, "feature_extractor_stage1."))
        with torch.no_grad():
            out = net(nhwc(g["x"]))
        np.testing.assert_allclose(out.numpy(), np.transpose(g["y"], (0, 2, 3, 1)),
                                   rtol=1e-3, atol=1e-3)

    def test_conv_fc_head(self, goldens):
        g = goldens("head_parity")
        conv = loaded(ConvHead(49, (64, 128, 128, 256)),
                      unpack_sd(g, "regressNet2_part1."))
        fc = loaded(MLPHead((256 * 2 * 3, 1024, 512, 126)),
                    unpack_sd(g, "regressNet2_part2."))
        with torch.no_grad():
            out = fc(conv(nhwc(g["x"])))
        np.testing.assert_allclose(out.numpy(), g["y"], rtol=2e-3, atol=2e-3)

    def test_spatialnet_forward_and_motions(self, goldens):
        g = goldens("spatialnet_parity")
        net = loaded(SpatialNet(), unpack_sd(g))
        with torch.no_grad():
            off1, mref, mtgt = net(nhwc(g["img1"]), nhwc(g["img2"]))
            out = spatial_motions(off1, mref, mtgt, 360, 480)
        B = g["offset_ref"].shape[0]
        np.testing.assert_allclose(off1.numpy(), g["offset1"], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(mref.numpy().reshape(B, -1), g["offset_ref"],
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(mtgt.numpy().reshape(B, -1), g["offset_tgt"],
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(out["motion1"].numpy(), g["motion1"],
                                   rtol=1e-4, atol=2e-4)
        np.testing.assert_allclose(out["motion2"].numpy(), g["motion2"],
                                   rtol=1e-4, atol=2e-4)

    def test_temporalnet_clip(self, goldens):
        g = goldens("temporalnet_parity")
        # the reference's TemporalNet defines stage2 but never calls it
        net = loaded(TemporalNet(),
                     unpack_sd(g, drop=("feature_extractor_stage2.",)))
        motions = clip_motions(net, nhwc(g["frames"][:, 0]))
        np.testing.assert_allclose(motions.numpy(), g["motions"][:, 0],
                                   rtol=1e-4, atol=1e-4)

    def test_smoothnet(self, goldens):
        g = goldens("smooth_parity")
        # the reference's embedding2 is defined but never called
        net = loaded(SmoothNet(), unpack_sd(g, drop=("MotionPre.embedding2.",)))
        args = [torch.from_numpy(np.array(g[k])) for k in
                ("smesh1", "smesh2", "tsmotion1", "tsmotion2")]
        with torch.no_grad():
            d = smooth_outputs(net(*args))
        np.testing.assert_allclose((d["smooth_path1"] - d["ori_path1"]).numpy(),
                                   g["y"][..., 0:2], rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose((d["smooth_path2"] - d["ori_path2"]).numpy(),
                                   g["y"][..., 2:4], rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(d["ori_path1"].numpy(),
                                   np.cumsum(g["tsmotion1"], axis=1), atol=1e-5)


@pytest.fixture(scope="module")
def jax_models():
    """A random-weight float32 JAX stitcher at 128x160 and its weights carried
    into the port's modules."""
    st = j_init_stitcher(rng_seed=0, model_h=MH, model_w=MW, chunk=4,
                         compute_dtype=jnp.float32)
    tonp = lambda v: jax.tree_util.tree_map(np.asarray, v)  # noqa: E731
    sds = from_jax_params(tonp(st.spatial_vars), tonp(st.temporal_vars),
                          tonp(st.smooth_vars))
    nets = (SpatialNet(MH, MW), TemporalNet(MH, MW), SmoothNet())
    return st, [loaded(net, sd) for net, sd in zip(nets, sds)]


def _frames(seed, n=2):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (n, MH, MW, 3)).astype(np.float32)


class TestFromJaxParams:
    def test_spatialnet_matches_jax(self, jax_models):
        st, (net, _, _) = jax_models
        a, b = _frames(1), _frames(2)
        off1, mref, mtgt = st.spatial_net.apply(st.spatial_vars, jnp.asarray(a),
                                                jnp.asarray(b), False)
        ref = j_spatial_motions(off1, mref, mtgt, MH, MW)
        with torch.no_grad():
            got = net(torch.from_numpy(a), torch.from_numpy(b))
            motions = spatial_motions(*got, MH, MW)
        for g, r in zip(got, (off1, mref, mtgt)):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4,
                                       atol=1e-4)
        for k in ("motion1", "motion2"):
            np.testing.assert_allclose(motions[k].numpy(), np.asarray(ref[k]),
                                       rtol=1e-4, atol=2e-4)

    def test_temporalnet_matches_jax(self, jax_models):
        st, (_, net, _) = jax_models
        a, b = _frames(3), _frames(4)
        v = st.temporal_vars
        fa = st.temporal_net.apply(v, jnp.asarray(a), False,
                                   method=JTemporalNet.features)
        fb = st.temporal_net.apply(v, jnp.asarray(b), False,
                                   method=JTemporalNet.features)
        ref = st.temporal_net.apply(v, fa, fb,
                                    method=JTemporalNet.motion_from_features)
        with torch.no_grad():
            ga = net.features(torch.from_numpy(a))
            got = net.motion_from_features(ga, net.features(torch.from_numpy(b)))
        np.testing.assert_allclose(ga.numpy(), np.asarray(fa), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-4)

    def test_smoothnet_matches_jax(self, jax_models):
        st, (_, _, net) = jax_models
        rng = np.random.default_rng(5)
        args = [rng.normal(0, s, (3, 7, 7, 9, 2)).astype(np.float32)
                for s in (100.0, 100.0, 1.0, 1.0)]
        ref = j_smooth_outputs(st.smooth_net.apply(
            st.smooth_vars, *[jnp.asarray(x) for x in args]))
        with torch.no_grad():
            got = smooth_outputs(net(*[torch.from_numpy(x) for x in args]))
        for k in ("smooth_mesh1", "smooth_mesh2", "smooth_path1"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                       rtol=1e-4, atol=1e-3)

    @pytest.mark.parametrize("which", ["spatial", "temporal", "smooth"])
    def test_inverse_of_convert_state_dict(self, which):
        net = {"spatial": lambda: SpatialNet(MH, MW),
               "temporal": lambda: TemporalNet(MH, MW),
               "smooth": SmoothNet}[which]()
        init_weights(net, torch.Generator().manual_seed(3))
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):   # non-trivial statistics
                m.running_mean.uniform_(-0.5, 0.5)
                m.running_var.uniform_(0.5, 1.5)
                m.weight.data.uniform_(0.5, 1.5)
        sd = {k: v.numpy() for k, v in net.state_dict().items()}
        mapping = {"spatial": ti.spatial_mapping, "temporal": ti.temporal_mapping,
                   "smooth": ti.smooth_mapping}[which]()
        params, stats = ti.convert_state_dict(sd, mapping, strict=True)
        variables = {"params": params, "batch_stats": stats}
        empty = {"params": {}, "batch_stats": {}}
        trees = {"spatial": (variables, empty, empty),
                 "temporal": (empty, variables, empty),
                 "smooth": (empty, empty, variables)}[which]
        idx = ["spatial", "temporal", "smooth"].index(which)
        back = from_jax_params(*trees)[idx]
        assert set(back) == set(sd)
        for k, v in sd.items():
            np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
