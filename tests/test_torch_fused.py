"""The port's fused motion (``VideoStitcher.fused_motion``, the default) and
its online step, on the CPU.

On the CPU ``utils/graphs.py:GraphCache`` calls the captured functions
directly, so these tests hold what a graph captures: the chunk programs
at the chunk shape, the last chunk padded with its last frame and cropped,
and the transport and smoothing of every window at the 16-frame bucket.
The port's float32 stitcher at 128x160 with chunk 4 and a JAX stitcher
carrying its random weights (the JAX package's
``utils/torch_import.py:convert_state_dict``; one per module, so its fused
programs compile once) take the same inputs, made from a numpy seed.

Tolerances:
- the port's fused motions against JAX's ``_motion_fused`` at T = 9 (a
  padded chunk and bucket): 2e-4, and its fused ``motion_smooth`` against
  JAX's: smooth meshes 2e-3 px; the bounds of the JAX package's own fused
  tests (``tests/test_pipeline.py``);
- fused against eager in the port: bit for bit at T = 8 (a multiple of
  the chunk: the same kernels on the same shapes, and the bucket's
  padding never reaches a kept frame), and at T = 9 (the last chunk and
  the windows run at other batch sizes) the bounds of
  ``tests/test_pipeline.py::test_fused_motion_stitch_matches_eager``:
  meshes < 2e-3 px, frames mean |d| < 0.5 and < 1% of values off by more
  than 2;
- the online step over 9 pushes against JAX's ``OnlineStitcher``: each
  full window's smooth meshes within 1e-3 px, the emitted frames under
  ``assert_frames_close`` (``tests/test_torch_online.py``'s bounds, JAX
  on its XLA composite route and the port on route B, the same function).
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stabstitch2_tpu.config import StitchConfig as JStitchConfig
from stabstitch2_tpu.models import SmoothNet as JSmoothNet
from stabstitch2_tpu.models import SpatialNet as JSpatialNet
from stabstitch2_tpu.models import TemporalNet as JTemporalNet
from stabstitch2_tpu.pipeline.online import OnlineStitcher as JOnline
from stabstitch2_tpu.pipeline.stitcher import VideoStitcher as JVideoStitcher
from stabstitch2_tpu.utils import torch_import as ti
from stabstitch2_tpu_torch.config import StitchConfig
from stabstitch2_tpu_torch.pipeline.online import OnlineStitcher
from stabstitch2_tpu_torch.pipeline.stitcher import init_stitcher

from synthetic import make_two_view_clip
from test_torch_stitch import assert_frames_close

MH, MW, CHUNK, BUCKET = 128, 160, 4, 32
T = 9
MOTION_ATOL = 2e-4
MESH_ATOL_PX = 2e-3


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads: tier-1 runs six workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def stitchers():
    """The port's float32 stitcher, fused (the default) and eager on the
    same nets, and the JAX stitcher with its weights (XLA composite
    route)."""
    st = init_stitcher(0, StitchConfig(canvas_bucket=BUCKET), MH, MW, CHUNK,
                       compute_dtype=torch.float32, device="cpu")

    def variables(net, mapping):
        params, stats = ti.convert_state_dict(
            {k: v.numpy() for k, v in net.state_dict().items()}, mapping)
        return ({"params": params, "batch_stats": stats} if stats
                else {"params": params})

    js = JVideoStitcher(
        JSpatialNet(dtype=jnp.float32),
        variables(st.spatial_net, ti.spatial_mapping()),
        JTemporalNet(dtype=jnp.float32),
        variables(st.temporal_net, ti.temporal_mapping()),
        JSmoothNet(), variables(st.smooth_net, ti.smooth_mapping()),
        config=JStitchConfig(canvas_bucket=BUCKET, pallas_fused=False,
                             pallas_gather=False),
        chunk=CHUNK, model_h=MH, model_w=MW)
    assert st.fused_motion
    return js, st, dataclasses.replace(st, fused_motion=False)


@pytest.fixture(scope="module")
def model_inputs():
    rng = np.random.default_rng(11)
    return tuple(rng.uniform(-1, 1, (T, MH, MW, 3)).astype(np.float32)
                 for _ in range(2))


@pytest.fixture(scope="module")
def clip():
    return make_two_view_clip(num_frames=T, height=MH, width=MW, overlap=0.6,
                              shake_px=2.0, seed=37)


def test_fused_motions_match_jax(stitchers, model_inputs):
    js, st, _ = stitchers
    l1, l2 = model_inputs
    Tb = 16     # JAX's bucket, a multiple of the chunk
    pad = lambda x: np.concatenate(  # noqa: E731
        [x, np.repeat(x[-1:], Tb - T, 0)])
    want = js._motion_fused(js.spatial_vars, js.temporal_vars,
                            jnp.asarray(pad(l1)), jnp.asarray(pad(l2)))
    motion = st._motion
    m1, m2, f1, f2 = zip(*(
        motion.motion_chunk(a, b, k, st.graphs) for k, (a, b) in enumerate(
            zip(motion.split(torch.from_numpy(l1)),
                motion.split(torch.from_numpy(l2))))))
    got = (torch.cat(m1), torch.cat(m2),
           *motion.temporal_from_features(f1, f2, st.graphs))
    for g, w, name in zip(got, want, ("sm1", "sm2", "tm1", "tm2")):
        assert g.shape[0] == T
        np.testing.assert_allclose(g.numpy(), np.asarray(w)[:T],
                                   atol=MOTION_ATOL, err_msg=name)


def test_fused_motion_smooth_matches_jax(stitchers, model_inputs):
    js, st, _ = stitchers
    l1, l2 = model_inputs
    want = js.motion_smooth(jnp.asarray(l1), jnp.asarray(l2))
    got = st.motion_smooth(torch.from_numpy(l1), torch.from_numpy(l2))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].shape == w.shape, k
    for k in ("smooth_mesh1", "smooth_mesh2", "ori_mesh1", "ori_mesh2"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=MESH_ATOL_PX, err_msg=k)


def assert_meshes_within(a: dict, b: dict, atol: float) -> None:
    for k in ("smooth_mesh1", "smooth_mesh2", "ori_mesh1", "ori_mesh2",
              "win_smooth_path1", "win_smooth_path2"):
        assert a[k].shape == b[k].shape, k
        gap = float((a[k] - b[k]).abs().max())
        assert gap <= atol, (k, gap)


@pytest.mark.parametrize("n", [8, T])
def test_fused_motion_smooth_against_eager(stitchers, model_inputs, n):
    """Bit for bit where n is a multiple of the chunk; else within the
    JAX package's bound."""
    _, st, eager = stitchers
    l1, l2 = (torch.from_numpy(x[:n]) for x in model_inputs)
    fused, ref = st.motion_smooth(l1, l2), eager.motion_smooth(l1, l2)
    assert_meshes_within(fused, ref, 0.0 if n % CHUNK == 0 else MESH_ATOL_PX)


def test_stitch_arrays_fused_against_eager(stitchers, clip):
    _, st, eager = stitchers
    got = st.stitch_arrays(clip[0], None, clip[1], None)
    ref = eager.stitch_arrays(clip[0], None, clip[1], None)
    assert got.frames.shape == ref.frames.shape and got.frames.max() > 10
    for k in ("smooth_mesh1", "smooth_mesh2"):
        gap = float((getattr(got, k) - getattr(ref, k)).abs().max())
        assert gap < MESH_ATOL_PX, (k, gap)
    d = np.abs(got.frames.astype(np.int16) - ref.frames.astype(np.int16))
    assert d.mean() < 0.5 and (d > 2).mean() < 0.01
    # the fused phases take no wait before 'smooth'; the eager ones do
    assert list(got.ms) == list(ref.ms)


def test_online_step_matches_jax(stitchers, clip):
    """Nine pushes through the port's step (route B) and JAX's fused
    ``_step`` (its XLA route): the smooth meshes of every full window and
    the emitted frames."""
    js, st, _ = stitchers
    st_b = dataclasses.replace(st, config=StitchConfig(canvas_bucket=BUCKET,
                                                       fused_warp=False))
    jo, o = JOnline(js), OnlineStitcher(st_b)
    assert o.graphs is not None
    got, want = [], []
    for t, (a, b) in enumerate(zip(*clip)):
        got += o.push(a, b)
        want += [np.asarray(f) for f in jo.push(a, b)]
        if t + 1 >= st.config.window:
            for g, w in zip(o.window_smooth, jo.window_smooth):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           atol=1e-3, err_msg=f"push {t}")
    assert len(got) == len(want) == T
    assert_frames_close(np.stack(got), np.stack(want))
