"""The port's ``upload_mode="stream"`` against its bulk upload and against
the JAX package's stream mode, on the CPU.

Stream and bulk run the motion nets on the same chunks
(``pipeline/motion.py``), so on one device they must give the same bits:
frames and smooth meshes, for BGR and packed I420 input, at a frame count
with a tail chunk (10 frames, chunk 4). Against JAX (a float32 stitcher at
128x160 whose weights the port carries through
``utils/weights.py:from_jax_params``, its own ``upload_mode="stream"``
and, on the CPU, its XLA composite route) the bounds are those of
``tests/test_torch_stitch.py``: smooth meshes within 1e-3 px, uint8
frames with <= 1% of values off at all and <= 1e-4 by more than a level.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stabstitch2_tpu.config import StitchConfig as JStitchConfig
from stabstitch2_tpu.models import SmoothNet as JSmoothNet
from stabstitch2_tpu.models import SpatialNet as JSpatialNet
from stabstitch2_tpu.models import TemporalNet as JTemporalNet
from stabstitch2_tpu.pipeline.stitcher import VideoStitcher as JVideoStitcher
from stabstitch2_tpu_torch.config import StitchConfig
from stabstitch2_tpu_torch.data.video_io import bgr_to_i420
from stabstitch2_tpu_torch.pipeline.stitcher import init_stitcher
from stabstitch2_tpu_torch.utils.checkpoint import stitcher_from_checkpoint
from stabstitch2_tpu_torch.utils.weights import from_jax_params

from synthetic import make_two_view_clip
from test_torch_stitch import assert_frames_close

MH, MW, CHUNK, BUCKET, T = 128, 160, 4, 32, 10


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads: tier-1 runs six workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def clip():
    return make_two_view_clip(num_frames=T, height=MH, width=MW, overlap=0.6,
                              shake_px=2.0, seed=5)


@pytest.fixture(scope="module")
def stitchers():
    """A float32 random-weight JAX stitcher, its nets initialized under
    jit (a third of the eager init's time), and the port's with its
    weights."""
    nets = (JSpatialNet(dtype=jnp.float32), JTemporalNet(dtype=jnp.float32),
            JSmoothNet())
    img, mesh = jnp.zeros((1, MH, MW, 3)), jnp.zeros((1, 7, 7, 9, 2))
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    variables = (
        jax.jit(lambda k: nets[0].init(k, img, img, False))(keys[0]),
        jax.jit(lambda k: nets[1].init(k, img, img, False))(keys[1]),
        jax.jit(lambda k: nets[2].init(k, mesh, mesh, mesh, mesh))(keys[2]))
    js = JVideoStitcher(nets[0], variables[0], nets[1], variables[1],
                        nets[2], variables[2],
                        config=JStitchConfig(canvas_bucket=BUCKET),
                        chunk=CHUNK, model_h=MH, model_w=MW)
    tonp = lambda v: jax.tree_util.tree_map(np.asarray, v)  # noqa: E731
    st = init_stitcher(0, StitchConfig(canvas_bucket=BUCKET), MH, MW, CHUNK,
                       compute_dtype=torch.float32, device="cpu")
    sds = from_jax_params(tonp(js.spatial_vars), tonp(js.temporal_vars),
                          tonp(js.smooth_vars))
    for net, sd in zip((st.spatial_net, st.temporal_net, st.smooth_net), sds):
        net.load_state_dict(sd, strict=True)
    return js, st


def stitch(st, mode, a, b):
    st.upload_mode = mode
    try:
        return st.stitch_arrays(a, None, b, None)
    finally:
        st.upload_mode = "bulk"


@pytest.mark.parametrize("fmt", ["bgr", "i420"])
def test_stream_equals_bulk(stitchers, clip, fmt):
    _, st = stitchers
    a, b = clip if fmt == "bgr" else (bgr_to_i420(clip[0]),
                                      bgr_to_i420(clip[1]))
    bulk, streamed = stitch(st, "bulk", a, b), stitch(st, "stream", a, b)
    assert streamed.frames.shape[0] == T and streamed.frames.max() > 10
    np.testing.assert_array_equal(streamed.frames, bulk.frames)
    for k in ("smooth_mesh1", "smooth_mesh2", "ori_mesh1", "ori_mesh2"):
        assert torch.equal(getattr(streamed, k), getattr(bulk, k)), k
    assert list(streamed.ms) == list(bulk.ms)


def test_stream_matches_jax_stream(stitchers, clip):
    js, st = stitchers
    js.upload_mode = "stream"
    try:
        want = js.stitch_arrays(clip[0], None, clip[1], None)
    finally:
        js.upload_mode = "bulk"
    got = stitch(st, "stream", *clip)
    for k in ("smooth_mesh1", "smooth_mesh2"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), atol=1e-3,
                                   err_msg=k)
    assert_frames_close(got.frames, np.asarray(want.frames))


def test_upload_mode_is_checked_and_carried():
    st = stitcher_from_checkpoint(upload_mode="stream", model_h=MH,
                                  model_w=MW, chunk=CHUNK, device="cpu")
    assert st.upload_mode == "stream"
    st.upload_mode = "chunked"
    frames = np.zeros((8, MH, MW, 3), np.uint8)
    with pytest.raises(ValueError, match="upload_mode"):
        st.stitch_arrays(frames, None, frames, None)
