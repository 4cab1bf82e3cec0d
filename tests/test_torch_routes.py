"""The port's composite routes beside the fused default, against the JAX package.

The same seeded numpy frames and meshes (T=3 at 96x144, as
tests/test_pipeline.py::TestCompositor) go through the JAX compositor and
the port's on the CPU, where the port's kernel wrappers run their plain
versions:

- route B (``fused_warp=False``: K3 coordinates, K4 sample) bgr, FAST and
  ``coord_stride=4`` against JAX ``composite_begin(..., pallas_fused=False,
  pallas_gather=False)``; NORMAL-mode yuv420, which the gather route chains
  (uint8 BGR, then the conversion), against the JAX chain
  (``pallas_gather=True``, Pallas interpret), and FAST yuv420, which
  neither side chains, against the unchained JAX route
  (``pallas_gather=False``). Frames within ``assert_frames_close``
  (tests/test_torch_stitch.py): the two sides solve the TPS system with
  different float32 routines, so view-border pixels can flip.

Route A's yuv420, route B against route A, the planar branch and float
input are in tests/test_torch_routes_a.py (the same clip and helpers; a
file of their own so that two of tier-1's workers share the time); the
routes' pieces (the stride lattice, the FAST sampler, ``ops/yuv.py``) are
in tests/test_torch_route_ops.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stabstitch2_tpu.config import StitchConfig as JStitchConfig
from stabstitch2_tpu.pipeline import compositor as j_comp
from stabstitch2_tpu_torch.config import StitchConfig
from stabstitch2_tpu_torch.ops import yuv
from stabstitch2_tpu_torch.ops.patch_gather_cuda import LAUNCHES as K4_LAUNCHES
from stabstitch2_tpu_torch.ops.tps_coords_cuda import LAUNCHES as K3_LAUNCHES
from stabstitch2_tpu_torch.pipeline import compositor

from test_torch_stitch import assert_frames_close

T_, H, W, CHUNK, BUCKET = 3, 96, 144, 2, 32


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def clip():
    rng = np.random.default_rng(5)
    i1 = rng.integers(0, 255, (T_, H, W, 3), dtype=np.uint8)
    i2 = rng.integers(0, 255, (T_, H, W, 3), dtype=np.uint8)
    xs, ys = np.linspace(0.0, W, 9), np.linspace(0.0, H, 7)
    base = np.stack(np.meshgrid(xs, ys), -1)[None]
    m1 = (base + rng.normal(0, 2, (T_, 7, 9, 2))).astype(np.float32)
    m2 = (base + rng.normal(0, 2, (T_, 7, 9, 2)) + 25.0).astype(np.float32)
    return i1, i2, m1, m2


def _port(clip, **cfg):
    i1, i2, m1, m2 = clip
    return compositor.composite_video(
        i1, i2, t(m1), t(m2), config=StitchConfig(canvas_bucket=BUCKET, **cfg),
        chunk=CHUNK, model_size=(H, W))


def _jax(clip, pallas_fused=False, pallas_gather=False, **cfg):
    i1, i2, m1, m2 = clip
    return j_comp.composite_finish(j_comp.composite_begin(
        i1, i2, jnp.asarray(m1), jnp.asarray(m2),
        config=JStitchConfig(canvas_bucket=BUCKET, **cfg), chunk=CHUNK,
        model_size=(H, W), pallas_fused=pallas_fused,
        pallas_gather=pallas_gather))


def _same_canvas(a, b):
    assert (a.out_h, a.out_w, a.pad_h, a.pad_w) == (b.out_h, b.out_w,
                                                    b.pad_h, b.pad_w)


class TestRoutes:
    @pytest.mark.parametrize("cfg", [
        dict(fusion_mode="AVERAGE"),
        dict(fusion_mode="LINEAR"),
        dict(warp_mode="FAST"),
        dict(warp_mode="FAST", fusion_mode="LINEAR"),
        dict(coord_stride=4),
    ], ids=["B-average", "B-linear", "fast", "fast-linear", "stride4"])
    def test_bgr_matches_jax_xla_route(self, clip, cfg):
        K3_LAUNCHES.clear()
        K4_LAUNCHES.clear()
        got, c = _port(clip, fused_warp=False, **cfg)
        ref, jc = _jax(clip, **cfg)
        _same_canvas(c, jc)
        assert got.dtype == np.uint8 and got.max() > 10
        assert_frames_close(got, ref)
        assert not K3_LAUNCHES and not K4_LAUNCHES   # plain on the CPU

    @pytest.mark.parametrize("cfg", [
        dict(fusion_mode="AVERAGE"),
        dict(fusion_mode="LINEAR"),
        dict(warp_mode="FAST"),
        dict(coord_stride=4),
    ], ids=["B-average", "B-linear", "fast", "stride4"])
    def test_yuv420_matches_jax_chained_route(self, clip, cfg):
        # JAX chains only its NORMAL gather route; FAST converts the
        # float fusion, so it is held against the unchained JAX route
        chained = cfg.get("warp_mode", "NORMAL") == "NORMAL"
        got, c = _port(clip, fused_warp=False, download_format="yuv420", **cfg)
        ref, jc = _jax(clip, pallas_gather=chained, download_format="yuv420",
                       **cfg)
        _same_canvas(c, jc)
        assert c.out_h % 2 == 0 and c.out_w % 2 == 0
        assert got.shape == (T_, c.out_h * 3 // 2, c.out_w)
        assert_frames_close(got, ref)
        # chained: exactly the conversion of the route's own bgr frames
        bgr, _ = _port(clip, fused_warp=False, **cfg)
        conv = yuv.pack_i420(*yuv.bgr_u8_to_yuv420(
            t(bgr[:, :c.out_h, :c.out_w]))).numpy()
        assert np.array_equal(got, conv) == chained
