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
  (``pallas_gather=False``); B-planar against JAX ``_composite_chunk(...,
  out_format='yuv420', pallas_gather=True)``; route A yuv420 against JAX
  ``pallas_fused=True``. Frames within ``assert_frames_close``
  (tests/test_torch_stitch.py): the two sides solve the TPS system with
  different float32 routines, so view-border pixels can flip.
- route B equals route A bit for bit (both plain on the CPU).
- the stride-4 lattice (atol 2e-4, the JAX package's spline tolerance),
  the FAST sampler and mask (atol 1e-5, as TestInterp) and ``ops/yuv.py``
  (uint8-exact).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from stabstitch2_tpu.config import StitchConfig as JStitchConfig
from stabstitch2_tpu.data.video_io import pack_i420_host as j_pack_i420_host
from stabstitch2_tpu.ops import interp as j_interp
from stabstitch2_tpu.ops import yuv as j_yuv
from stabstitch2_tpu.ops.tps import tps_params as j_tps_params
from stabstitch2_tpu.ops.tps import tps_sample_coords as j_tps_sample_coords
from stabstitch2_tpu.pipeline import compositor as j_comp
from stabstitch2_tpu_torch.config import StitchConfig
from stabstitch2_tpu_torch.data.video_io import pack_i420_host, write_video
from stabstitch2_tpu_torch.ops import interp, tps, yuv
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

    @pytest.mark.parametrize("fusion", ["AVERAGE", "LINEAR"])
    def test_fused_route_yuv420_matches_jax(self, clip, fusion):
        got, c = _port(clip, fusion_mode=fusion, download_format="yuv420")
        ref, jc = _jax(clip, pallas_fused=True, fusion_mode=fusion,
                       download_format="yuv420")
        _same_canvas(c, jc)
        assert_frames_close(got, ref)

    @pytest.mark.parametrize("fusion", ["AVERAGE", "LINEAR"])
    def test_route_b_equals_route_a(self, clip, fusion):
        a, _ = _port(clip, fusion_mode=fusion)
        b, _ = _port(clip, fusion_mode=fusion, fused_warp=False)
        np.testing.assert_array_equal(a, b)

    @pytest.mark.parametrize("fusion", ["AVERAGE", "LINEAR"])
    def test_planar_branch_matches_jax(self, clip, fusion):
        i1, i2, m1, m2 = clip
        canvas = compositor.compute_canvas(t(m1), t(m2), BUCKET)
        span = (np.float32(canvas.out_h), np.float32(canvas.out_w))
        size = (canvas.pad_h, canvas.pad_w)
        offset = np.asarray([canvas.x_min, canvas.y_min], np.float32)
        got = compositor.composite_chunk(
            t(i1), t(i2), t(m1), t(m2), t(offset), size, fusion, span,
            out_format="yuv420", fused_warp=False)
        ref, viol = j_comp._composite_chunk(
            jnp.asarray(i1), jnp.asarray(i2), jnp.asarray(m1),
            jnp.asarray(m2), jnp.asarray(offset), size, "NORMAL", fusion,
            grid_span=(jnp.float32(canvas.out_h), jnp.float32(canvas.out_w)),
            out_format="yuv420", pallas_gather=True)
        assert not bool(viol)
        for g, r in zip(got, ref):
            assert g.dtype == torch.uint8 and g.shape == r.shape
            assert_frames_close(g.numpy(), np.asarray(r))

    def test_planar_branch_from_begin_when_fused_does_not_apply(self, clip):
        """fused_warp=True at coord_stride 4: not chained, planar."""
        got, c = _port(clip, fused_warp=True, coord_stride=4,
                       download_format="yuv420")
        ref, jc = _jax(clip, pallas_fused=True, pallas_gather=True,
                       coord_stride=4, download_format="yuv420")
        _same_canvas(c, jc)
        assert_frames_close(got, ref)

    def test_float_input_matches_jax(self, clip):
        i1, i2, m1, m2 = clip
        f1, f2 = i1.astype(np.float32), i2.astype(np.float32)
        got, c = compositor.composite_video(
            t(f1), t(f2), t(m1), t(m2),
            config=StitchConfig(canvas_bucket=BUCKET), chunk=CHUNK,
            model_size=(H, W))
        ref, jc = j_comp.composite_finish(j_comp.composite_begin(
            jnp.asarray(f1), jnp.asarray(f2), jnp.asarray(m1),
            jnp.asarray(m2), config=JStitchConfig(canvas_bucket=BUCKET),
            chunk=CHUNK, model_size=(H, W), pallas_fused=False,
            pallas_gather=False))
        _same_canvas(c, jc)
        assert_frames_close(got, ref)


def _spline(seed=0, B=2):
    rng = np.random.default_rng(seed)
    xs, ys = np.linspace(-1, 1, 9), np.linspace(-1, 1, 7)
    mesh = np.stack(np.meshgrid(xs, ys), -1).reshape(-1, 2)
    src = (mesh[None] + rng.normal(0, 0.06, (B, 63, 2))).astype(np.float32)
    tgt = np.tile(mesh[None], (B, 1, 1)).astype(np.float32)
    return np.asarray(j_tps_params(jnp.asarray(src), jnp.asarray(tgt))), src


class TestCoordStride:
    @pytest.mark.parametrize("stride", [4, 8])
    @pytest.mark.parametrize("out_size,span", [((36, 48), None),
                                               ((61, 70), (55, 66))])
    def test_lattice_matches_jax(self, stride, out_size, span):
        T, src = _spline()
        x, y = tps.tps_sample_coords(t(T), t(src), out_size, grid_span=span,
                                     coord_stride=stride)
        xr, yr = j_tps_sample_coords(jnp.asarray(T), jnp.asarray(src),
                                     out_size, grid_span=span,
                                     coord_stride=stride)
        np.testing.assert_allclose(x.numpy(), np.asarray(xr), atol=2e-4)
        np.testing.assert_allclose(y.numpy(), np.asarray(yr), atol=2e-4)
        # every s-th pixel of every s-th row is the spline itself (as a
        # matrix product, so within the spline tolerance of the point loop)
        ex, _ = tps.tps_coords_plain(t(T), t(src), out_size, grid_span=span)
        lat = (x.reshape(2, *out_size) - ex.reshape(2, *out_size))
        assert float(lat[:, ::stride, ::stride].abs().max()) < 2e-4


class TestFastSampler:
    def _coords(self, seed, B=3, n_pts=4000, W=31):
        rng = np.random.default_rng(seed)
        x = rng.uniform(-1.3, 1.3, (B, n_pts)).astype(np.float32)
        y = rng.uniform(-1.3, 1.3, (B, n_pts)).astype(np.float32)
        specials = np.array([-1.0, 1.0, -1.0 - 2.0 / W, 1.0 + 2.0 / W, 0.0],
                            np.float32)
        x[:, :specials.size] = specials
        y[:, :specials.size] = specials[::-1]
        return x, y

    def test_sample_and_mask_match_jax_and_grid_sample(self):
        rng = np.random.default_rng(11)
        im = rng.normal(0, 1, (3, 24, 31, 4)).astype(np.float32)
        x, y = self._coords(1)
        got = interp.grid_sample_align_corners(t(im), t(x), t(y))
        ref = j_interp.grid_sample_align_corners(jnp.asarray(im),
                                                 jnp.asarray(x), jnp.asarray(y))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
        lib = F.grid_sample(t(im).permute(0, 3, 1, 2),
                            torch.stack([t(x), t(y)], -1)[:, None],
                            mode="bilinear", padding_mode="zeros",
                            align_corners=True)[:, :, 0].permute(0, 2, 1)
        np.testing.assert_allclose(got.numpy(), lib.numpy(), atol=1e-5)
        m = interp.grid_sample_mask_align_corners(24, 31, t(x), t(y))
        mref = j_interp.grid_sample_mask_align_corners(24, 31, jnp.asarray(x),
                                                       jnp.asarray(y))
        np.testing.assert_allclose(m.numpy(), np.asarray(mref), atol=1e-5)

    def test_nan_coords_give_zero(self):
        im = t(np.full((1, 8, 8, 3), 200.0, np.float32))
        bad = torch.full((1, 5), float("nan"))
        np.testing.assert_array_equal(
            interp.grid_sample_align_corners(im, bad, bad).numpy(), 0.0)


class TestYUV:
    def _frames(self, seed=0):
        rng = np.random.default_rng(seed)
        f = rng.uniform(-3.0, 258.0, (2, 10, 14, 3)).astype(np.float32)
        f[0, 0, :4] = [[0.5, 1.5, 2.5]] * 4      # halves: round to even
        return np.clip(f, 0.0, 255.0)

    def test_conversions_match_jax_exactly(self):
        f = self._frames()
        u8 = np.clip(f, 0, 255).astype(np.uint8)
        cases = [(yuv.bgr_to_yuv420(t(f)), j_yuv.bgr_to_yuv420(jnp.asarray(f))),
                 (yuv.bgr_u8_to_yuv420(t(u8)),
                  j_yuv.bgr_u8_to_yuv420_jit(jnp.asarray(u8))),
                 (yuv.bgr_planes_to_yuv420(*(t(f[..., c]) for c in range(3))),
                  j_yuv.bgr_planes_to_yuv420(*(jnp.asarray(f[..., c])
                                               for c in range(3))))]
        for got, ref in cases:
            for g, r in zip(got, ref):
                assert g.dtype == torch.uint8
                np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        y, u, v = cases[0][0]
        packed = yuv.pack_i420(y, u, v).numpy()
        np.testing.assert_array_equal(
            packed, np.asarray(j_yuv.pack_i420(*cases[0][1])))
        np.testing.assert_array_equal(
            pack_i420_host(y.numpy(), u.numpy(), v.numpy()), packed)
        np.testing.assert_array_equal(
            pack_i420_host(y[0].numpy(), u[0].numpy(), v[0].numpy()),
            j_pack_i420_host(y[0].numpy(), u[0].numpy(), v[0].numpy()))

    def test_write_video_i420(self, tmp_path):
        f = self._frames(1)
        packed = yuv.pack_i420(*yuv.bgr_to_yuv420(t(f))).numpy()
        out = tmp_path / "a.mp4"
        write_video(str(out), packed, frame_format="i420")
        assert out.exists() and out.stat().st_size > 100
        with pytest.raises(ValueError):
            write_video(str(tmp_path / "b.mp4"), packed, frame_format="nv12")
