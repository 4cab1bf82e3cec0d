"""The pieces of the port's composite routes against the JAX package, on
the CPU (moved out of tests/test_torch_routes.py, which keeps the routes
themselves): the stride-4 and stride-8 coordinate lattice (atol 2e-4,
the JAX package's spline tolerance), the FAST sampler and mask (atol
1e-5, as TestInterp) and ``ops/yuv.py`` (uint8-exact).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from stabstitch2_tpu.data.video_io import pack_i420_host as j_pack_i420_host
from stabstitch2_tpu.ops import interp as j_interp
from stabstitch2_tpu.ops import yuv as j_yuv
from stabstitch2_tpu.ops.tps import tps_params as j_tps_params
from stabstitch2_tpu.ops.tps import tps_sample_coords as j_tps_sample_coords
from stabstitch2_tpu_torch.data.video_io import pack_i420_host, write_video
from stabstitch2_tpu_torch.ops import interp, tps, yuv


def t(x):
    return torch.from_numpy(np.array(x))


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
