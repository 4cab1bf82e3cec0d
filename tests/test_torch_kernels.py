"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain version, which is held against the
Pallas kernel in interpret mode on the same seeded numpy inputs:

- K1 ``ops/corr_cuda.py`` vs ``ops/pallas_corr.py:cost_volume_fused``
  (atol/rtol 1e-5, as TestPallasCostVolume);
- K2 ``ops/fused_warp_cuda.py`` vs ``ops/pallas_fused.py:fused_warp_planes``
  (<= 1 uint8 LSB, < 5e-3 of pixels differing, exact zeros at dead
  pixels on both sides, as TestFusedWarp);
- K3 ``ops/tps_coords_cuda.py`` vs ``ops/pallas_warp.py:tps_coords_fused``
  and the jnp ``tps_sample_coords`` (atol 2e-4, as TestPallasTPSKernel);
- K4 ``ops/patch_gather_cuda.py`` vs
  ``ops/pallas_gather.py:bilinear_sample_patch_u8_pallas`` in its ``flat``
  and ``planes`` layouts (atol 1e-2, as TestPallasPatchGather).

The hand-written kernels themselves run only on the card: their tests are
in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stabstitch2_tpu.ops.mesh import mesh_points as j_mesh_points
from stabstitch2_tpu.ops.mesh import normalize_mesh as j_normalize_mesh
from stabstitch2_tpu.ops.mesh import rigid_mesh as j_rigid_mesh
from stabstitch2_tpu.ops.pallas_corr import cost_volume_fused
from stabstitch2_tpu.ops.pallas_fused import fused_warp_planes as j_fused
from stabstitch2_tpu.ops.pallas_gather import bilinear_sample_patch_u8_pallas
from stabstitch2_tpu.ops.pallas_warp import tps_coords_fused
from stabstitch2_tpu.ops.tps import tps_params as j_tps_params
from stabstitch2_tpu.ops.tps import tps_sample_coords as j_tps_sample_coords
from stabstitch2_tpu_torch.ops import (corr_cuda, fused_warp_cuda,
                                       patch_gather_cuda, tps_coords_cuda)
from stabstitch2_tpu_torch.ops.interp import support_mask
from stabstitch2_tpu_torch.ops.tps import tps_sample_coords
from stabstitch2_tpu_torch.utils import cuda_build


def t(x):
    return torch.from_numpy(np.array(x))


CV_CASES = [(2, 12, 16, 128, 3), (1, 9, 10, 128, 5)]


def _cv_inputs(B, H, W, C, seed=7):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (B, H, W, C)).astype(np.float32),
            rng.normal(0, 1, (B, H, W, C)).astype(np.float32))


class TestCostVolumePlain:
    @pytest.mark.parametrize("B,H,W,C,r", CV_CASES)
    def test_matches_pallas_interpret(self, B, H, W, C, r):
        x1, x2 = _cv_inputs(B, H, W, C)
        ref = cost_volume_fused(jnp.asarray(x1), jnp.asarray(x2), r, True)
        got = corr_cuda.cost_volume_plain(t(x1), t(x2), r)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=1e-5, rtol=1e-5)

    @pytest.mark.parametrize("r", [3, 5])
    def test_matches_reference_golden(self, goldens, r):
        g = goldens("cost_volume")
        x1 = np.transpose(g["x1"], (0, 2, 3, 1))
        x2 = np.transpose(g["x2"], (0, 2, 3, 1))
        got = corr_cuda.cost_volume_cuda(t(x1), t(x2), r)
        ref = np.transpose(g[f"vol{r}"], (0, 2, 3, 1))
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5)

    def test_cpu_wrapper_is_plain_and_launches_nothing(self):
        x1, x2 = _cv_inputs(2, 6, 7, 16)
        before = dict(corr_cuda.LAUNCHES)
        got = corr_cuda.cost_volume_cuda(t(x1), t(x2), 3)
        assert dict(corr_cuda.LAUNCHES) == before
        np.testing.assert_array_equal(
            got.numpy(), corr_cuda.cost_volume_plain(t(x1), t(x2), 3).numpy())

    def test_gradient_matches_custom_vjp(self):
        x1, x2 = _cv_inputs(1, 8, 8, 128, seed=3)

        def loss_jax(a, b):
            return jnp.sum(jnp.sin(cost_volume_fused(a, b, 3, True)))

        g_ref = jax.grad(loss_jax, argnums=(0, 1))(jnp.asarray(x1),
                                                  jnp.asarray(x2))
        a = t(x1).requires_grad_(True)
        b = t(x2).requires_grad_(True)
        torch.sin(corr_cuda.cost_volume_cuda(a, b, 3)).sum().backward()
        for got, ref in zip((a.grad, b.grad), g_ref):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       atol=1e-5, rtol=1e-5)

    def test_rejects_bad_inputs(self):
        x1, x2 = _cv_inputs(1, 4, 5, 8)
        with pytest.raises(TypeError):
            corr_cuda.cost_volume_cuda(t(x1).double(), t(x2).double(), 3)
        with pytest.raises(ValueError):
            corr_cuda.cost_volume_cuda(t(x1), t(x2)[:, :3], 3)


class TestFusedWarpPlain:
    """TestFusedWarp's setup (tests/test_geometry.py): 3 images of 120x160
    warped onto a 144x256 canvas normalized by a 140x250 span."""

    B, H, W = 3, 120, 160
    OH, OW = 144, 256
    SPAN = (140, 250)

    def _setup(self, seed=0, mesh_shift=10.0):
        rng = np.random.default_rng(seed)
        im = rng.integers(0, 255, (self.B, self.H, self.W, 3)).astype(np.uint8)
        xs, ys = np.linspace(0.0, self.W, 9), np.linspace(0.0, self.H, 7)
        base = np.stack(np.meshgrid(xs, ys), -1)[None]
        mesh = (base + rng.normal(0, 2.0, (self.B, 7, 9, 2))
                + mesh_shift).astype(np.float32)
        norm = j_mesh_points(j_normalize_mesh(jnp.asarray(mesh), *self.SPAN))
        rigid = j_rigid_mesh(self.H, self.W, dtype=jnp.float32)
        nrig = jnp.broadcast_to(
            j_mesh_points(j_normalize_mesh(rigid, self.H, self.W))[None],
            norm.shape)
        return im, np.asarray(j_tps_params(norm, nrig)), np.asarray(norm)

    def _both(self, im, T, norm):
        jb, jg, jr, jm, jviol = j_fused(jnp.asarray(im), jnp.asarray(T),
                                        jnp.asarray(norm), (self.OH, self.OW),
                                        grid_span=self.SPAN, interpret=True)
        ref = np.stack([np.asarray(jb), np.asarray(jg), np.asarray(jr)], -1)
        out = fused_warp_cuda.fused_warp_planes(t(im), t(T), t(norm),
                                                (self.OH, self.OW),
                                                grid_span=self.SPAN)
        got = np.stack([p.numpy() for p in out[:3]], -1)
        return ref, np.asarray(jm), bool(jviol), got, out[3].numpy(), out[4]

    def test_matches_pallas_interpret_within_lsb(self):
        im, T, norm = self._setup()
        ref, jmask, jviol, got, mask, viol = self._both(im, T, norm)
        assert not jviol and not bool(viol)
        np.testing.assert_allclose(mask, jmask, atol=1e-3)
        ru = np.clip(np.round(ref), 0, 255).astype(np.int16)
        gu = np.clip(np.round(got), 0, 255).astype(np.int16)
        d = np.abs(ru - gu)
        assert d.max() <= 1, d.max()
        assert (d > 0).mean() < 5e-3, (d > 0).mean()
        dead = jmask <= 0.0
        assert dead.any()
        np.testing.assert_array_equal(got[dead], 0.0)
        np.testing.assert_array_equal(ref[dead], 0.0)

    def test_mesh_far_outside_is_all_zero(self):
        im, T, norm = self._setup(mesh_shift=900.0)
        ref, _, jviol, got, _, viol = self._both(im, T, norm)
        np.testing.assert_array_equal(got, 0.0)
        np.testing.assert_array_equal(ref, 0.0)
        assert not jviol and not bool(viol)

    def test_cpu_wrapper_is_plain_and_launches_nothing(self):
        im, T, norm = self._setup(seed=1)
        before = dict(fused_warp_cuda.LAUNCHES)
        a = fused_warp_cuda.fused_warp_planes(t(im), t(T), t(norm), (40, 50))
        b = fused_warp_cuda.fused_warp_planes_plain(t(im), t(T), t(norm),
                                                    (40, 50))
        assert dict(fused_warp_cuda.LAUNCHES) == before
        for x, y in zip(a[:4], b[:4]):
            np.testing.assert_array_equal(x.numpy(), y.numpy())

    def test_rejects_bad_inputs(self):
        im, T, norm = self._setup(seed=2)
        with pytest.raises(ValueError):
            fused_warp_cuda.fused_warp_planes(t(im).float(), t(T), t(norm),
                                              (8, 8))
        with pytest.raises(ValueError):
            fused_warp_cuda.fused_warp_planes(t(im), t(T)[:2], t(norm), (8, 8))


def _tps_case(seed=0, B=2):
    """TestPallasTPSKernel's spline: a 7x9 lattice on [-1, 1]^2, jittered."""
    rng = np.random.default_rng(seed)
    xs, ys = np.linspace(-1, 1, 9), np.linspace(-1, 1, 7)
    mesh = np.stack(np.meshgrid(xs, ys), -1).reshape(-1, 2)
    src = (mesh[None] + rng.normal(0, 0.06, (B, 63, 2))).astype(np.float32)
    tgt = np.tile(mesh[None], (B, 1, 1)).astype(np.float32)
    T = np.asarray(j_tps_params(jnp.asarray(src), jnp.asarray(tgt)))
    return T, src


class TestTPSCoordsPlain:
    # (36, 48) and (29, 48): the second has a row count that is not a
    # multiple of the TPU kernel's 8-row tile; the third normalizes a
    # padded canvas by a smaller true extent; (45, 131) is wider than the
    # CUDA kernel's 128-column tile and not a multiple of its 16 rows
    @pytest.mark.parametrize("out_size,span", [((36, 48), None),
                                               ((29, 48), None),
                                               ((29, 48), (25, 40)),
                                               ((45, 131), (40, 120))])
    def test_matches_pallas_interpret_and_jnp(self, out_size, span):
        T, src = _tps_case()
        x, y = tps_coords_cuda.tps_coords(t(T), t(src), out_size,
                                          grid_span=span)
        assert x.shape == y.shape == (2, out_size[0] * out_size[1])
        for ref in (tps_coords_fused(jnp.asarray(T), jnp.asarray(src),
                                     out_size, interpret=True, grid_span=span),
                    j_tps_sample_coords(jnp.asarray(T), jnp.asarray(src),
                                        out_size, use_pallas=False,
                                        grid_span=span)):
            np.testing.assert_allclose(x.numpy(), np.asarray(ref[0]), atol=2e-4)
            np.testing.assert_allclose(y.numpy(), np.asarray(ref[1]), atol=2e-4)

    def test_cpu_wrapper_is_plain_and_launches_nothing(self):
        T, src = _tps_case(seed=1, B=3)
        before = dict(tps_coords_cuda.LAUNCHES)
        got = tps_coords_cuda.tps_coords(t(T), t(src), (21, 17))
        via = tps_sample_coords(t(T), t(src), (21, 17))
        want = tps_coords_cuda.tps_coords_plain(t(T), t(src), (21, 17))
        assert dict(tps_coords_cuda.LAUNCHES) == before
        for a, b, c in zip(got, via, want):
            np.testing.assert_array_equal(a.numpy(), c.numpy())
            np.testing.assert_array_equal(b.numpy(), c.numpy())

    def test_rejects_bad_inputs(self):
        T, src = _tps_case(seed=2)
        with pytest.raises(TypeError):
            tps_coords_cuda.tps_coords(t(T).double(), t(src).double(), (8, 8))
        with pytest.raises(ValueError):
            tps_coords_cuda.tps_coords(t(T)[:1], t(src), (8, 8))
        with pytest.raises(ValueError):
            tps_coords_cuda.tps_coords(t(T)[:, :, :-1], t(src), (8, 8))


class TestPatchGatherPlain:
    """TestPallasPatchGather's setup (tests/test_geometry.py): 2 images of
    40x48 sampled on a smooth 48x64 raster, in range and shifted off every
    image edge."""

    B, H, W = 2, 40, 48
    OH, OW = 48, 64
    SHIFTS = [(0.0, 0.0), (-25.0, 0.0), (30.0, 0.0), (0.0, -22.0),
              (0.0, 28.0)]

    def _coords(self, shift_x=0.0, shift_y=0.0, seed=0):
        rng = np.random.default_rng(seed)
        yy = np.arange(self.OH, dtype=np.float32)[None, :, None]
        xx = np.arange(self.OW, dtype=np.float32)[None, None, :]
        ph = rng.uniform(0, 6.28, (self.B, 1, 1)).astype(np.float32)
        xs = (xx * (self.W / self.OW) * 0.93
              + 2.0 * np.cos(yy / self.OH * 5 + ph) + shift_x)
        ys = (yy * (self.H / self.OH) * 0.93
              + 3.0 * np.sin(xx / self.OW * 4 + ph) + shift_y)
        xn = np.broadcast_to(xs * 2.0 / self.W - 1.0, (self.B, self.OH, self.OW))
        yn = np.broadcast_to(ys * 2.0 / self.H - 1.0, (self.B, self.OH, self.OW))
        return (np.array(xn.reshape(self.B, -1), np.float32),
                np.array(yn.reshape(self.B, -1), np.float32))

    def _im(self, seed=3):
        rng = np.random.default_rng(seed)
        return rng.integers(0, 256, (self.B, self.H, self.W, 3), dtype=np.uint8)

    @pytest.mark.parametrize("shift", SHIFTS)
    @pytest.mark.parametrize("layout", ["flat", "planes"])
    def test_matches_pallas_interpret(self, shift, layout):
        im, (x, y) = self._im(), self._coords(*shift)
        planes = layout == "planes"
        ref = bilinear_sample_patch_u8_pallas(
            jnp.asarray(im), jnp.asarray(x), jnp.asarray(y), (self.OH, self.OW),
            interpret=True, combine_layout=layout)
        got = patch_gather_cuda.bilinear_sample_patch_u8_cuda(
            t(im), t(x), t(y), (self.OH, self.OW), planes=planes)
        assert not bool(ref[-1]) and not bool(got[-1])
        if planes:
            ref = np.stack([np.asarray(p) for p in ref[:3]], -1)
            got = torch.stack(got[:3], -1)
        else:
            ref, got = np.asarray(ref[0]), got[0]
        assert got.shape == (self.B, self.OH, self.OW, 3)
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-2)

    @pytest.mark.parametrize("planes", [False, True])
    def test_nan_coords_are_exact_zero(self, planes):
        im, (x, y) = self._im(), self._coords()
        x[:, ::7] = np.nan
        y[:, 3::11] = np.nan
        out = patch_gather_cuda.bilinear_sample_patch_u8_cuda(
            t(im), t(x), t(y), (self.OH, self.OW), planes=planes)
        assert not bool(out[-1])
        got = (torch.stack(out[:3], -1) if planes else out[0]).reshape(
            self.B, -1, 3).numpy()
        nan = np.isnan(x) | np.isnan(y)
        np.testing.assert_array_equal(got[nan], 0.0)
        assert np.isfinite(got).all() and got[~nan].max() > 100

    def test_cpu_wrapper_is_plain_and_launches_nothing(self):
        im, (x, y) = self._im(seed=4), self._coords(5.0, -3.0, seed=1)
        before = dict(patch_gather_cuda.LAUNCHES)
        for planes in (False, True):
            a = patch_gather_cuda.bilinear_sample_patch_u8_cuda(
                t(im), t(x), t(y), (self.OH, self.OW), planes=planes)
            b = patch_gather_cuda.patch_gather_plain(
                t(im), t(x), t(y), (self.OH, self.OW), planes=planes)
            for p, q in zip(a[:-1], b[:-1]):
                np.testing.assert_array_equal(p.numpy(), q.numpy())
        assert dict(patch_gather_cuda.LAUNCHES) == before

    @pytest.mark.parametrize("out_hw,rem", [((45, 61), 1), ((46, 61), 2),
                                            ((47, 61), 3)])
    @pytest.mark.parametrize("layout", ["flat", "planes"])
    def test_ragged_raster_offset_view_matches_pallas(self, out_hw, rem,
                                                      layout):
        """The kernel's ragged edges on the CPU path: rasters with N % 4 of
        1, 2 and 3, coordinates in contiguous views one float into their
        buffers (4-byte but not 16-byte aligned on the card), spread past
        the right and bottom edges so that corners clamp there. The rasters
        pad to the class's 48x64 one in the Pallas kernel, whose compile
        they share."""
        B = self.B
        oh, ow = out_hw
        N = oh * ow
        assert N % 4 == rem
        rng = np.random.default_rng(rem)
        im = rng.integers(0, 256, (B, self.H, self.W, 3), dtype=np.uint8)
        xx = np.tile(np.linspace(-0.9, 1.3, ow, dtype=np.float32), oh)
        yy = np.repeat(np.linspace(-0.8, 1.2, oh, dtype=np.float32), ow)
        x = (xx + rng.normal(0, 0.01, (B, N))).astype(np.float32)
        y = (yy + rng.normal(0, 0.01, (B, N))).astype(np.float32)
        bx, by = torch.zeros(B * N + 1), torch.zeros(B * N + 1)
        xv, yv = bx[1:].view(B, N), by[1:].view(B, N)
        xv.copy_(t(x))
        yv.copy_(t(y))
        assert xv.is_contiguous() and xv.storage_offset() == 1
        planes = layout == "planes"
        ref = bilinear_sample_patch_u8_pallas(
            jnp.asarray(im), jnp.asarray(x), jnp.asarray(y), out_hw,
            interpret=True, combine_layout=layout)
        got = patch_gather_cuda.bilinear_sample_patch_u8_cuda(
            t(im), xv, yv, out_hw, planes=planes)
        assert not bool(ref[-1]) and not bool(got[-1])
        if planes:
            ref = np.stack([np.asarray(p) for p in ref[:3]], -1)
            got = torch.stack(got[:3], -1)
        else:
            ref, got = np.asarray(ref[0]), got[0]
        assert got.shape == (B, oh, ow, 3)
        live = np.asarray(support_mask(t(x), t(y), self.H, self.W))
        assert live.any() and not live.all()
        np.testing.assert_array_equal(got.numpy().reshape(B, N, 3)[~live], 0)
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-2)

    def test_rejects_bad_inputs(self):
        im, (x, y) = self._im(), self._coords()
        size = (self.OH, self.OW)
        with pytest.raises(ValueError):
            patch_gather_cuda.bilinear_sample_patch_u8_cuda(
                t(im).float(), t(x), t(y), size)
        with pytest.raises(ValueError):
            patch_gather_cuda.bilinear_sample_patch_u8_cuda(
                t(im), t(x), t(y), (self.OH, self.OW - 1))
        with pytest.raises(TypeError):
            patch_gather_cuda.bilinear_sample_patch_u8_cuda(
                t(im), t(x).double(), t(y).double(), size)


def test_header_edit_changes_build_hash(tmp_path, monkeypatch):
    """The build hash covers csrc/*.cuh, so an edited header rebuilds."""
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    header = tmp_path / "common.cuh"
    header.write_text("// v1\n")
    monkeypatch.setattr(cuda_build, "CSRC", str(tmp_path))
    assert cuda_build.sources() == [str(tmp_path / "k.cu")]
    before = cuda_build.source_digest()
    assert cuda_build.source_digest() == before
    header.write_text("// v2\n")
    assert cuda_build.source_digest() != before
