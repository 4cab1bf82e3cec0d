"""The port's two kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain version, which is held against the
Pallas kernel in interpret mode on the same seeded numpy inputs:

- K1 ``ops/corr_cuda.py`` vs ``ops/pallas_corr.py:cost_volume_fused``
  (atol/rtol 1e-5, as TestPallasCostVolume);
- K2 ``ops/fused_warp_cuda.py`` vs ``ops/pallas_fused.py:fused_warp_planes``
  (<= 1 uint8 LSB, < 5e-3 of pixels differing, exact zeros at dead
  pixels on both sides, as TestFusedWarp).

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
from stabstitch2_tpu.ops.tps import tps_params as j_tps_params
from stabstitch2_tpu_torch.ops import corr_cuda, fused_warp_cuda


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
