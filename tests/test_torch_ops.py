"""Geometry ops of the PyTorch port against the JAX package and the goldens.

The same numpy inputs, made from a seed, go through each JAX function and
its counterpart in ``stabstitch2_tpu_torch`` on the CPU. Tolerances are
those of the JAX package's own tests in ``tests/test_geometry.py``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stabstitch2_tpu.ops import dlt as j_dlt
from stabstitch2_tpu.ops import homography as j_homo
from stabstitch2_tpu.ops import interp as j_interp
from stabstitch2_tpu.ops import mesh as j_mesh
from stabstitch2_tpu.ops import tps as j_tps
from stabstitch2_tpu.ops import blend as j_blend
from stabstitch2_tpu.ops.cost_volume import ccl_flow as j_ccl_flow
from stabstitch2_tpu_torch.ops import blend, dlt, homography, interp, mesh, tps
from stabstitch2_tpu_torch.ops.cost_volume import ccl_flow


def nchw_to_nhwc(x):
    return np.transpose(x, (0, 2, 3, 1))


def t(x):
    return torch.from_numpy(np.array(x))


def n(x):
    return np.asarray(x)


def _mesh_case(seed=0, B=2, sigma=0.06):
    rng = np.random.default_rng(seed)
    xs, ys = np.linspace(-1, 1, 9), np.linspace(-1, 1, 7)
    base = np.stack(np.meshgrid(xs, ys), -1).reshape(-1, 2)
    src = (base[None] + rng.normal(0, sigma, (B, 63, 2))).astype(np.float32)
    tgt = np.tile(base[None], (B, 1, 1)).astype(np.float32)
    return src, tgt


class TestMesh:
    def test_rigid_normalize_roundtrip(self):
        for h, w in ((360, 480), (128, 160)):
            m = mesh.rigid_mesh(h, w)
            # torch.linspace and jnp.linspace round differently (<= 1 ulp)
            np.testing.assert_allclose(n(m), n(j_mesh.rigid_mesh(h, w)),
                                       rtol=1e-6)
            np.testing.assert_array_equal(n(m[-1, -1]), [w, h])
            np.testing.assert_allclose(n(m[0, 1]), [w / 8.0, 0.0], rtol=1e-6)
            nm = mesh.normalize_mesh(m, h, w)
            np.testing.assert_allclose(
                n(nm), n(j_mesh.normalize_mesh(j_mesh.rigid_mesh(h, w), h, w)),
                atol=1e-6)
            np.testing.assert_allclose(n(mesh.denormalize_mesh(nm, h, w)),
                                       n(m), atol=1e-4)

    def test_h2mesh_matches_jax(self, goldens):
        g = goldens("dlt")
        H = j_dlt.solve_dlt(jnp.asarray(g["src"]), jnp.asarray(g["dst"]))
        rig = j_mesh.rigid_mesh(360, 480)
        ref = j_mesh.h2mesh(H, rig)
        got = mesh.h2mesh(t(n(H)), mesh.rigid_mesh(360, 480))
        np.testing.assert_allclose(n(got), n(ref), rtol=1e-3, atol=2e-2)


class TestDLT:
    def test_matches_reference_and_jax(self, goldens):
        g = goldens("dlt")
        H = dlt.solve_dlt(t(g["src"]), t(g["dst"]))
        np.testing.assert_allclose(n(H), g["H"], rtol=2e-4, atol=2e-4)
        ref = j_dlt.solve_dlt(jnp.asarray(g["src"]), jnp.asarray(g["dst"]))
        np.testing.assert_allclose(n(H), n(ref), rtol=2e-4, atol=2e-4)


class TestHomography:
    @pytest.mark.parametrize("grow", [(0, 0), (9, 13)])
    def test_warp_matches_reference_and_jax(self, goldens, grow):
        g = goldens("homo")
        img = nchw_to_nhwc(g["img"])
        h, w = img.shape[1] + grow[0], img.shape[2] + grow[1]
        got = homography.homo_warp(t(img), t(g["theta"]), (h, w))
        golden = nchw_to_nhwc(g["out"] if grow == (0, 0) else g["out_big"])
        np.testing.assert_allclose(n(got), golden, rtol=1e-4, atol=1e-4)
        ref = j_homo.homo_warp(jnp.asarray(img), jnp.asarray(g["theta"]), (h, w))
        np.testing.assert_allclose(n(got), n(ref), rtol=1e-4, atol=1e-4)

    def test_normalize_homography_matches_jax(self):
        rng = np.random.default_rng(3)
        H = (np.eye(3)[None] + rng.normal(0, 0.01, (4, 3, 3))).astype(np.float32)
        got = homography.normalize_homography(t(H), 45, 60)
        ref = j_homo.normalize_homography(jnp.asarray(H), 45, 60)
        np.testing.assert_allclose(n(got), n(ref), rtol=1e-5, atol=1e-6)


class TestTPS:
    def test_params_and_coords_match_jax(self):
        src, tgt = _mesh_case()
        T = tps.tps_params(t(src), t(tgt))
        Tj = j_tps.tps_params(jnp.asarray(src), jnp.asarray(tgt))
        for out_size, span in (((36, 48), None), ((29, 48), (25, 40))):
            xr, yr = j_tps.tps_sample_coords(Tj, jnp.asarray(src), out_size,
                                             grid_span=span)
            x, y = tps.tps_sample_coords(T, t(src), out_size, grid_span=span)
            np.testing.assert_allclose(n(x), n(xr), atol=2e-4)
            np.testing.assert_allclose(n(y), n(yr), atol=2e-4)

    @pytest.mark.parametrize("device,previous,switched", [
        ("cuda", "Default", True), ("cuda:1", "Magma", True),
        ("cuda", "Cusolver", False), ("cpu", "Default", False),
        ("meta", "Magma", False)])
    def test_cublas_route_by_device(self, monkeypatch, device, previous,
                                    switched):
        """On a card the solve runs under cuSOLVER and the setting comes
        back after it, an error included; elsewhere, or where cuSOLVER is
        already set, the setting is not written (no card needed: the
        setting is stood in for)."""
        backend = torch._C._LinalgBackend
        state, writes = [getattr(backend, previous)], []

        def setting(library=None):
            if library is not None:
                writes.append(library)
                state[0] = (backend.Cusolver if library == "cusolver"
                            else library)
            return state[0]

        monkeypatch.setattr(torch.backends.cuda, "preferred_linalg_library",
                            setting)
        inside = []
        with pytest.raises(RuntimeError, match="solve failed"):
            with tps.batched_lu_on_cublas(device):
                inside.append(setting())
                raise RuntimeError("solve failed")
        old = getattr(backend, previous)
        assert inside == [backend.Cusolver if switched else old]
        assert writes == (["cusolver", old] if switched else [])
        assert state == [old]

    @pytest.mark.parametrize("B", [1, 16, 24])
    def test_cpu_params_on_the_default_route(self, B):
        """On the CPU ``tps_params`` is the plain ``solve_ex`` bit for bit,
        whatever the batch, and leaves the linear-algebra setting alone."""
        from stabstitch2_tpu_torch.train import common

        assert common.batched_lu_on_cublas is tps.batched_lu_on_cublas
        src, tgt = (t(a) for a in _mesh_case(seed=4, B=B))
        before = torch.backends.cuda.preferred_linalg_library()
        got = tps.tps_params(src, tgt)
        rhs = torch.cat([tgt, torch.zeros(B, 3, 2)], dim=1)
        want = torch.linalg.solve_ex(tps._system(src), rhs).result
        torch.testing.assert_close(got, want.transpose(1, 2), atol=0, rtol=0)
        assert torch.backends.cuda.preferred_linalg_library() == before

    def test_shared_source_matches_per_batch_solve(self):
        src, tgt = _mesh_case(seed=1, B=3)
        shared = tps.tps_params_shared_source(t(tgt[0]), t(src))
        ref = j_tps.tps_params_shared_source(jnp.asarray(tgt[0]),
                                             jnp.asarray(src))
        pts = t(src[:, :40])
        got = tps.tps_transform_points(pts, t(np.broadcast_to(tgt[0], src.shape)),
                                       t(src), T=shared)
        want = j_tps.tps_transform_points(
            jnp.asarray(src[:, :40]), jnp.asarray(np.broadcast_to(tgt[0], src.shape)),
            jnp.asarray(src), T=ref)
        np.testing.assert_allclose(n(got), n(want), rtol=1e-3, atol=1e-4)

    def test_image_warp_matches_golden(self, goldens):
        """Spline coordinates + the NORMAL sampler against the reference's
        float64 TPS warp (atol 2e-2, as test_geometry's TestTPSWarp)."""
        g = goldens("tps")
        img = nchw_to_nhwc(g["img"])
        B, h, w, C = img.shape
        for out_size, key in (((h, w), "out_normal"), ((h + 12, w + 8), "out_big")):
            T = tps.tps_params(t(g["source"]), t(g["target"]))
            x, y = tps.tps_sample_coords(T, t(g["source"]), out_size)
            got = interp.bilinear_sample(t(img), x, y).reshape(B, *out_size, C)
            np.testing.assert_allclose(n(got), nchw_to_nhwc(g[key]), atol=2e-2)

    @pytest.mark.parametrize("mode,dtype,fused", [
        ("NORMAL", np.uint8, True), ("NORMAL", np.uint8, False),
        ("NORMAL", np.float32, False), ("FAST", np.uint8, False),
        ("FAST", np.float32, False)])
    def test_warps_match_jax(self, mode, dtype, fused):
        """``tps_warp_with_mask`` on each of its routes (K2's, K3 then K4's
        or the float sampler, FAST) and ``tps_warp``, on the JAX package's
        coefficients. The two sides sum the spline in another order
        (test_params_and_coords_match_jax: 2e-4 normalized, 4e-3 px at
        this 40 px width), so a sample may move by that times the
        image's steepest slope, 255 per px for this noise: atol 1.0 on
        0..255, and 4e-3 on the masks (slope 1 per px)."""
        src, tgt = _mesh_case(seed=2, B=3)
        im = np.random.default_rng(3).integers(0, 255, (3, 30, 40, 3))
        im = im.astype(dtype)
        Tj = j_tps.tps_params(jnp.asarray(src), jnp.asarray(tgt))
        kw = dict(mode=mode, grid_span=(33, 47))
        got, mask = tps.tps_warp_with_mask(t(im), t(src), None, (36, 52),
                                           T=t(Tj), fused_warp=fused, **kw)
        want, mask_j = j_tps.tps_warp_with_mask(jnp.asarray(im),
                                                jnp.asarray(src), None,
                                                (36, 52), T=Tj, **kw)
        assert got.shape == (3, 36, 52, 3) and got.dtype == torch.float32
        np.testing.assert_allclose(n(got), n(want), atol=1.0)
        np.testing.assert_allclose(n(mask), n(mask_j), atol=4e-3)
        warped = tps.tps_warp(t(im), t(src), t(tgt), (36, 52), **kw)
        want = j_tps.tps_warp(jnp.asarray(im), jnp.asarray(src),
                              jnp.asarray(tgt), (36, 52), **kw)
        np.testing.assert_allclose(n(warped), n(want), atol=1.0)

    def test_transform_points_golden_and_jax(self, goldens):
        g = goldens("tps_point")
        got = tps.tps_transform_points(t(g["points"]), t(g["source"]),
                                       t(g["target"]))
        np.testing.assert_allclose(n(got), g["out"], rtol=1e-3, atol=1e-4)
        ref = j_tps.tps_transform_points(jnp.asarray(g["points"]),
                                         jnp.asarray(g["source"]),
                                         jnp.asarray(g["target"]))
        np.testing.assert_allclose(n(got), n(ref), rtol=1e-3, atol=1e-4)
        ctrl = tps.tps_transform_points(t(g["source"]), t(g["source"]),
                                        t(g["target"]))
        np.testing.assert_allclose(n(ctrl), g["target"], atol=5e-4)


class TestInterp:
    def _coords(self, seed, B=3, n_pts=4000, W=31):
        rng = np.random.default_rng(seed)
        x = rng.uniform(-1.8, 1.8, (B, n_pts)).astype(np.float32)
        y = rng.uniform(-1.8, 1.8, (B, n_pts)).astype(np.float32)
        specials = np.array([-1.0, -1.0 + 2.0 / W, 1.0 - 2.0 / W, 1.0,
                             -1.0 - 2.0 / W, 1.0 + 2.0 / W, 0.0], np.float32)
        x[:, :specials.size] = specials
        y[:, :specials.size] = specials[::-1]
        return x, y

    def test_bilinear_sample_matches_jax(self):
        rng = np.random.default_rng(11)
        im = rng.normal(0, 1, (3, 24, 31, 4)).astype(np.float32)
        x, y = self._coords(1)
        got = interp.bilinear_sample(t(im), t(x), t(y))
        ref = j_interp.bilinear_sample(jnp.asarray(im), jnp.asarray(x),
                                       jnp.asarray(y))
        np.testing.assert_allclose(n(got), n(ref), atol=1e-5)

    def test_patch_u8_matches_jax_and_four_gather(self):
        rng = np.random.default_rng(11)
        im = rng.integers(0, 256, (3, 24, 31, 3), dtype=np.uint8)
        x, y = self._coords(2)
        got = interp.bilinear_sample_patch_u8(t(im), t(x), t(y))
        ref = j_interp.bilinear_sample_patch_u8(jnp.asarray(im), jnp.asarray(x),
                                                jnp.asarray(y))
        np.testing.assert_allclose(n(got), n(ref), atol=1e-2)
        four = interp.bilinear_sample(t(im.astype(np.float32)), t(x), t(y))
        np.testing.assert_allclose(n(got), n(four), atol=1e-2)

    def test_patch_weights_pack_and_mask_match_jax(self):
        x, y = self._coords(3)
        got = interp._patch_weights_idx(t(x), t(y), 24, 31)
        ref = j_interp._patch_weights_idx(jnp.asarray(x), jnp.asarray(y), 24, 31)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(n(a), n(b), atol=1e-5)
        np.testing.assert_allclose(
            n(interp.bilinear_mask(24, 31, t(x), t(y))),
            n(j_interp.bilinear_mask(24, 31, jnp.asarray(x), jnp.asarray(y))),
            atol=1e-5)
        im = np.random.default_rng(4).integers(0, 256, (2, 5, 6, 3), dtype=np.uint8)
        np.testing.assert_array_equal(n(interp.pack_bgr_u8(t(im))),
                                      n(j_interp.pack_bgr_u8(jnp.asarray(im))))

    def test_patch_u8_nan_coords_zero(self):
        im = t(np.full((1, 8, 8, 3), 200, np.uint8))
        bad = torch.full((1, 5), float("nan"))
        np.testing.assert_array_equal(
            n(interp.bilinear_sample_patch_u8(im, bad, bad)), 0.0)


class TestCCL:
    def test_matches_reference_and_jax(self, goldens):
        g = goldens("ccl")
        f1, f2 = nchw_to_nhwc(g["f1"]), nchw_to_nhwc(g["f2"])
        got = ccl_flow(t(f1), t(f2))
        np.testing.assert_allclose(n(got), nchw_to_nhwc(g["flow"]),
                                   rtol=1e-3, atol=1e-4)
        ref = j_ccl_flow(jnp.asarray(f1), jnp.asarray(f2))
        np.testing.assert_allclose(n(got), n(ref), rtol=1e-3, atol=1e-4)


class TestBlend:
    def test_average_and_blur_match_jax(self):
        rng = np.random.default_rng(0)
        a = rng.uniform(0, 255, (2, 30, 34, 3)).astype(np.float32)
        b = rng.uniform(0, 255, (2, 30, 34, 3)).astype(np.float32)
        np.testing.assert_allclose(
            n(blend.average_fusion(t(a), t(b))),
            n(j_blend.average_fusion(jnp.asarray(a), jnp.asarray(b))),
            rtol=1e-5, atol=1e-3)
        x = rng.normal(0, 1, (1, 30, 34, 2)).astype(np.float32)
        np.testing.assert_allclose(
            n(blend.gaussian_blur(t(x))), n(j_blend.gaussian_blur(jnp.asarray(x))),
            rtol=1e-4, atol=1e-5)

    def test_linear_fusion_matches_jax(self):
        import jax

        rng = np.random.default_rng(1)
        H, W = 40, 60
        ref_m = np.zeros((2, H, W), np.float32)
        tgt_m = np.zeros((2, H, W), np.float32)
        ref_m[0, :, :40], tgt_m[0, :, 20:] = 1.0, 1.0
        ref_m[1, 5:, :45], tgt_m[1, :30, 15:] = 1.0, 1.0
        ref = rng.uniform(0, 255, (2, H, W, 3)).astype(np.float32) * ref_m[..., None]
        tgt = rng.uniform(0, 255, (2, H, W, 3)).astype(np.float32) * tgt_m[..., None]
        got = blend.linear_fusion(t(ref), t(tgt), t(ref_m), t(tgt_m))
        want = jax.vmap(j_blend.linear_fusion)(
            jnp.asarray(ref), jnp.asarray(tgt), jnp.asarray(ref_m),
            jnp.asarray(tgt_m))
        np.testing.assert_allclose(n(got), n(want), rtol=1e-4, atol=1e-2)
