"""Route A's yuv420 download, route B against route A, the planar branch
and float input, the port against the JAX package (the rest of
tests/test_torch_routes.py's ``TestRoutes``, on its clip and helpers).

- route A yuv420 against JAX ``pallas_fused=True``; B-planar against JAX
  ``_composite_chunk(..., out_format='yuv420', pallas_gather=True)``, and
  from ``composite_begin`` where the fused route does not apply
  (``coord_stride=4``); float frames against JAX's XLA route. Frames
  within ``assert_frames_close`` (tests/test_torch_stitch.py).
- route B equals route A bit for bit (both plain on the CPU).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stabstitch2_tpu.config import StitchConfig as JStitchConfig
from stabstitch2_tpu.pipeline import compositor as j_comp
from stabstitch2_tpu_torch.config import StitchConfig
from stabstitch2_tpu_torch.pipeline import compositor

from test_torch_routes import (BUCKET, CHUNK, H, W, _jax, _port,
                               _same_canvas, clip, t)  # noqa: F401 (fixture)
from test_torch_stitch import assert_frames_close


class TestRoutes:
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
