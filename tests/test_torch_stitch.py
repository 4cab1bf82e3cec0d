"""The port's two-view stitch slice as a whole against the JAX package.

A random-weight float32 JAX stitcher at 128x160 (the size of
tests/test_pipeline.py) and the port, carrying the same weights through
``utils/weights.py:from_jax_params``, stitch one ``tests/synthetic.py``
clip on the CPU. The JAX frames come from ``composite_begin(...,
pallas_fused=True)``, the Pallas fused warp in interpret mode.

Tolerances, from what the two float32 implementations can agree on:
- smooth and stitched meshes: 1e-3 px (measured ~1e-4 px: convolutions,
  matrix products and the DLT/TPS solves round differently);
- uint8 frames: <= 1% of values differ at all and <= 1e-4 of them by more
  than one level. The larger differences are view-border pixels: a sample
  point within ~1e-4 px of the image edge is live on one side and dead
  (exact 0) on the other, since the two sides solve the TPS system with
  different float32 LAPACK routines.
"""

import ast
import pathlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stabstitch2_tpu.config import StitchConfig as JStitchConfig
from stabstitch2_tpu.pipeline import transport as j_transport
from stabstitch2_tpu.pipeline.compositor import composite_begin as j_begin
from stabstitch2_tpu.pipeline.compositor import composite_finish as j_finish
from stabstitch2_tpu.pipeline.smoothing import smooth_all_windows as j_smooth
from stabstitch2_tpu.pipeline.stitcher import init_stitcher as j_init_stitcher
from stabstitch2_tpu_torch import cli
from stabstitch2_tpu_torch.config import StitchConfig
from stabstitch2_tpu_torch.pipeline import transport
from stabstitch2_tpu_torch.pipeline.compositor import composite_video
from stabstitch2_tpu_torch.pipeline.smoothing import smooth_all_windows
from stabstitch2_tpu_torch.pipeline.stitcher import (VideoStitcher,
                                                     init_stitcher,
                                                     model_input)
from stabstitch2_tpu_torch.utils.weights import from_jax_params

from synthetic import make_two_view_clip, write_clip_dirs

MH, MW, CHUNK, BUCKET = 128, 160, 4, 32
REPO = pathlib.Path(__file__).resolve().parent.parent


def assert_frames_close(got, ref):
    assert got.shape == ref.shape, (got.shape, ref.shape)
    d = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    assert (d > 0).mean() <= 1e-2, (d > 0).mean()
    assert (d > 1).mean() <= 1e-4, ((d > 1).mean(), d.max())


@pytest.fixture(scope="module")
def run():
    """Both stitches of one 8-frame clip, AVERAGE fusion."""
    v1, v2 = make_two_view_clip(num_frames=8, height=MH, width=MW,
                                overlap=0.6, shake_px=2.0, seed=5)
    js = j_init_stitcher(rng_seed=0, model_h=MH, model_w=MW, chunk=CHUNK,
                         compute_dtype=jnp.float32,
                         config=JStitchConfig(canvas_bucket=BUCKET))
    lo1 = v1.astype(np.float32) / 127.5 - 1.0
    lo2 = v2.astype(np.float32) / 127.5 - 1.0
    smooth = js.motion_smooth(lo1, lo2)
    jframes, jcanvas = j_finish(j_begin(
        v1, v2, smooth["smooth_mesh1"], smooth["smooth_mesh2"],
        config=js.config, chunk=CHUNK, model_size=(MH, MW), pallas_fused=True))
    tonp = lambda v: jax.tree_util.tree_map(np.asarray, v)  # noqa: E731
    st = init_stitcher(0, StitchConfig(canvas_bucket=BUCKET), MH, MW, CHUNK,
                       compute_dtype=torch.float32, device="cpu")
    sds = from_jax_params(tonp(js.spatial_vars), tonp(js.temporal_vars),
                          tonp(js.smooth_vars))
    for net, sd in zip((st.spatial_net, st.temporal_net, st.smooth_net), sds):
        net.load_state_dict(sd, strict=True)
    result = st.stitch_arrays(v1, None, v2, None)
    return dict(v1=v1, v2=v2, js=js, st=st, jsmooth=tonp(smooth),
                jframes=jframes, jcanvas=jcanvas, result=result)


class TestStitchSlice:
    def test_meshes_match_jax(self, run):
        r, js = run["result"], run["jsmooth"]
        for k in ("smooth_mesh1", "smooth_mesh2", "ori_mesh1", "ori_mesh2"):
            np.testing.assert_allclose(getattr(r, k).numpy(), js[k], atol=1e-3,
                                       err_msg=k)

    def test_frames_match_jax(self, run):
        r = run["result"]
        assert (r.canvas.out_h, r.canvas.out_w) == (run["jcanvas"].out_h,
                                                    run["jcanvas"].out_w)
        assert r.frames.dtype == np.uint8 and r.frames.max() > 10
        assert_frames_close(r.frames, run["jframes"])

    @pytest.mark.parametrize("fusion", ["AVERAGE", "LINEAR"])
    def test_composite_on_jax_meshes(self, run, fusion):
        """The compositor alone: both sides warp with the JAX smooth meshes."""
        m1, m2 = run["jsmooth"]["smooth_mesh1"], run["jsmooth"]["smooth_mesh2"]
        if fusion == "AVERAGE":
            ref = run["jframes"]
        else:
            ref, _ = j_finish(j_begin(
                run["v1"], run["v2"], jnp.asarray(m1), jnp.asarray(m2),
                config=JStitchConfig(canvas_bucket=BUCKET, fusion_mode=fusion),
                chunk=CHUNK, model_size=(MH, MW), pallas_fused=True))
        got, _ = composite_video(
            run["v1"], run["v2"], torch.tensor(m1), torch.tensor(m2),
            config=StitchConfig(canvas_bucket=BUCKET, fusion_mode=fusion),
            chunk=CHUNK, model_size=(MH, MW))
        assert_frames_close(got, ref)

    def test_transport_and_windows_match_jax(self, run):
        rng = np.random.default_rng(0)
        tm1, sm1, tm2, sm2 = (rng.normal(0, s, (9, 7, 9, 2)).astype(np.float32)
                              for s in (2.0, 4.0, 2.0, 4.0))
        ts = transport.transport_both_views(*map(torch.from_numpy,
                                                 (tm1, sm1, tm2, sm2)), MH, MW)
        jts = j_transport.transport_both_views(tm1, sm1, tm2, sm2, MH, MW)
        for a, b in zip(ts, jts):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-3)
        smesh = [transport.stitched_meshes(torch.from_numpy(s), MH, MW)
                 for s in (sm1, sm2)]
        got = smooth_all_windows(run["st"].smooth_net, *smesh, *ts, chunk=2)
        want = j_smooth(run["js"].smooth_net, run["js"].smooth_vars,
                        *[jnp.asarray(s.numpy()) for s in smesh],
                        *[jnp.asarray(x.numpy()) for x in ts], chunk=2)
        for k in ("smooth_mesh1", "smooth_mesh2", "win_smooth_path1"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-4, atol=1e-3, err_msg=k)


class TestEntryPoints:
    def test_cuda_is_the_default_and_is_required(self):
        if torch.cuda.is_available():
            assert init_stitcher(device="cuda").device.type == "cuda"
            return
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init_stitcher()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["stitch", "--test_path", ".", "--output_path", "."])

    def test_unported_options_raise(self):
        # FAST and yuv420 are ported: they construct
        StitchConfig(warp_mode="FAST", download_format="yuv420")
        for kw in (dict(fusion_mode="MEDIAN"), dict(download_format="nv12"),
                   dict(warp_mode="CUBIC"), dict(coord_stride=0)):
            with pytest.raises(ValueError):
                StitchConfig(**kw)
        st = init_stitcher(0, model_h=MH, model_w=MW, device="cpu")
        frames = np.zeros((6, 96, 120, 3), np.uint8)
        with pytest.raises(ValueError, match="too short"):
            st.stitch_arrays(frames, None, frames, None)

    def test_cli_stitch_writes_mp4(self, tmp_path):
        write_clip_dirs(str(tmp_path / "data"), num_frames=7, height=360,
                        width=480, seed=1)
        rc = cli.main(["stitch", "--test_path", str(tmp_path / "data"),
                       "--output_path", str(tmp_path / "out"),
                       "--fusion_mode", "LINEAR", "--device", "cpu"])
        out = tmp_path / "out" / "clip0.mp4"
        assert rc == 0 and out.exists() and out.stat().st_size > 1000


class TestModelInput:
    """The model input: given (lo), or resized from the frames on the
    device, as the JAX package and its CLI do."""

    @pytest.mark.parametrize("hw,model_hw", [((480, 640), (360, 480)),
                                             ((96, 120), (128, 160)),
                                             ((360, 480), (360, 480))])
    def test_resize_matches_jax_image_resize(self, hw, model_hw):
        hi = np.random.default_rng(2).integers(0, 256, (2, *hw, 3), np.uint8)
        got = model_input(torch.from_numpy(hi), *model_hw)
        ref = jax.image.resize(jnp.asarray(hi, jnp.float32),
                               (2, *model_hw, 3), "bilinear") / 127.5 - 1.0
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)

    def test_lo_none_at_another_size_matches_jax(self, run):
        """Frames of 192x240 for the 128x160 model: both sides resize on
        the device (lo=None) and stitch."""
        v1, v2 = make_two_view_clip(num_frames=8, height=192, width=240,
                                    overlap=0.6, shake_px=2.0, seed=6)
        ref = run["js"].stitch_arrays(v1, None, v2, None)
        got = run["st"].stitch_arrays(v1, None, v2, None)
        for k in ("smooth_mesh1", "smooth_mesh2"):
            np.testing.assert_allclose(getattr(got, k).numpy(),
                                       np.asarray(getattr(ref, k)),
                                       atol=1e-3, err_msg=k)
        assert (got.canvas.out_h, got.canvas.out_w) == (ref.canvas.out_h,
                                                        ref.canvas.out_w)
        assert got.frames.max() > 10
        assert_frames_close(got.frames, np.asarray(ref.frames))

    def test_float_frames_take_the_float_route(self, run):
        """Float 0..255 frames with lo given keep their fractions (JAX
        composites them on its float route) instead of being truncated."""
        rng = np.random.default_rng(3)
        f1, f2 = (np.minimum(v + rng.uniform(0, 1, v.shape), 255.0)
                  .astype(np.float32) for v in (run["v1"], run["v2"]))
        lo1, lo2 = f1 / 127.5 - 1.0, f2 / 127.5 - 1.0
        ref = run["js"].stitch_arrays(f1, lo1, f2, lo2)
        got = run["st"].stitch_arrays(f1, lo1, f2, lo2)
        assert got.frames.max() > 10
        assert_frames_close(got.frames, np.asarray(ref.frames))

    def test_cli_stitch_passes_no_model_input(self, tmp_path, monkeypatch):
        """The CLI hands the frames as uint8, packed I420 by default, with
        no model input: the device makes it, as in the JAX CLI."""
        write_clip_dirs(str(tmp_path / "data"), num_frames=7, height=96,
                        width=120, seed=1)
        seen = []

        def record(self, hi1, lo1, hi2, lo2):
            seen.append((hi1.shape, hi1.dtype, lo1, lo2))
            raise ValueError("recorded")

        monkeypatch.setattr(VideoStitcher, "stitch_begin", record)
        rc = cli.main(["stitch", "--test_path", str(tmp_path / "data"),
                       "--output_path", str(tmp_path / "out"),
                       "--device", "cpu"])
        assert rc == 1
        assert seen == [((7, 144, 120), np.uint8, None, None)]


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = sorted((REPO / "stabstitch2_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax", "orbax",
                               "stabstitch2_tpu"), (path, mod)
