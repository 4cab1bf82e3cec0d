"""The port's N-view chain and ``cli stitch-multi`` against the JAX package,
on the CPU.

- ``chain_meshes``: against the reference's junction algebra
  (tests/goldens/threeview_parity.npz, atol 2e-2 after the reference's
  re-basing, as tests/test_entry_and_multiview.py) and against JAX's
  ``chain_meshes`` on the same pair meshes (1e-3 px at three and four
  views, 1 px jitter: both solve the junctions' TPS systems in float32
  with different routines, and the gap grows with each junction, which
  re-solves over a wider extent; five views measured 2.5e-3 px).
- ``composite_chain`` and ``stitch_multi_view``: JAX on its XLA composite
  route (``pallas_fused=False, pallas_gather=False``), the function of
  the port's gather route B (K3 and K4, plain on the CPU); frames within
  ``assert_frames_close`` (tests/test_torch_stitch.py). The port's route A
  (K2, its default) equals its route B bit for bit; its yuv420 converts
  the float fusion, as JAX's XLA route does.
"""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stabstitch2_tpu.config import StitchConfig as JStitchConfig
from stabstitch2_tpu.pipeline import threeview as j_tv
from stabstitch2_tpu.pipeline.stitcher import init_stitcher as j_init_stitcher
from stabstitch2_tpu_torch import cli
from stabstitch2_tpu_torch.config import StitchConfig
from stabstitch2_tpu_torch.pipeline import threeview as tv
from stabstitch2_tpu_torch.pipeline.stitcher import init_stitcher
from stabstitch2_tpu_torch.utils.weights import from_jax_params

from synthetic import _texture
from test_torch_stitch import assert_frames_close

MH, MW, CHUNK, BUCKET = 128, 160, 4, 32


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads (tests/test_torch_entry.py: tier-1's workers
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def views(T, seed=0, n=3):
    """n crops of one texture panorama, each jittered per frame
    (tests/test_entry_and_multiview.py's three-view clip)."""
    rng = np.random.default_rng(seed)
    pano = _texture(MH + 16, MW * 2 + 32, seed=9)
    out = []
    for k in range(n):
        x0 = k * (MW // 2)
        frames = []
        for _ in range(T):
            j = rng.integers(0, 8, 2)
            frames.append(pano[j[0]:j[0] + MH, x0 + j[1]:x0 + j[1] + MW])
        out.append(np.stack(frames).astype(np.uint8))
    return out


def write_views(clip_dir, vs):
    import cv2

    for k, v in enumerate(vs):
        d = os.path.join(clip_dir, f"video{k + 1}")
        os.makedirs(d)
        for t, f in enumerate(v):
            cv2.imwrite(os.path.join(d, f"{t:04d}.jpg"), f)


@pytest.fixture(scope="module")
def stitchers():
    """A float32 JAX stitcher on its XLA route and the port with its
    weights, on route A (default) and route B."""
    js = j_init_stitcher(rng_seed=0, model_h=MH, model_w=MW, chunk=CHUNK,
                         compute_dtype=jnp.float32,
                         config=JStitchConfig(canvas_bucket=BUCKET,
                                              pallas_fused=False,
                                              pallas_gather=False))
    tonp = lambda v: jax.tree_util.tree_map(np.asarray, v)  # noqa: E731
    st = init_stitcher(0, StitchConfig(canvas_bucket=BUCKET), MH, MW, CHUNK,
                       compute_dtype=torch.float32, device="cpu")
    sds = from_jax_params(tonp(js.spatial_vars), tonp(js.temporal_vars),
                          tonp(js.smooth_vars))
    for net, sd in zip((st.spatial_net, st.temporal_net, st.smooth_net), sds):
        net.load_state_dict(sd, strict=True)
    st_b = dataclasses.replace(st, config=StitchConfig(canvas_bucket=BUCKET,
                                                       fused_warp=False))
    return js, st, st_b


class TestChainMeshes:
    def test_junction_algebra_matches_reference(self, goldens):
        g = goldens("threeview_parity")
        pairs = [(torch.from_numpy(g["w12_m1"]), torch.from_numpy(g["w12_m2"])),
                 (torch.from_numpy(g["w23_m1"]), torch.from_numpy(g["w23_m2"]))]
        got = tv.chain_meshes(pairs, int(g["img_h"]), int(g["img_w"]),
                              int(g["model_h"]), int(g["model_w"]))
        assert len(got) == 3
        sub = np.asarray([g["wmin"], g["hmin"]], np.float32)
        for m, name in zip(got, ("view0", "view1", "view2")):
            np.testing.assert_allclose(m.numpy() - sub, g[name], atol=2e-2,
                                       rtol=1e-5, err_msg=name)

    @pytest.mark.parametrize("n_views", [3, 4])
    def test_matches_jax(self, n_views):
        rng = np.random.default_rng(n_views)
        base = np.stack(np.meshgrid(np.linspace(0, MW, 9),
                                    np.linspace(0, MH, 7)), -1)
        pairs = [tuple((base + rng.normal(0, 1, (4, 7, 9, 2))
                        + [60.0 * (j + k), 0.0]).astype(np.float32)
                       for k in (0, 1)) for j in range(n_views - 1)]
        got = tv.chain_meshes([tuple(map(torch.from_numpy, p)) for p in pairs],
                              2 * MH, 2 * MW, MH, MW)
        want = j_tv.chain_meshes([tuple(map(jnp.asarray, p)) for p in pairs],
                                 2 * MH, 2 * MW, MH, MW)
        assert len(got) == len(want) == n_views
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-3)


class TestCompositeChain:
    @pytest.fixture(scope="class")
    def chain(self):
        rng = np.random.default_rng(0)
        T, H, W = 2, 60, 80
        imgs = [rng.integers(0, 255, (T, H, W, 3), dtype=np.uint8)
                for _ in range(3)]
        base = np.stack(np.meshgrid(np.linspace(0, W, 9),
                                    np.linspace(0, H, 7)), -1)[None]
        meshes = [(base + rng.normal(0, 2, (T, 7, 9, 2))
                   + [30.0 * k, 0.0]).astype(np.float32) for k in range(3)]
        return imgs, meshes

    @pytest.mark.parametrize("fusion,fmt", [("AVERAGE", "bgr"),
                                            ("LINEAR", "bgr"),
                                            ("AVERAGE", "yuv420")])
    def test_matches_jax(self, chain, fusion, fmt):
        imgs, meshes = chain
        kw = dict(canvas_bucket=16, fusion_mode=fusion, download_format=fmt)
        want = j_tv.composite_chain(
            imgs, [jnp.asarray(m) for m in meshes],
            JStitchConfig(pallas_fused=False, pallas_gather=False, **kw),
            chunk=2)
        tmeshes = [torch.from_numpy(m) for m in meshes]
        a = tv.composite_chain(imgs, tmeshes, StitchConfig(**kw), chunk=2)
        b = tv.composite_chain(imgs, tmeshes,
                               StitchConfig(fused_warp=False, **kw), chunk=2)
        assert a.shape == np.asarray(want).shape
        assert a.shape[2] > 80 + 30 and a.max() > 10
        assert_frames_close(a, np.asarray(want))
        if fmt == "bgr":    # route B's yuv420 is chained, JAX's here is not
            np.testing.assert_array_equal(a, b)
            assert_frames_close(b, np.asarray(want))


class TestStitchMulti:
    def test_stitch_multi_view_matches_jax(self, stitchers, tmp_path):
        js, st, st_b = stitchers
        write_views(str(tmp_path / "clip"), views(7))
        want = j_tv.stitch_multi_view(js, str(tmp_path / "clip"))
        got = tv.stitch_multi_view(st_b, str(tmp_path / "clip"))
        assert got.shape == np.asarray(want).shape
        assert got.shape[0] == 7 and got.shape[2] >= MW and got.max() > 10
        assert_frames_close(got, np.asarray(want))
        np.testing.assert_array_equal(
            tv.stitch_multi_view(st, str(tmp_path / "clip")), got)

    def test_begin_finish_formats(self, stitchers):
        """I420 uploads land on the BGR uploads' panorama within the
        inputs' own 4:2:0 round trip (tests/test_entry_and_multiview.py's
        bound); the yuv420 download is packed I420 of even sizes that the
        canvas describes."""
        from stabstitch2_tpu_torch.data.video_io import bgr_to_i420

        _, st, _ = stitchers
        vs = views(8, seed=1)
        packed = [bgr_to_i420(v) for v in vs]
        frames, fmt = tv.stitch_multi_finish(tv.stitch_multi_begin(st, vs))
        assert fmt == "bgr" and frames.shape[0] == 8
        up, _ = tv.stitch_multi_finish(tv.stitch_multi_begin(st, packed))
        assert up.shape == frames.shape
        assert np.abs(up.astype(np.float32) - frames).mean() < 8.0
        st_y = dataclasses.replace(st, config=StitchConfig(
            canvas_bucket=BUCKET, download_format="yuv420"))
        pending = tv.stitch_multi_begin(st_y, packed)
        yuv, fmt = tv.stitch_multi_finish(pending)
        c = pending.composite.canvas
        assert fmt == "i420" and yuv.shape == (8, c.out_h * 3 // 2, c.out_w)
        assert c.out_h % 2 == 0 and c.out_w % 2 == 0


class TestCLI:
    def test_cuda_is_the_default_and_is_required(self, tmp_path):
        """``stitch-multi`` and ``metric`` run on the card unless asked for
        the CPU, and raise without one."""
        if torch.cuda.is_available():
            return
        for argv in (["stitch-multi", "--video_dir", str(tmp_path),
                      "--output", str(tmp_path / "o.mp4")],
                     ["metric", "--test_path", str(tmp_path)]):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                cli.main(argv)

    def test_single_clip_and_dataset(self, tmp_path):
        """A clip directory writes --output itself; a dataset directory
        writes <output>/<clip>.mp4, also for one clip (the mode is the
        directory's shape). Defaults: bf16 trunks, I420 uploads, yuv420."""
        import cv2

        write_views(str(tmp_path / "clip"), views(7, seed=2))
        out = tmp_path / "pano.mp4"
        assert cli.main(["stitch-multi", "--video_dir", str(tmp_path / "clip"),
                         "--output", str(out), "--chunk", "4",
                         "--device", "cpu"]) == 0
        cap = cv2.VideoCapture(str(out))
        n = 0
        while cap.read()[0]:
            n += 1
        cap.release()
        assert n == 7

        write_views(str(tmp_path / "ds" / "clipA"), views(7, seed=3, n=2))
        assert cli.main(["stitch-multi", "--video_dir", str(tmp_path / "ds"),
                         "--output", str(tmp_path / "out"), "--chunk", "4",
                         "--device", "cpu"]) == 0
        assert sorted(os.listdir(tmp_path / "out")) == ["clipA.mp4"]

    def test_bad_clips_are_skipped(self, tmp_path, capsys):
        write_views(str(tmp_path / "ds" / "short"), views(5, seed=4, n=2))
        rc = cli.main(["stitch-multi", "--video_dir", str(tmp_path / "ds"),
                       "--output", str(tmp_path / "out"), "--device", "cpu"])
        err = capsys.readouterr().err
        assert rc == 1 and "short: stitch failed" in err and "frames" in err
        (tmp_path / "empty").mkdir()
        assert cli.main(["stitch-multi", "--video_dir", str(tmp_path / "empty"),
                         "--output", str(tmp_path / "o2"),
                         "--device", "cpu"]) == 1
