"""The port's metric harness, scores and grid losses against the JAX package,
on the CPU.

Tolerances (those of the JAX package's tests/test_losses_metrics.py):
- ``psnr``, ``ssim``, the scores and the grid losses: rtol 1e-5 (the
  losses also against tests/goldens/grid_losses.npz, the reference's
  values; ``intra_grid_loss`` with atol 1e-7 as there);
- ``evaluate_video`` against JAX's on the same float32 weights at
  128x160, T = 10 and 13 (one 16-frame bucket): rtol 1e-4 with the bgr
  upload, 2e-3 with the i420 upload (the JAX test's bounds for its eager
  path and for uint8 against float inputs); the port's program against
  its own ``--eager_motion`` path at 1e-4 (the JAX test's bound for its
  program against its eager path). K3's plain version gives the float
  warp's coordinates on the CPU.
- the masked scores with the count as an int and as a tensor against the
  sliced scores and JAX's at 1e-5, and on the ``meta`` device, where a
  read of the count raises.
"""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stabstitch2_tpu.config import StitchConfig as JStitchConfig
from stabstitch2_tpu.metrics import harness as j_harness
from stabstitch2_tpu.metrics import psnr_ssim as j_ps
from stabstitch2_tpu.metrics import scores as j_scores
from stabstitch2_tpu.pipeline.stitcher import init_stitcher as j_init_stitcher
from stabstitch2_tpu.train import losses as j_losses
from stabstitch2_tpu_torch import cli
from stabstitch2_tpu_torch.config import StitchConfig
from stabstitch2_tpu_torch.data.video_io import load_video_pair
from stabstitch2_tpu_torch.metrics import harness, psnr_ssim, scores
from stabstitch2_tpu_torch.pipeline.stitcher import init_stitcher
from stabstitch2_tpu_torch.train import losses
from stabstitch2_tpu_torch.utils.weights import from_jax_params

from synthetic import make_two_view_clip, write_clip_dirs

MH, MW, CHUNK = 128, 160, 4
KEYS = {"psnr", "ssim", "stability", "distortion", "stability_ori",
        "distortion_ori"}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads (tests/test_torch_entry.py: tier-1's workers
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


class TestPsnrSsim:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_match_jax(self, seed):
        rng = np.random.default_rng(seed)
        a = rng.uniform(0, 255, (48, 64, 3)).astype(np.float32)
        b = np.clip(a + rng.normal(0, 20, a.shape), 0, 255).astype(np.float32)
        mask = (rng.uniform(size=(48, 64, 1)) > 0.3).astype(np.float32)
        for x, y in ((a, b), (a * mask, b * mask)):
            np.testing.assert_allclose(float(psnr_ssim.psnr(t(x), t(y))),
                                       float(j_ps.psnr(x, y)), rtol=1e-5)
            np.testing.assert_allclose(float(psnr_ssim.ssim(t(x), t(y))),
                                       float(j_ps.ssim(x, y)), rtol=1e-5)
        np.testing.assert_allclose(float(psnr_ssim.ssim(t(a), t(a))), 1.0,
                                   rtol=1e-6)
        np.testing.assert_allclose(float(psnr_ssim.ssim(t(a[..., 0]),
                                                        t(b[..., 0]))),
                                   float(j_ps.ssim(a[..., 0], b[..., 0])),
                                   rtol=1e-5)


class TestScores:
    def test_grid_losses_match_golden_and_jax(self, goldens):
        g = goldens("grid_losses")
        mesh5 = g["mesh5"]
        got = float(losses.inter_grid_loss_5d_ref(t(mesh5)))
        np.testing.assert_allclose(got, float(g["inter5"]), rtol=1e-5)
        np.testing.assert_allclose(
            got, float(j_losses.inter_grid_loss_5d_ref(jnp.asarray(mesh5))),
            rtol=1e-5)
        got = float(losses.intra_grid_loss(t(mesh5)))
        np.testing.assert_allclose(got, float(g["intra5"]), rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(
            got, float(j_losses.intra_grid_loss(jnp.asarray(mesh5))),
            rtol=1e-5, atol=1e-7)

    def test_paths_and_scores_match_jax(self):
        rng = np.random.default_rng(3)
        win_ori = rng.normal(0, 1, (6, 7, 7, 9, 2)).astype(np.float32)
        win_smooth = rng.normal(0, 1, (6, 7, 7, 9, 2)).astype(np.float32)
        got = scores.continue_paths(t(win_ori), t(win_smooth))
        want = j_scores.continue_paths(jnp.asarray(win_ori),
                                       jnp.asarray(win_smooth))
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
        path = got[1].numpy()
        np.testing.assert_allclose(
            float(scores.stability_score(t(path))),
            float(j_scores.stability_score(jnp.asarray(path))), rtol=1e-5)
        np.testing.assert_allclose(
            float(losses.path_smoothness_loss(t(win_ori))),
            float(j_losses.path_smoothness_loss(jnp.asarray(win_ori))),
            rtol=1e-5)
        base = np.stack(np.meshgrid(np.linspace(0, 480, 9),
                                    np.linspace(0, 360, 7)), -1)
        mesh = (base[None] + rng.normal(0, 6, (12, 7, 9, 2))).astype(np.float32)
        np.testing.assert_allclose(
            scores.distortion_per_frame(t(mesh)).numpy(),
            np.asarray(j_scores.distortion_per_frame(jnp.asarray(mesh))),
            rtol=1e-5)
        assert float(scores.stability_score(torch.ones(12, 7, 9, 2))) < 1e-10

    @pytest.mark.parametrize("count", ["int", "tensor"])
    @pytest.mark.parametrize("n", [7, 9, 12, 16])
    def test_masked_scores_equal_sliced(self, n, count):
        """The masked scores of a padded array with the count as an int or
        as a 0-dim tensor equal the scores of the slice and JAX's masked
        scores."""
        rng = np.random.default_rng(11)
        full = rng.normal(0, 1, (16, 7, 9, 2)).astype(np.float32)
        base = np.stack(np.meshgrid(np.linspace(0, 480, 9),
                                    np.linspace(0, 360, 7)), -1)
        mesh = (base[None] + rng.normal(0, 6, (16, 7, 9, 2))).astype(np.float32)
        path = np.concatenate(
            [full[:n], np.tile(full[n - 1:n], (16 - n, 1, 1, 1))], 0)
        n_valid = n if count == "int" else torch.tensor(n, dtype=torch.int32)
        got_stab = float(scores.stability_score_masked(t(path), n_valid))
        got_dist = float(scores.distortion_score_masked(t(mesh), n_valid))
        np.testing.assert_allclose(
            got_stab, float(scores.stability_score(t(full[:n]))), rtol=1e-5)
        np.testing.assert_allclose(
            got_dist, float(scores.distortion_score(t(mesh[:n]))), rtol=1e-5)
        np.testing.assert_allclose(
            got_stab, float(j_scores.stability_score_masked(
                jnp.asarray(path), jnp.int32(n))), rtol=1e-5)
        np.testing.assert_allclose(
            got_dist, float(j_scores.distortion_score_masked(
                jnp.asarray(mesh), jnp.int32(n))), rtol=1e-5)

    def test_masked_scores_read_no_count_on_the_host(self):
        """On the ``meta`` device no value exists, so any read of the count
        (``int()``, ``.item()``, a branch on it) raises: the masked scores
        and the program's ``stability_distortion`` run there, as a
        captured program needs."""
        meta = torch.device("meta")
        n = torch.empty((), dtype=torch.int32, device=meta)
        with pytest.raises(RuntimeError):
            int(n)
        path = torch.empty(16, 7, 9, 2, device=meta)
        for out in (scores.stability_score_masked(path, n),
                    scores.distortion_score_masked(path, n)):
            assert out.device == meta and out.shape == ()
        win = torch.empty(10, 7, 7, 9, 2, device=meta)
        got = scores.stability_distortion(win, win, path, path, n)
        assert [x.shape for x in got] == [()] * 4


@pytest.fixture(scope="module")
def stitchers():
    """A float32 JAX stitcher at 128x160 and the port with its weights."""
    js = j_init_stitcher(rng_seed=0, model_h=MH, model_w=MW, chunk=CHUNK,
                         compute_dtype=jnp.float32,
                         config=JStitchConfig(canvas_bucket=32))
    tonp = lambda v: jax.tree_util.tree_map(np.asarray, v)  # noqa: E731
    st = init_stitcher(0, StitchConfig(canvas_bucket=32), MH, MW, CHUNK,
                       compute_dtype=torch.float32, device="cpu")
    sds = from_jax_params(tonp(js.spatial_vars), tonp(js.temporal_vars),
                          tonp(js.smooth_vars))
    for net, sd in zip((st.spatial_net, st.temporal_net, st.smooth_net), sds):
        net.load_state_dict(sd, strict=True)
    return js, st


def clip_of(T, seed=5):
    return make_two_view_clip(num_frames=T, height=MH, width=MW, overlap=0.6,
                              shake_px=2.0, seed=seed)


def assert_close(got, want, rtol):
    assert set(got) == set(want) == KEYS
    for k in KEYS:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=k)


class TestHarness:
    @pytest.mark.parametrize("T", [10, 13])
    @pytest.mark.parametrize("upload,rtol", [("bgr", 1e-4), ("i420", 2e-3)])
    def test_evaluate_video_matches_jax(self, stitchers, upload, rtol, T):
        """The port's default, the one program per 16-frame bucket
        (``_fused_eval``), against the JAX package's at two lengths of the
        bucket."""
        js, st = stitchers
        assert st.fused_motion
        v1, v2 = clip_of(T)
        assert_close(harness.evaluate_video(st, v1, v2, upload=upload),
                     j_harness.evaluate_video(js, v1, v2, upload=upload),
                     rtol)

    @pytest.mark.parametrize("T", [10, 13])
    def test_program_matches_eager_motion(self, stitchers, T):
        """The program at the bucket's length against ``--eager_motion``'s
        eager path at the true T, within the JAX test's bound for its
        program against its eager path."""
        import dataclasses

        _, st = stitchers
        v1, v2 = clip_of(T, seed=6)
        eager = dataclasses.replace(st, fused_motion=False)
        assert_close(harness.evaluate_video(st, v1, v2),
                     harness.evaluate_video(eager, v1, v2), 1e-4)

    def test_one_graph_key_per_bucket(self, stitchers, monkeypatch):
        """T = 10 and T = 13 reach the stitcher's ``GraphCache.run`` under
        one key, with the true count as a 0-dim int32 tensor; T = 17 under
        the next bucket's. Each video makes that one call."""
        _, st = stitchers
        calls = []
        run = st.graphs.run

        def spy(name, fn, *inputs, modules=()):
            calls.append((st.graphs.key(name, inputs, modules),
                          inputs[-1].clone()))
            return run(name, fn, *inputs, modules=modules)

        monkeypatch.setattr(st.graphs, "run", spy)
        for T in (10, 13, 17):
            harness.evaluate_video(st, *clip_of(T))
        keys = [k for k, _ in calls]
        assert len(keys) == 3 and keys[0] == keys[1] != keys[2]
        assert [k[0] for k in keys] == ["metric"] * 3
        assert [k[2][0][0][0] for k in keys] == [16, 16, 32]
        assert [(int(n), n.dtype, n.dim()) for _, n in calls] == [
            (T, torch.int32, 0) for T in (10, 13, 17)]

    def test_float_input_and_bad_upload(self, stitchers):
        _, st = stitchers
        v1, v2 = make_two_view_clip(num_frames=8, height=MH, width=MW,
                                    overlap=0.6, shake_px=2.0, seed=8)
        got_u8 = harness.evaluate_video(st, v1, v2)
        got_f = harness.evaluate_video(st, v1.astype(np.float32) / 127.5 - 1,
                                       v2.astype(np.float32) / 127.5 - 1)
        for k in KEYS:
            np.testing.assert_allclose(got_u8[k], got_f[k], rtol=1e-5,
                                       err_msg=k)
        with pytest.raises(ValueError, match="upload"):
            harness.evaluate_video(st, v1, v2, upload="I420")

    def test_evaluate_dataset_categories(self, stitchers, tmp_path):
        """Videos named after SSD categories land in them; a category
        without videos is None; each video's scores are evaluate_video's
        on the loaded model-size frames."""
        _, st = stitchers
        for seed, name in enumerate(("S13", "0000021", "other")):
            write_clip_dirs(str(tmp_path), num_frames=7, height=MH, width=MW,
                            seed=seed, video_name=name)
        report = harness.evaluate_dataset(st, str(tmp_path))
        assert set(report) == {"per_video", "average", "RE", "LL", "LT", "MF"}
        assert sorted(report["per_video"]) == ["0000021", "S13", "other"]
        assert report["LL"] is None and report["MF"] is None
        assert report["RE"] == report["per_video"]["S13"]
        assert report["LT"] == report["per_video"]["0000021"]
        for k in KEYS:
            np.testing.assert_allclose(
                report["average"][k],
                np.mean([r[k] for r in report["per_video"].values()]))
        _, lo1, _, lo2 = load_video_pair(str(tmp_path / "S13"), (MH, MW),
                                         want_hi=False, normalize=False)
        assert lo1.dtype == np.uint8
        assert report["per_video"]["S13"] == harness.evaluate_video(st, lo1,
                                                                    lo2)
        assert len(harness.evaluate_dataset(st, str(tmp_path),
                                            max_videos=1)["per_video"]) == 1

    def test_cli_metric_writes_out_json(self, tmp_path):
        write_clip_dirs(str(tmp_path / "data"), num_frames=7, height=MH,
                        width=MW, seed=3)
        out = tmp_path / "report.json"
        assert cli.main(["metric", "--test_path", str(tmp_path / "data"),
                         "--max_videos", "1", "--chunk", "4", "--out_json",
                         str(out), "--device", "cpu"]) == 0
        with open(out) as f:
            report = json.load(f)
        assert set(report["average"]) == KEYS
        assert np.isfinite(list(report["average"].values())).all()
        assert list(report["per_video"]) == ["clip0"]
        assert os.path.getsize(out) > 100
