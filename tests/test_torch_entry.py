"""The port's ``cli stitch`` entry path against the JAX package, on the CPU.

Covers what ``cli stitch`` runs at its defaults beyond the stitch slice of
``tests/test_torch_stitch.py``: the packed-I420 upload, the bfloat16
trunks, ``stitch_begin``/``stitch_finish`` with the two-deep loop and its
loader thread, the reference ``.pth`` triad, ``--preset`` and
``--trace_dir``. Tolerances:

- I420 unpack: float within 1e-4 of JAX; uint8 equal except where JAX's
  float lies within 1e-4 of a rounding boundary (.5).
- bfloat16 trunks on the reference weights: motions within 0.1 px of the
  goldens (``tests/test_models.py::TestBF16Backbone``'s bound) and of the
  JAX package's bfloat16 motions.
- bfloat16 against float32 smooth meshes on the seed-0 random model at
  full width: within twice the gap the JAX package shows on the same clip
  (:data:`JAX_BF16_GAP_PX`); ``chip_smoke.py`` gates the card with the
  same bound.
- The pipelined loop against ``stitch_arrays``: bit for bit. The I420
  upload against JAX's ``stitch_arrays`` on the same input: the float32
  parity bound of ``tests/test_torch_stitch.py``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stabstitch2_tpu.config import StitchConfig as JStitchConfig
from stabstitch2_tpu.data.video_io import bgr_to_i420 as j_bgr_to_i420
from stabstitch2_tpu.models.spatial import SpatialNet as JSpatialNet
from stabstitch2_tpu.models.spatial import spatial_motions as j_spatial_motions
from stabstitch2_tpu.models.temporal import TemporalNet as JTemporalNet
from stabstitch2_tpu.models.temporal import clip_motions as j_clip_motions
from stabstitch2_tpu.ops import yuv as j_yuv
from stabstitch2_tpu.pipeline.stitcher import init_stitcher as j_init_stitcher
from stabstitch2_tpu.utils import torch_import as ti
from stabstitch2_tpu_torch import cli
from stabstitch2_tpu_torch.config import StitchConfig, preset_fusion_mode
from stabstitch2_tpu_torch.data.video_io import bgr_to_i420
from stabstitch2_tpu_torch.models import SpatialNet, TemporalNet
from stabstitch2_tpu_torch.models.spatial import spatial_motions
from stabstitch2_tpu_torch.ops.yuv import i420_to_bgr, unpack_i420_u8
from stabstitch2_tpu_torch.pipeline.stitcher import init_stitcher
from stabstitch2_tpu_torch.utils.checkpoint import (TRIAD,
                                                    stitcher_from_checkpoint)
from stabstitch2_tpu_torch.utils.profiling import PhaseTimer, trace
from stabstitch2_tpu_torch.utils.weights import from_jax_params

from synthetic import make_two_view_clip, write_clip_dirs

MH, MW, CHUNK, BUCKET = 128, 160, 4, 32
# max |bf16 - f32| smooth mesh of the JAX package's seed-0 random stitcher
# at 360x480 on the clip of `test_bf16_meshes_within_twice_the_jax_gap`,
# measured on the CPU: 0.0702 px. The port's gap there was 0.0531 px.
JAX_BF16_GAP_PX = 0.0702
BF16_MESH_BOUND_PX = 2 * JAX_BF16_GAP_PX      # chip_smoke.py: the same


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads for this module: tier-1 shares the cores among
    its workers, and PyTorch's CPU ops on these small tensors slow down
    ~50x when eight threads per process contend for them (an 8-frame
    128x160 stitch took 34 s with 8 threads and 0.6 s with 1-2, on 8
    cores with 7 kept busy)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def assert_frames_close(got, ref):
    """tests/test_torch_stitch.py's float32 parity bound for uint8 frames."""
    assert got.shape == ref.shape, (got.shape, ref.shape)
    d = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    assert (d > 0).mean() <= 1e-2, (d > 0).mean()
    assert (d > 1).mean() <= 1e-4, ((d > 1).mean(), d.max())


def unpack_sd(golden, drop=()):
    return {k[len("sd::"):]: torch.from_numpy(np.array(golden[k]))
            for k in golden.files if k.startswith("sd::")
            and not any(k.startswith("sd::" + d) for d in drop)}


def nhwc(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 2, 3, 1))))


class TestI420Upload:
    @pytest.mark.parametrize("H", [350, 360])
    def test_unpack_matches_jax(self, H):
        """H = 350: the U plane ends mid-row, so a split by rows would
        misalign U and V (the JAX docstring's warning)."""
        rng = np.random.default_rng(H)
        packed = rng.integers(0, 256, (3, H * 3 // 2, 480), np.uint8)
        ref = np.asarray(j_yuv.i420_to_bgr(jnp.asarray(packed)))
        got = i420_to_bgr(torch.from_numpy(packed)).numpy()
        assert got.shape == (3, H, 480, 3)
        np.testing.assert_allclose(got, ref, atol=1e-4)
        ref_u8 = np.asarray(j_yuv.unpack_i420_u8(jnp.asarray(packed)))
        got_u8 = unpack_i420_u8(torch.from_numpy(packed)).numpy()
        near_half = np.abs(ref - np.floor(ref) - 0.5) <= 1e-4
        assert ((got_u8 == ref_u8) | near_half).all()

    def test_bgr_to_i420_matches_jax(self):
        frames = make_two_view_clip(2, 350, 480, seed=3)[0]
        np.testing.assert_array_equal(bgr_to_i420(frames),
                                      j_bgr_to_i420(frames))
        with pytest.raises(ValueError, match="even"):
            bgr_to_i420(frames[:, :349])


@pytest.fixture(scope="module")
def bf16_motions(goldens):
    """Spatial and temporal motions of the bf16 trunks on the reference
    weights, from the port and from the JAX package."""
    out = {}
    g = goldens("spatialnet_parity")
    sd = unpack_sd(g)
    net = SpatialNet(compute_dtype=torch.bfloat16)
    net.load_state_dict(sd, strict=True)
    with torch.no_grad():
        m = spatial_motions(*net.eval()(nhwc(g["img1"]), nhwc(g["img2"])),
                            360, 480)
    params, stats = ti.convert_state_dict({k: v.numpy() for k, v in sd.items()},
                                          ti.spatial_mapping())
    jm = j_spatial_motions(*JSpatialNet(dtype=jnp.bfloat16).apply(
        {"params": params, "batch_stats": stats},
        jnp.asarray(nhwc(g["img1"]).numpy()),
        jnp.asarray(nhwc(g["img2"]).numpy()), False), 360, 480)
    out["spatial"] = (np.stack([m["motion1"].numpy(), m["motion2"].numpy()]),
                      np.stack([g["motion1"], g["motion2"]]),
                      np.stack([np.asarray(jm["motion1"]),
                                np.asarray(jm["motion2"])]))

    g = goldens("temporalnet_parity")
    sd = unpack_sd(g, drop=("feature_extractor_stage2.",))
    net = TemporalNet(compute_dtype=torch.bfloat16)
    net.load_state_dict(sd, strict=True)
    frames = nhwc(g["frames"][:, 0])
    with torch.no_grad():
        f = net.eval().features(frames)
        m = net.motion_from_features(f[:-1], f[1:])
    got = torch.cat([torch.zeros_like(m[:1]), m], 0).numpy()
    params, stats = ti.convert_state_dict(
        {k: v.numpy() for k, v in unpack_sd(g).items()}, ti.temporal_mapping())
    jm = j_clip_motions(JTemporalNet(dtype=jnp.bfloat16),
                        {"params": params, "batch_stats": stats},
                        jnp.asarray(frames.numpy()))
    out["temporal"] = (got, g["motions"][:, 0], np.asarray(jm))
    return out


class TestBF16Trunks:
    @pytest.mark.parametrize("net", ["spatial", "temporal"])
    @pytest.mark.parametrize("ref", ["golden", "jax_bf16"])
    def test_motions_within_a_tenth_pixel(self, bf16_motions, net, ref):
        got, golden, jax_bf16 = bf16_motions[net]
        want = golden if ref == "golden" else jax_bf16
        assert np.abs(got - want).max() < 0.1

    def test_smoothnet_dtype_matches_jax(self, goldens):
        """init_stitcher's smooth_dtype: SmoothNet computing in bfloat16
        against the JAX package's SmoothNet(dtype=bfloat16) on the
        reference weights: within 4 bfloat16 ulps (2e-3) of deltas ~0.1."""
        from stabstitch2_tpu.models.smooth import SmoothNet as JSmoothNet
        from stabstitch2_tpu_torch.models import SmoothNet

        g = goldens("smooth_parity")
        sd = unpack_sd(g)
        args = [np.array(g[k]) for k in ("smesh1", "smesh2", "tsmotion1",
                                         "tsmotion2")]
        params, _ = ti.convert_state_dict({k: v.numpy() for k, v in sd.items()},
                                          ti.smooth_mapping())
        net = SmoothNet(torch.bfloat16)
        net.load_state_dict(unpack_sd(g, drop=("MotionPre.embedding2.",)))
        with torch.no_grad():
            got = net.eval()(*map(torch.from_numpy, args))[4:]
        want = JSmoothNet(dtype=jnp.bfloat16).apply(
            {"params": params}, *map(jnp.asarray, args))[4:]
        for a, b in zip(got, want):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-3)

    def test_features_stay_bf16_and_reach_k1_as_float32(self, monkeypatch):
        from stabstitch2_tpu_torch.models import spatial, temporal

        seen = []

        def record(x1, x2, r):
            seen.append((x1.dtype, x2.dtype, r))
            return torch.zeros(*x1.shape[:3], (2 * r + 1) ** 2)

        for mod in (spatial, temporal):
            monkeypatch.setattr(mod, "cost_volume_cuda", record)
        x = torch.zeros(1, MH, MW, 3)
        sn = SpatialNet(MH, MW, compute_dtype=torch.bfloat16).eval()
        tn = TemporalNet(MH, MW, compute_dtype=torch.bfloat16).eval()
        with torch.no_grad():
            outs = sn(x, x)
            f = tn.features(x)
            tm = tn.motion_from_features(f, f)
        assert f.dtype == torch.bfloat16
        assert all(o.dtype == torch.float32 for o in (*outs, tm))
        assert seen == [(torch.float32, torch.float32, 5)] * 2 + [
            (torch.float32, torch.float32, 3)]
        assert all(p.dtype == torch.float32 for p in sn.state_dict().values()
                   if p.is_floating_point())

    def test_bf16_meshes_within_twice_the_jax_gap(self):
        """Seed-0 random models at full width, 8 frames: the port's bf16
        against its float32 smooth meshes, beside the JAX package's."""
        v1, v2 = make_two_view_clip(8, 360, 480, overlap=0.6, shake_px=2.0,
                                    seed=5)

        def gap(a, b):
            return max(float(np.abs(np.asarray(getattr(a, k))
                                    - np.asarray(getattr(b, k))).max())
                       for k in ("smooth_mesh1", "smooth_mesh2"))

        jax_runs = [j_init_stitcher(rng_seed=0, chunk=CHUNK, compute_dtype=dt,
                                    config=JStitchConfig(canvas_bucket=BUCKET))
                    .stitch_arrays(v1, None, v2, None)
                    for dt in (jnp.float32, None)]
        runs = [init_stitcher(0, StitchConfig(canvas_bucket=BUCKET),
                              chunk=CHUNK, compute_dtype=dt, device="cpu")
                .stitch_arrays(v1, None, v2, None)
                for dt in (torch.float32, None)]
        jax_gap, port_gap = gap(*jax_runs), gap(*runs)
        assert 0 < jax_gap <= BF16_MESH_BOUND_PX, jax_gap
        assert 0 < port_gap <= BF16_MESH_BOUND_PX, (port_gap, jax_gap)


@pytest.fixture(scope="module")
def small():
    """A float32 JAX stitcher at 128x160 and the port carrying its weights,
    and a port stitcher at the CLI's defaults (bf16 trunks, yuv420)."""
    js = j_init_stitcher(rng_seed=0, model_h=MH, model_w=MW, chunk=CHUNK,
                         compute_dtype=jnp.float32,
                         config=JStitchConfig(canvas_bucket=BUCKET))
    tonp = lambda v: jax.tree_util.tree_map(np.asarray, v)  # noqa: E731
    st = init_stitcher(0, StitchConfig(canvas_bucket=BUCKET), MH, MW, CHUNK,
                       compute_dtype=torch.float32, device="cpu")
    sds = from_jax_params(tonp(js.spatial_vars), tonp(js.temporal_vars),
                          tonp(js.smooth_vars))
    for net, sd in zip((st.spatial_net, st.temporal_net, st.smooth_net), sds):
        net.load_state_dict(sd, strict=True)
    bf16 = init_stitcher(0, StitchConfig(canvas_bucket=BUCKET,
                                         download_format="yuv420"),
                         MH, MW, CHUNK, device="cpu")
    return js, st, bf16


class TestPipeline:
    def test_i420_upload_matches_jax(self, small):
        js, st, _ = small
        v1, v2 = make_two_view_clip(8, MH, MW, overlap=0.6, shake_px=2.0,
                                    seed=5)
        p1, p2 = bgr_to_i420(v1), bgr_to_i420(v2)
        ref = js.stitch_arrays(p1, None, p2, None)
        got = st.stitch_arrays(p1, None, p2, None)
        for k in ("smooth_mesh1", "smooth_mesh2"):
            np.testing.assert_allclose(getattr(got, k).numpy(),
                                       np.asarray(getattr(ref, k)), atol=1e-3)
        assert got.frames.max() > 10
        assert_frames_close(got.frames, np.asarray(ref.frames))

    @pytest.mark.parametrize("sync_phases", [True, False])
    def test_two_deep_loop_equals_stitch_arrays(self, small, tmp_path,
                                                monkeypatch, sync_phases):
        """Three videos and a too-short one through the loader thread and
        the two-deep loop: each video's frames equal stitch_arrays', and
        the short one is skipped and counted."""
        _, _, st = small
        monkeypatch.setattr(st, "sync_phases", sync_phases)
        for seed in range(3):
            write_clip_dirs(str(tmp_path), num_frames=8, height=MH, width=MW,
                            seed=seed, video_name=f"clip{seed}")
        write_clip_dirs(str(tmp_path), num_frames=6, height=MH, width=MW,
                        seed=9, video_name="short")
        videos = sorted(str(p) for p in tmp_path.iterdir())
        got = {}
        done, failed = cli.stitch_stream(
            st, cli.threaded(cli.load_videos(videos)),
            lambda name, result: got.setdefault(name, result))
        assert (done, failed) == (3, 1) and sorted(got) == [
            "clip0", "clip1", "clip2"]
        for vd, arrays, err in cli.load_videos(videos[:3]):
            assert err is None and arrays[0].ndim == 3      # packed I420
            ref = st.stitch_arrays(*arrays)
            res = got[os.path.basename(vd)]
            assert res.frame_format == "i420" and res.frames.max() > 10
            np.testing.assert_array_equal(res.frames, ref.frames)
            assert list(res.ms) == ["upload", "spatial", "temporal", "smooth",
                                    "warp_fuse", "download"]

    def test_odd_frames_fall_back_to_bgr(self, tmp_path):
        write_clip_dirs(str(tmp_path), num_frames=7, height=95, width=120,
                        seed=1)
        [(_, arrays, err)] = list(cli.load_videos([str(tmp_path / "clip0")]))
        assert err is None and arrays[0].shape == (7, 95, 120, 3)
        [(_, arrays, _)] = list(cli.load_videos([str(tmp_path / "clip0")],
                                                "bgr"))
        assert arrays[0].shape == (7, 95, 120, 3)


class TestCheckpointAndFlags:
    def test_reference_triad_loads(self, goldens, tmp_path):
        sds = {"spatial_warp.pth": unpack_sd(goldens("spatialnet_parity")),
               "temporal_warp.pth": unpack_sd(goldens("temporalnet_parity")),
               "smooth_warp.pth": unpack_sd(goldens("smooth_parity"))}
        for name, sd in sds.items():
            torch.save({"model": sd}, tmp_path / name)
        st = stitcher_from_checkpoint(reference_pth_dir=str(tmp_path),
                                      device="cpu")
        nets = (st.spatial_net, st.temporal_net, st.smooth_net)
        unused = ("feature_extractor_stage2.", "MotionPre.embedding2.")
        for net, name in zip(nets, TRIAD):
            have = net.state_dict()
            want = {k: v for k, v in sds[name].items()
                    if name == "spatial_warp.pth"
                    or not k.startswith(unused)}
            assert sorted(have) == sorted(want)
            for k, v in want.items():
                assert torch.equal(have[k], v), (name, k)
        os.remove(tmp_path / "temporal_warp.pth")
        with pytest.raises(FileNotFoundError, match="temporal_warp.pth"):
            stitcher_from_checkpoint(reference_pth_dir=str(tmp_path),
                                     device="cpu")

    @pytest.mark.parametrize("flags,fusion", [([], "AVERAGE"),
                                              (["--preset", "tra"], "LINEAR"),
                                              (["--preset", "tra",
                                                "--fusion_mode", "AVERAGE"],
                                               "AVERAGE")])
    def test_preset(self, flags, fusion):
        args = cli.make_parser().parse_args(
            ["stitch", "--test_path", ".", "--output_path", ".",
             "--device", "cpu", *flags])
        assert preset_fusion_mode(args.preset, args.fusion_mode) == fusion
        st = cli.build_stitcher(args)
        assert st.config.fusion_mode == fusion
        assert st.config.download_format == "yuv420" and st.sync_phases
        assert (st.spatial_net.feature_extractor_stage1.compute_dtype
                == torch.bfloat16)
        assert st.smooth_net.MotionPre.compute_dtype == torch.float32

    def test_trace_writes_chrome_json(self, tmp_path):
        timer = PhaseTimer(4, torch.device("cpu"))
        with trace(str(tmp_path)):
            torch.ones(64, 64) @ torch.ones(64, 64)
            timer.mark("upload")
        [path] = list(tmp_path.iterdir())
        assert path.suffix == ".json"
        assert "traceEvents" in json.loads(path.read_text())
        assert list(timer.ms) == ["upload"] and timer.fps["upload"] > 0
