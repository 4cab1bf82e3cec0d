"""The port's online (streaming) stitcher against the JAX package's, on the CPU.

A float32 JAX stitcher at 128x160 and the port carrying its weights
(``utils/weights.py:from_jax_params``) stream the same ``tests/synthetic.py``
clips pair by pair. JAX runs its XLA composite route
(``pallas_fused=False, pallas_gather=False``), the function of the port's
gather route B (``fused_warp=False``: K3 and K4, their plain versions on
the CPU), as tests/test_torch_routes.py pairs them; the port's default
route A (K2) is held equal to its route B bit for bit. (The Pallas fused
warp in interpret mode would add ~20 s of compiles per canvas here.)

Tolerances:
- ``window_smooth``: 1e-3 px against JAX (tests/test_torch_stitch.py's
  mesh bound);
- emitted frames: ``assert_frames_close`` (<= 1% of values differ at all,
  <= 1e-4 by more than one level: view-border pixels flip where the two
  sides' float32 TPS solves differ);
- online against the port's own batch ``stitch_arrays``: rtol 1e-3,
  atol 5e-3 px, the bound of the JAX package's tests/test_online_mode.py.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stabstitch2_tpu.config import StitchConfig as JStitchConfig
from stabstitch2_tpu.data.video_io import bgr_to_i420 as j_bgr_to_i420
from stabstitch2_tpu.pipeline.online import OnlineStitcher as JOnline
from stabstitch2_tpu.pipeline.stitcher import init_stitcher as j_init_stitcher
from stabstitch2_tpu_torch.config import StitchConfig
from stabstitch2_tpu_torch.data.video_io import bgr_to_i420, pack_i420_host
from stabstitch2_tpu_torch.ops.yuv import bgr_u8_to_yuv420
from stabstitch2_tpu_torch.pipeline.online import OnlineStitcher
from stabstitch2_tpu_torch.pipeline.stitcher import init_stitcher
from stabstitch2_tpu_torch.utils.weights import from_jax_params

from synthetic import make_two_view_clip
from test_torch_stitch import assert_frames_close

MH, MW, CHUNK, BUCKET = 128, 160, 4, 32
T = 10
COUNTS = [0] * 6 + [7] + [1] * (T - 7)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads (tests/test_torch_entry.py: tier-1's workers
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def stitchers():
    """One JAX stitcher's online stitcher (reset between streams: each
    JAX OnlineStitcher compiles its own step), and the port's stitcher
    with the same weights on route A (its default) and on route B."""
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
    return JOnline(js), st, st_b


def stream(online, v1, v2):
    """Push a clip; (per-push counts, emitted frames)."""
    counts, frames = [], []
    for a, b in zip(v1, v2):
        out = online.push(a, b)
        counts.append(len(out))
        frames += [np.asarray(f) for f in out]
    return counts, frames


def run_jax(jo, v1, v2, emit_format="bgr"):
    jo.reset()
    jo.emit_format = emit_format
    return stream(jo, v1, v2)


def clip(seed, shake=2.0):
    return make_two_view_clip(num_frames=T, height=MH, width=MW, overlap=0.6,
                              shake_px=shake, seed=seed)


@pytest.fixture(scope="module")
def bgr_run(stitchers):
    jo, st, st_b = stitchers
    v1, v2 = clip(21)
    o = OnlineStitcher(st_b)
    return dict(v1=v1, v2=v2, o=o, port=stream(o, v1, v2),
                route_a=stream(OnlineStitcher(st), v1, v2),
                jax=run_jax(jo, v1, v2),
                jsmooth=[np.asarray(m) for m in jo.window_smooth],
                jcanvas=jo.canvas)


def same_canvas(a, b):
    assert (a.out_h, a.out_w, a.pad_h, a.pad_w) == (b.out_h, b.out_w,
                                                    b.pad_h, b.pad_w)
    np.testing.assert_allclose([a.x_min, a.y_min], [b.x_min, b.y_min],
                               atol=1e-2)


class TestOnlineAgainstJax:
    def test_counts_and_frames(self, bgr_run):
        (counts, frames), (jcounts, jframes) = bgr_run["port"], bgr_run["jax"]
        assert counts == jcounts == COUNTS
        same_canvas(bgr_run["o"].canvas, bgr_run["jcanvas"])
        assert {f.shape for f in frames} == {frames[0].shape}
        assert all(f.dtype == np.uint8 for f in frames)
        assert np.stack(frames).max() > 10
        assert_frames_close(np.stack(frames), np.stack(jframes))

    def test_route_a_equals_route_b(self, bgr_run):
        counts, frames = bgr_run["route_a"]
        assert counts == COUNTS
        np.testing.assert_array_equal(np.stack(frames),
                                      np.stack(bgr_run["port"][1]))

    def test_window_smooth_matches_jax(self, bgr_run):
        for got, want in zip(bgr_run["o"].window_smooth, bgr_run["jsmooth"]):
            np.testing.assert_allclose(got.numpy(), want, atol=1e-3)

    def test_matches_the_ports_batch(self, stitchers):
        """The last window's smooth mesh against ``stitch_arrays``' last
        frame (tests/test_online_mode.py's bound)."""
        st = stitchers[1]
        v1, v2 = make_two_view_clip(num_frames=9, height=MH, width=MW,
                                    overlap=0.6, shake_px=2.0, seed=22)
        batch = st.stitch_arrays(v1, None, v2, None)
        o = OnlineStitcher(st)
        stream(o, v1, v2)
        for got, want in zip(o.window_smooth, (batch.smooth_mesh1,
                                               batch.smooth_mesh2)):
            np.testing.assert_allclose(got[-1].numpy(), want[-1].numpy(),
                                       rtol=1e-3, atol=5e-3)

    def test_i420_emission(self, stitchers, bgr_run):
        """Packed 4:2:0 frames described by the canvas. Route A converts
        the float fusion, as JAX's unchained route does (against it);
        route B chains the conversion on its uint8 BGR composite (exact
        against the conversion of a bgr stream on the same canvas)."""
        jo, st, st_b = stitchers
        v1, v2 = bgr_run["v1"], bgr_run["v2"]
        o = OnlineStitcher(st, emit_format="i420")
        counts, frames = stream(o, v1, v2)
        jcounts, jframes = run_jax(jo, v1, v2, emit_format="i420")
        assert counts == jcounts == COUNTS
        c = o.canvas
        assert c.out_h % 2 == 0 and c.out_w % 2 == 0
        assert frames[-1].shape == (c.out_h * 3 // 2, c.out_w)
        same_canvas(c, jo.canvas)
        assert_frames_close(np.stack(frames), np.stack(jframes))
        o_i420 = OnlineStitcher(st_b, emit_format="i420")
        _, yuv = stream(o_i420, v1, v2)
        o_bgr = OnlineStitcher(st_b)
        o_bgr._set_canvas(o_i420.canvas)
        _, bgr = stream(o_bgr, v1, v2)
        want = pack_i420_host(*(p.numpy() for p in bgr_u8_to_yuv420(
            torch.from_numpy(np.stack(bgr)))))
        np.testing.assert_array_equal(np.stack(yuv), want)

    def test_i420_input(self, stitchers):
        """Packed I420 pushes, unpacked on the device, against JAX's."""
        jo, _, st_b = stitchers
        v1, v2 = clip(29)
        p1, p2 = bgr_to_i420(v1), bgr_to_i420(v2)
        np.testing.assert_array_equal(p1, j_bgr_to_i420(v1))
        o = OnlineStitcher(st_b)
        counts, frames = stream(o, p1, p2)
        jcounts, jframes = run_jax(jo, p1, p2)
        assert counts == jcounts == COUNTS
        assert_frames_close(np.stack(frames), np.stack(jframes))
        for got, want in zip(o.window_smooth, jo.window_smooth):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-3)

    def test_rejects_frames_that_are_neither(self, stitchers):
        o = OnlineStitcher(stitchers[1])
        gray = np.zeros((MH, MW), np.uint8)       # H is not a multiple of 3
        with pytest.raises(ValueError, match="not packed I420"):
            o.push(gray, gray)
        four = np.zeros((MH, MW, 4), np.uint8)
        with pytest.raises(ValueError, match="expected"):
            o.push(four, four)
        with pytest.raises(ValueError, match="emit_format"):
            OnlineStitcher(stitchers[1], emit_format="nv12")


def lattice(dx=0.0, dy=0.0, scale=1.0):
    xs = np.linspace(0, MW, 9) * scale + dx
    ys = np.linspace(0, MH, 7) * scale + dy
    return np.stack(np.meshgrid(xs, ys), -1).astype(np.float32)


def extent(*meshes):
    m = np.stack(meshes)
    return np.array([m[..., 0].min(), m[..., 0].max(), m[..., 1].min(),
                     m[..., 1].max()], np.float32)


class TestCanvasReanchor:
    """Content leaving the causal canvas re-anchors it, as in JAX
    (tests/test_online_mode.py::TestCanvasReanchor)."""

    @pytest.mark.parametrize("case", ["pan", "growth"])
    def test_reanchor_matches_jax(self, stitchers, case):
        jo, _, st_b = stitchers
        jo.reset()
        jo.emit_format = "bgr"
        o = OnlineStitcher(st_b)
        a, b = lattice(), lattice(dx=30)
        o._establish_canvas(extent(a, b))
        jo._establish_canvas(jnp.asarray(a[None]), jnp.asarray(b[None]),
                             MH, MW)
        c0 = o.canvas
        same_canvas(c0, jo.canvas)
        m1, m2 = ((lattice(dx=500), lattice(dx=530)) if case == "pan" else
                  (lattice(scale=2.5), lattice(scale=2.5, dx=40)))
        img = np.zeros((MH, MW, 3), np.uint8)
        out = o._composite_many(*(torch.from_numpy(x[None])
                                  for x in (img, img, m1, m2)))[0]
        jout = jo._composite_one(img, img, jnp.asarray(m1), jnp.asarray(m2))
        assert o.reanchor_frames == jo.reanchor_frames == [0]
        same_canvas(o.canvas, jo.canvas)
        assert out.shape == np.asarray(jout).shape
        if case == "pan":   # the anchor moves, the size stays
            assert (o.canvas.pad_h, o.canvas.pad_w, o.canvas.out_h,
                    o.canvas.out_w) == (c0.pad_h, c0.pad_w, c0.out_h,
                                        c0.out_w)
            assert o.canvas.x_min > c0.x_min + 300
        else:               # the content outgrew the canvas
            assert o.canvas.out_w > c0.out_w

    def test_streaming_survives_drift(self, stitchers):
        """Margin 1.0: jitter past the first window's extent re-anchors
        mid-stream, and every frame is still emitted."""
        st = stitchers[1]
        v1, v2 = clip(31, shake=4.0)
        o = OnlineStitcher(st, canvas_margin=1.0)
        counts, frames = stream(o, v1, v2)
        assert counts == COUNTS
        assert o.reanchor_frames
        assert all(f.ndim == 3 and f.dtype == np.uint8 for f in frames)
        assert max(f.max() for f in frames) > 10
