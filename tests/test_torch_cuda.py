"""The port's hand-written CUDA kernels against their plain versions.

Every test here needs an NVIDIA card: it is marked ``cuda`` and skips
where ``torch.cuda.is_available()`` is false. The file imports neither JAX
nor the JAX package, so it also runs on a machine without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

Tolerances: K1 1e-5 (the kernel sums the channels in another order);
K2, K3 and K4 exact, since kernel and plain version do the same float32
operations in the same order (and K2 and K3 evaluate the spline through
the same device routine, so K3 + K4 give K2's planes exactly). K3's
``TpsCoords`` gradients equal autograd through its plain version exactly;
a spatial training step on the card is held against the CPU at 1e-4
(loss) and 1e-2 (each gradient, relative L2). Two replicas of the
stitcher on one card equal one bit for bit; each kernel's wrapper runs
on the last card where there are two or more (skipped on one). The fused
motion's CUDA graphs (``utils/graphs.py``) replay the eager functions bit
for bit on 48-frame clips (a multiple of the chunk and of the 16-frame
bucket), count the launches the eager path makes, leave a begun video's
meshes alone, are made anew by ``replicate()``, and raise on a capture
that waits for the card. The metric harness's one program per
16-frame bucket replays once per video for every length of the bucket
and equals itself called uncaptured bit for bit, and two replicas'
composed programs equal it. The trainers' captured steps equal their eager
steps over four steps across an epoch boundary (bit for bit where two
eager runs are, else within twice their gap), with one capture and three
replays per loop, and two planted faults (a stale batch, a rate baked in
at capture) fail that gate.
"""

import collections
import itertools
import warnings

import numpy as np
import pytest
import torch

from stabstitch2_tpu_torch.config import StitchConfig
from stabstitch2_tpu_torch.ops import (corr_cuda, fused_warp_cuda,
                                       patch_gather_cuda, tps_coords_cuda)
from stabstitch2_tpu_torch.ops.mesh import mesh_points, normalize_mesh, rigid_mesh
from stabstitch2_tpu_torch.ops.tps import tps_params
from stabstitch2_tpu_torch.pipeline.stitcher import init_stitcher

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    """The card, with TF32 off so float32 means float32; skip without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cv_inputs(shape, device, seed=7):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))
                 .to(device) for _ in range(2))


@pytest.mark.parametrize("shape,r", [((2, 12, 16, 128), 3),
                                     ((1, 9, 10, 128), 5),
                                     ((2, 7, 9, 40), 2),
                                     ((8, 45, 60, 128), 5),
                                     ((16, 45, 60, 128), 3)])
def test_cost_volume_kernel(cuda_device, shape, r):
    x1, x2 = _cv_inputs(shape, cuda_device)
    n = corr_cuda.LAUNCHES[r]
    got = corr_cuda.cost_volume_cuda(x1, x2, r)
    torch.cuda.synchronize()
    assert corr_cuda.LAUNCHES[r] == n + 1
    ref = corr_cuda.cost_volume_plain(x1, x2, r)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape,r", [((2, 5, 61, 36), 0),
                                     ((2, 3, 40, 16), 1),
                                     ((1, 6, 130, 36), 3),
                                     ((1, 8, 30, 24), 4),
                                     ((2, 4, 3, 13), 5),
                                     ((1, 9, 67, 21), 5),
                                     ((1, 5, 17, 8), 6),
                                     ((1, 7, 33, 20), 7),
                                     ((3, 11, 64, 128), 3)],
                         ids=["H5-W61-C36-r0", "H3-W40-C16-r1",
                              "H6-W130-C36-r3", "H8-W30-C24-r4",
                              "H4-W3-C13-r5", "H9-W67-C21-r5",
                              "H5-W17-C8-r6", "H7-W33-C20-r7",
                              "H11-W64-C128-r3"])
def test_cost_volume_kernel_ragged(cuda_device, shape, r):
    """Shapes the tiling must cover: H not a multiple of a block's rows (2
    at r >= 4, 4 below), W not a multiple of the 32-column segment or of a
    thread's 4 columns, C not a multiple of the 16-channel chunk (and
    C % 4 != 0: no 16-byte loads), every instantiated r from 0 to 7."""
    x1, x2 = _cv_inputs(shape, cuda_device, seed=sum(shape) + r)
    got = corr_cuda.cost_volume_cuda(x1, x2, r)
    ref = corr_cuda.cost_volume_plain(x1, x2, r)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)


def test_cost_volume_kernel_unaligned_and_range(cuda_device):
    """Maps that start off a 16-byte boundary take the word loads; a
    search range past the instantiated ones raises."""
    shape = (2, 6, 20, 32)
    n = int(np.prod(shape))
    flat = torch.randn(2 * n, generator=torch.Generator().manual_seed(3))
    x1 = flat[:n].view(shape).to(cuda_device)
    buf = torch.empty(n + 1, device=cuda_device)
    buf[1:] = flat[n:2 * n].to(cuda_device)
    x2 = buf[1:].view(shape)
    assert x2.data_ptr() % 16 != 0 and x2.is_contiguous()
    got = corr_cuda.cost_volume_cuda(x1, x2, 2)
    ref = corr_cuda.cost_volume_plain(x1, x2, 2)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="search_range"):
        corr_cuda.cost_volume_cuda(x1, x2, corr_cuda.MAX_SEARCH_RANGE + 1)


def test_cost_volume_backward(cuda_device):
    x1, x2 = _cv_inputs((1, 8, 8, 128), cuda_device)
    a, b = x1.clone().requires_grad_(True), x2.clone().requires_grad_(True)
    torch.sin(corr_cuda.cost_volume_cuda(a, b, 3)).sum().backward()
    c, d = x1.clone().requires_grad_(True), x2.clone().requires_grad_(True)
    torch.sin(corr_cuda.cost_volume_plain(c, d, 3)).sum().backward()
    torch.testing.assert_close(a.grad, c.grad, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(b.grad, d.grad, atol=1e-5, rtol=1e-5)


def _warp_case(device, seed=0, mesh_shift=10.0, B=3, H=120, W=160,
               span=(140, 250)):
    rng = np.random.default_rng(seed)
    im = torch.from_numpy(rng.integers(0, 255, (B, H, W, 3)).astype(np.uint8))
    xs, ys = np.linspace(0.0, W, 9), np.linspace(0.0, H, 7)
    base = np.stack(np.meshgrid(xs, ys), -1)[None]
    mesh = torch.from_numpy((base + rng.normal(0, 2.0, (B, 7, 9, 2))
                             + mesh_shift).astype(np.float32))
    norm = mesh_points(normalize_mesh(mesh, *span))
    nrig = mesh_points(normalize_mesh(rigid_mesh(H, W), H, W))[None]
    T = tps_params(norm, nrig.expand(norm.shape).contiguous())
    return im.to(device), T.contiguous().to(device), norm.contiguous().to(device)


@pytest.mark.parametrize("shift,out_size", [(10.0, (144, 256)),
                                            (10.0, (97, 131)),
                                            (10.0, (203, 389)),
                                            (900.0, (144, 256))])
def test_fused_warp_kernel(cuda_device, shift, out_size):
    """Bit-equal to the plain version, on canvases that are and are not
    multiples of the kernel's 16 x 128 tile."""
    span = (140, 250)
    im, T, norm = _warp_case(cuda_device, mesh_shift=shift, span=span)
    n = fused_warp_cuda.LAUNCHES["fused_warp"]
    got = fused_warp_cuda.fused_warp_planes(im, T, norm, out_size,
                                            grid_span=span)
    torch.cuda.synchronize()
    assert fused_warp_cuda.LAUNCHES["fused_warp"] == n + 1
    ref = fused_warp_cuda.fused_warp_planes_plain(im, T, norm, out_size,
                                                  grid_span=span)
    for g, r in zip(got[:4], ref[:4]):
        torch.testing.assert_close(g, r, atol=0, rtol=0)
    assert not bool(got[4])
    if shift > 100:
        assert not bool(torch.stack(got[:3]).any())


def test_stitch_on_card_launches_both_kernels(cuda_device):
    from synthetic import make_two_view_clip

    v1, v2 = make_two_view_clip(num_frames=8, height=128, width=160,
                                overlap=0.6, shake_px=2.0, seed=5)
    st = init_stitcher(0, model_h=128, model_w=160, chunk=4, device=cuda_device)
    corr_cuda.LAUNCHES.clear()
    fused_warp_cuda.LAUNCHES.clear()
    res = st.stitch_arrays(v1, None, v2, None)
    assert corr_cuda.LAUNCHES[5] == 4 and corr_cuda.LAUNCHES[3] == 2
    assert fused_warp_cuda.LAUNCHES["fused_warp"] == 2
    assert res.frames.shape[0] == 8 and res.frames.max() > 10


@pytest.mark.parametrize("out_size,span,B", [((144, 256), (140, 250), 3),
                                             ((97, 131), (90, 120), 3),
                                             ((448, 608), (430, 600), 3),
                                             ((1, 3), None, 3),
                                             ((203, 389), (190, 370), 3),
                                             ((17, 129), None, 3),
                                             ((203, 389), (190, 370), 1)])
def test_tps_coords_kernel(cuda_device, out_size, span, B):
    """Bit-equal to the plain version, on canvases that are and are not
    multiples of the kernel's 16 x 128 tile, padded past the true extent
    (span) or not."""
    _, T, norm = _warp_case(cuda_device, B=B, span=span or out_size)
    n = tps_coords_cuda.LAUNCHES["tps_coords"]
    got = tps_coords_cuda.tps_coords(T, norm, out_size, grid_span=span)
    torch.cuda.synchronize()
    assert tps_coords_cuda.LAUNCHES["tps_coords"] == n + 1
    ref = tps_coords_cuda.tps_coords_plain(T, norm, out_size, grid_span=span)
    for g, r in zip(got, ref):
        assert g.shape == (B, out_size[0] * out_size[1])
        torch.testing.assert_close(g, r.expand_as(g), atol=0, rtol=0)


def test_k3_then_k4_equals_k2(cuda_device):
    """Route B at the kernel level: K3's coordinates sampled by K4 (planes)
    with the plain coverage mask give K2's B, G, R and mask planes bit for
    bit, on a random mesh over a canvas that is not a multiple of the
    tile."""
    from stabstitch2_tpu_torch.ops.interp import bilinear_mask

    out_size, span = (203, 389), (190, 370)
    im, T, norm = _warp_case(cuda_device, seed=11, mesh_shift=15.0,
                             span=span)
    H, W = im.shape[1:3]
    x, y = tps_coords_cuda.tps_coords(T, norm, out_size, grid_span=span)
    pb, pg, pr, _ = patch_gather_cuda.bilinear_sample_patch_u8_cuda(
        im, x, y, out_size, planes=True)
    mask = bilinear_mask(H, W, x, y).reshape(im.shape[0], *out_size)
    want = fused_warp_cuda.fused_warp_planes(im, T, norm, out_size,
                                             grid_span=span)
    assert bool(want[3].any()) and bool((want[3] < 0.5).any())
    for g, r in zip((pb, pg, pr, mask), want[:4]):
        torch.testing.assert_close(g, r, atol=0, rtol=0)


@pytest.mark.parametrize("planes", [False, True])
@pytest.mark.parametrize("shift,out_size", [(10.0, (144, 256)),
                                            (10.0, (97, 131)),
                                            (900.0, (64, 64))])
def test_patch_gather_kernel(cuda_device, planes, shift, out_size):
    span = (140, 250)
    im, T, norm = _warp_case(cuda_device, mesh_shift=shift, span=span)
    x, y = tps_coords_cuda.tps_coords_plain(T, norm, out_size, grid_span=span)
    x[:, ::97] = float("nan")     # NaN coordinates are dead: exact 0
    n = patch_gather_cuda.LAUNCHES["patch_gather"]
    got = patch_gather_cuda.bilinear_sample_patch_u8_cuda(im, x, y, out_size,
                                                          planes=planes)
    torch.cuda.synchronize()
    assert patch_gather_cuda.LAUNCHES["patch_gather"] == n + 1
    ref = patch_gather_cuda.patch_gather_plain(im, x, y, out_size, planes)
    for g, r in zip(got[:-1], ref[:-1]):
        torch.testing.assert_close(g, r, atol=0, rtol=0)
    assert not bool(got[-1])
    out = torch.stack(got[:3], -1) if planes else got[0]
    assert not bool(out.reshape(3, -1, 3)[:, ::97].any())
    if shift > 100:
        assert not bool(out.any())


def test_stitch_route_b_launches_k3_and_k4_not_k2(cuda_device):
    from synthetic import make_two_view_clip

    v1, v2 = make_two_view_clip(num_frames=8, height=128, width=160,
                                overlap=0.6, shake_px=2.0, seed=5)
    st = init_stitcher(0, StitchConfig(fused_warp=False), model_h=128,
                       model_w=160, chunk=4, device=cuda_device)
    for c in (fused_warp_cuda, tps_coords_cuda, patch_gather_cuda):
        c.LAUNCHES.clear()
    res = st.stitch_arrays(v1, None, v2, None)
    assert tps_coords_cuda.LAUNCHES["tps_coords"] == 2
    assert patch_gather_cuda.LAUNCHES["patch_gather"] == 2
    assert fused_warp_cuda.LAUNCHES["fused_warp"] == 0
    assert res.frames.shape[0] == 8 and res.frames.max() > 10


@pytest.mark.parametrize("cfg", [dict(coord_stride=4),
                                 dict(warp_mode="FAST"),
                                 dict(fused_warp=True, coord_stride=4,
                                      download_format="yuv420")],
                         ids=["stride4", "fast", "planar-yuv420"])
def test_composite_routes_card_vs_cpu(cuda_device, cfg):
    """The routes beside the fused default on the card against the CPU on
    the same meshes: <= 1% of values differ, <= 1e-4 by more than a level
    (float32 TPS solves round differently on the two devices)."""
    from stabstitch2_tpu_torch.pipeline.compositor import composite_video

    rng = np.random.default_rng(5)
    T, H, W = 3, 96, 144
    i1, i2 = (rng.integers(0, 255, (T, H, W, 3), dtype=np.uint8)
              for _ in range(2))
    base = np.stack(np.meshgrid(np.linspace(0.0, W, 9),
                                np.linspace(0.0, H, 7)), -1)[None]
    m1, m2 = (torch.from_numpy((base + rng.normal(0, 2, (T, 7, 9, 2)) + s)
                               .astype(np.float32)) for s in (0.0, 25.0))
    config = StitchConfig(canvas_bucket=32, **cfg)
    patch_gather_cuda.LAUNCHES.clear()
    card, _ = composite_video(i1, i2, m1.to(cuda_device), m2.to(cuda_device),
                              config=config, chunk=2, model_size=(H, W))
    if cfg.get("warp_mode") != "FAST":
        assert patch_gather_cuda.LAUNCHES["patch_gather"] == 2
    cpu, _ = composite_video(i1, i2, m1, m2, config=config, chunk=2,
                             model_size=(H, W))
    assert card.shape == cpu.shape and card.max() > 10
    d = np.abs(card.astype(np.int16) - cpu.astype(np.int16))
    assert (d > 0).mean() <= 1e-2 and (d > 1).mean() <= 1e-4, d.max()


def test_pinned_downloads_equal_the_blocking_path(cuda_device):
    """composite_begin's non-blocking copies into page-locked buffers give
    the frames a blocking ``.cpu()`` of each chunk's crop gives."""
    from stabstitch2_tpu_torch.data.video_io import pack_i420_host
    from stabstitch2_tpu_torch.pipeline import compositor

    rng = np.random.default_rng(8)
    T, H, W = 5, 96, 144
    i1, i2 = (rng.integers(0, 255, (T, H, W, 3), dtype=np.uint8)
              for _ in range(2))
    base = np.stack(np.meshgrid(np.linspace(0.0, W, 9),
                                np.linspace(0.0, H, 7)), -1)[None]
    m1, m2 = (torch.from_numpy((base + rng.normal(0, 2, (T, 7, 9, 2)) + s)
                               .astype(np.float32)).to(cuda_device)
              for s in (0.0, 25.0))
    for fmt in ("bgr", "yuv420"):
        config = StitchConfig(canvas_bucket=32, download_format=fmt)
        state = compositor.composite_begin(i1, i2, m1, m2, config=config,
                                           chunk=2, model_size=(H, W))
        assert all(h.is_pinned() for h in state.host)
        got, canvas = compositor.composite_finish(state)
        oh, ow = canvas.out_h, canvas.out_w
        offset = torch.tensor([canvas.x_min, canvas.y_min],
                              device=cuda_device)
        full = compositor.compute_canvas(m1, m2, 32)   # before the even crop
        span = (np.float32(full.out_h), np.float32(full.out_w))
        parts = []
        for s in range(0, T, 2):
            out = compositor.composite_chunk(
                torch.from_numpy(i1[s:s + 2]).to(cuda_device),
                torch.from_numpy(i2[s:s + 2]).to(cuda_device),
                m1[s:s + 2], m2[s:s + 2], offset,
                (canvas.pad_h, canvas.pad_w), "AVERAGE", span,
                out_format=fmt)
            if fmt == "yuv420":
                y, u, v = (p.cpu().numpy() for p in out)
                parts.append(pack_i420_host(y[:, :oh, :ow],
                                            u[:, :oh // 2, :ow // 2],
                                            v[:, :oh // 2, :ow // 2]))
            else:
                parts.append(out[:, :oh, :ow].cpu().numpy())
        np.testing.assert_array_equal(got, np.concatenate(parts, 0))


def test_begun_video_survives_the_next_begin(cuda_device):
    """Two videos begun before either is finished (the CLI's two-deep
    loop): each keeps its staged uploads and its host buffers, and each
    gives the frames of its own stitch_arrays, bit for bit."""
    from stabstitch2_tpu_torch.data.video_io import bgr_to_i420
    from synthetic import make_two_view_clip

    st = init_stitcher(0, StitchConfig(download_format="yuv420"), model_h=128,
                       model_w=160, chunk=4, device=cuda_device)
    clips = [tuple(bgr_to_i420(v) for v in
                   make_two_view_clip(num_frames=8, height=128, width=160,
                                      overlap=0.6, shake_px=2.0, seed=s))
             for s in (5, 6)]
    refs = [st.stitch_arrays(a, None, b, None) for a, b in clips]
    pending = [st.stitch_begin(a, None, b, None) for a, b in clips]
    assert all(h.is_pinned() for p in pending for h in p.staging)
    for p, ref in zip(pending, refs):
        res = st.stitch_finish(p)
        np.testing.assert_array_equal(res.frames, ref.frames)
        torch.testing.assert_close(res.smooth_mesh1, ref.smooth_mesh1,
                                   atol=0, rtol=0)


@pytest.mark.parametrize("packed", [False, True])
def test_stream_upload_equals_bulk_two_deep(cuda_device, packed):
    """``upload_mode="stream"`` (copies on the copy stream, one event per
    chunk) with two videos begun before either is finished: each gives
    the bulk upload's frames and meshes bit for bit, with a tail chunk.
    Stream runs the motion eagerly, so the bulk reference is the eager
    one (``fused_motion=False``): the fused bulk pads the tail chunk and
    the 16-frame bucket, where the kernels may take other algorithms."""
    import dataclasses

    from stabstitch2_tpu_torch.data.video_io import bgr_to_i420
    from synthetic import make_two_view_clip

    st = init_stitcher(0, StitchConfig(download_format="yuv420"), model_h=128,
                       model_w=160, chunk=4, device=cuda_device)
    clips = []
    for s in (5, 6):
        v = make_two_view_clip(num_frames=10, height=128, width=160,
                               overlap=0.6, shake_px=2.0, seed=s)
        clips.append(tuple(bgr_to_i420(x) for x in v) if packed else v)
    eager = dataclasses.replace(st, fused_motion=False)
    refs = [eager.stitch_arrays(a, None, b, None) for a, b in clips]
    st.upload_mode = "stream"
    pending = [st.stitch_begin(a, None, b, None) for a, b in clips]
    for p, ref in zip(pending, refs):
        res = st.stitch_finish(p)
        np.testing.assert_array_equal(res.frames, ref.frames)
        for k in ("smooth_mesh1", "smooth_mesh2"):
            torch.testing.assert_close(getattr(res, k), getattr(ref, k),
                                       atol=0, rtol=0)


def test_bf16_meshes_within_the_cpu_bound(cuda_device):
    """bf16 against float32 trunks on the card, on the seed-0 model and
    the clip of tests/test_torch_entry.py's bound (2 x 0.0702 px, twice
    the JAX package's gap on the CPU)."""
    from synthetic import make_two_view_clip

    v1, v2 = make_two_view_clip(8, 360, 480, overlap=0.6, shake_px=2.0,
                                seed=5)
    runs = [init_stitcher(0, StitchConfig(canvas_bucket=32), chunk=4,
                          compute_dtype=dt, device=cuda_device)
            .stitch_arrays(v1, None, v2, None)
            for dt in (torch.float32, None)]
    gap = max(float((getattr(runs[0], k) - getattr(runs[1], k)).abs().max())
              for k in ("smooth_mesh1", "smooth_mesh2"))
    assert 0 < gap <= 2 * 0.0702, gap


def test_tps_warp_with_mask_float_k3_equals_plain(cuda_device):
    """Float images (the metric harness's warp): K3's coordinates, then the
    float bilinear sample, equal the plain path's on the card exactly."""
    from stabstitch2_tpu_torch.ops.interp import bilinear_mask, bilinear_sample
    from stabstitch2_tpu_torch.ops.tps import tps_coords_plain, tps_warp_with_mask

    im, T, norm = _warp_case(cuda_device, span=(120, 160))
    img = im.to(torch.float32) + 0.25
    n = tps_coords_cuda.LAUNCHES["tps_coords"]
    warped, mask = tps_warp_with_mask(img, norm, None, (120, 160), T=T)
    torch.cuda.synchronize()
    assert tps_coords_cuda.LAUNCHES["tps_coords"] == n + 1
    x, y = tps_coords_plain(T, norm, (120, 160))
    ref = bilinear_sample(img, x, y).reshape(warped.shape)
    torch.testing.assert_close(warped, ref, atol=0, rtol=0)
    torch.testing.assert_close(mask, bilinear_mask(120, 160, x, y)
                               .reshape(mask.shape), atol=0, rtol=0)


def test_online_route_a_equals_route_b(cuda_device):
    """The online stitcher's frames on K2 (route A) and on K3 + K4 (route
    B) are the same bytes, bgr and i420 (NORMAL-mode route B chains the
    4:2:0 conversion, so i420 compares within one level)."""
    import dataclasses

    from stabstitch2_tpu_torch.pipeline.online import OnlineStitcher
    from synthetic import make_two_view_clip

    v1, v2 = make_two_view_clip(num_frames=9, height=128, width=160,
                                overlap=0.6, shake_px=2.0, seed=5)
    st = init_stitcher(0, StitchConfig(canvas_bucket=32), model_h=128,
                       model_w=160, chunk=4, compute_dtype=torch.float32,
                       device=cuda_device)
    st_b = dataclasses.replace(st, config=StitchConfig(canvas_bucket=32,
                                                       fused_warp=False))
    for fmt, tol in (("bgr", 0), ("i420", 1)):
        frames = []
        for s, kernel in ((st, fused_warp_cuda), (st_b, patch_gather_cuda)):
            kernel.LAUNCHES.clear()
            o = OnlineStitcher(s, emit_format=fmt)
            out = [f for a, b in zip(v1, v2) for f in o.push(a, b)]
            assert len(out) == 9 and sum(kernel.LAUNCHES.values()) == 3
            frames.append(np.stack(out).astype(np.int16))
        assert np.abs(frames[0] - frames[1]).max() <= tol


def test_chain_k2_launch_over_views_equals_per_image_launches(cuda_device):
    """The chain warps V x B images in one K2 launch; each image equals
    its own launch."""
    from stabstitch2_tpu_torch.ops.tps import tps_warp_with_mask

    im, T, norm = _warp_case(cuda_device, B=6)
    n = fused_warp_cuda.LAUNCHES["fused_warp"]
    warped, mask = tps_warp_with_mask(im, norm, None, (144, 256), T=T,
                                      grid_span=(140, 250), fused_warp=True)
    assert fused_warp_cuda.LAUNCHES["fused_warp"] == n + 1
    for i in range(6):
        w, m = tps_warp_with_mask(im[i:i + 1], norm[i:i + 1], None,
                                  (144, 256), T=T[i:i + 1].contiguous(),
                                  grid_span=(140, 250), fused_warp=True)
        torch.testing.assert_close(w[0], warped[i], atol=0, rtol=0)
        torch.testing.assert_close(m[0], mask[i], atol=0, rtol=0)


def test_k2_and_k4_raise_when_inputs_require_grad(cuda_device):
    """Neither kernel has a backward: a CUDA launch with grad enabled and
    inputs that require grad raises instead of dropping the gradient;
    under no_grad, or on the CPU, they run."""
    im, T, norm = _warp_case(cuda_device, B=2)
    Tg = T.clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        fused_warp_cuda.fused_warp_planes(im, Tg, norm, (144, 256))
    with torch.no_grad():
        fused_warp_cuda.fused_warp_planes(im, Tg, norm, (144, 256))
    fused_warp_cuda.fused_warp_planes(im.cpu(), Tg.detach().cpu()
                                      .requires_grad_(True), norm.cpu(),
                                      (144, 256))
    x, y = tps_coords_cuda.tps_coords(T, norm, (144, 256))
    xg = x.clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        patch_gather_cuda.bilinear_sample_patch_u8_cuda(im, xg, y, (144, 256))
    with torch.no_grad():
        patch_gather_cuda.bilinear_sample_patch_u8_cuda(im, xg, y, (144, 256))


@pytest.mark.parametrize("out_size,span,B", [((120, 160), None, 2),
                                             ((30, 40), None, 6),
                                             ((144, 256), (140, 250), 3)])
def test_tps_coords_gradients_equal_plain_autograd(cuda_device, out_size,
                                                   span, B):
    """K3 with inputs that require grad goes through ``TpsCoords``: its
    forward is the kernel (one launch, bit-equal to the plain version) and
    its gradients equal autograd through ``tps_coords_plain`` exactly."""
    _, T0, src0 = _warp_case(cuda_device, B=B)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    n = out_size[0] * out_size[1]
    cot = [torch.randn(B, n, generator=gen, device=cuda_device)
           for _ in range(2)]
    outs, grads = [], []
    for fn in (tps_coords_cuda.tps_coords, tps_coords_cuda.tps_coords_plain):
        T, src = (a.clone().requires_grad_(True) for a in (T0, src0))
        before = tps_coords_cuda.LAUNCHES["tps_coords"]
        xs, ys = fn(T, src, out_size, grid_span=span)
        kernel = fn is tps_coords_cuda.tps_coords
        launched = tps_coords_cuda.LAUNCHES["tps_coords"] - before
        assert launched == (1 if kernel else 0)
        assert type(xs.grad_fn).__name__.startswith("TpsCoords") == kernel
        torch.autograd.backward((xs, ys), cot)
        outs.append((xs.detach(), ys.detach()))
        grads.append((T.grad, src.grad))
    for a, b in zip(outs[0] + grads[0], outs[1] + grads[1]):
        assert torch.equal(a, b)


def test_spatial_train_step_card_vs_cpu(cuda_device):
    """One spatial loss and backward at B=2, 128x160, from the same
    weights and augmentation factors: the loss within 1e-4 relative and
    every gradient within 1e-2 relative L2 of the CPU's (the train
    phase's gate in chip_smoke.py, whose constants say why 1e-2); two K1
    and two K3 launches."""
    import copy

    from stabstitch2_tpu_torch.config import SpatialTrainConfig
    from stabstitch2_tpu_torch.models import SpatialNet
    from stabstitch2_tpu_torch.models.backbone import init_weights
    from stabstitch2_tpu_torch.train.common import draw_aug
    from stabstitch2_tpu_torch.train.spatial import spatial_loss_fn
    from synthetic import make_two_view_clip

    v1, v2 = make_two_view_clip(num_frames=2, height=128, width=160,
                                overlap=0.6, shake_px=2.0, seed=0)
    pair = [torch.from_numpy(v.astype(np.float32) / 127.5 - 1.0)
            for v in (v1, v2)]
    net = SpatialNet(128, 160)
    init_weights(net, torch.Generator().manual_seed(0))
    factors = draw_aug(torch.Generator().manual_seed(0))
    out = {}
    threads = torch.get_num_threads()
    for dev in ("cpu", cuda_device):
        n = copy.deepcopy(net).to(dev).train()
        k1 = corr_cuda.LAUNCHES[5]
        k3 = tps_coords_cuda.LAUNCHES["tps_coords"]
        torch.set_num_threads(1)
        try:
            total, _ = spatial_loss_fn(n, *(x.to(dev) for x in pair),
                                       factors, SpatialTrainConfig())
            total.backward()
        finally:
            torch.set_num_threads(threads)
        out[str(dev)] = (float(total), {k: p.grad.double().cpu()
                                        for k, p in n.named_parameters()})
        if dev != "cpu":
            assert corr_cuda.LAUNCHES[5] - k1 == 2
            assert tps_coords_cuda.LAUNCHES["tps_coords"] - k3 == 2
    (l_cpu, g_cpu), (l_card, g_card) = out["cpu"], out[str(cuda_device)]
    assert abs(l_card - l_cpu) <= 1e-4 * abs(l_cpu)
    gaps = {k: float((g_card[k] - g_cpu[k]).norm() / g_cpu[k].norm())
            for k in g_cpu}
    assert max(gaps.values()) <= 1e-2, gaps


@pytest.mark.parametrize("mode", ["bulk", "stream"])
def test_two_replicas_on_one_card_equal_one(cuda_device, mode):
    """A stitcher dealt over two replicas on the one card (the multi-device
    path: chunk k on replica k mod 2, the halo, the gathers, the per-device
    composite events) gives one replica's frames and meshes bit for bit,
    at the defaults (bf16, I420 up, yuv420 down) with a tail chunk."""
    from stabstitch2_tpu_torch.data.video_io import bgr_to_i420
    from synthetic import make_two_view_clip

    card = torch.device("cuda", torch.cuda.current_device())
    v1, v2 = (bgr_to_i420(x) for x in make_two_view_clip(
        num_frames=10, height=128, width=160, overlap=0.6, shake_px=2.0,
        seed=5))
    sts = [init_stitcher(0, StitchConfig(download_format="yuv420"),
                         model_h=128, model_w=160, chunk=4, device=d)
           for d in (card, [card, card])]
    res = []
    for st in sts:
        st.upload_mode = mode
        res.append(st.stitch_arrays(v1, None, v2, None))
    assert len(sts[1]._motion.replicas) == 2
    np.testing.assert_array_equal(res[1].frames, res[0].frames)
    for k in ("smooth_mesh1", "smooth_mesh2"):
        torch.testing.assert_close(getattr(res[1], k), getattr(res[0], k),
                                   atol=0, rtol=0)


def test_kernels_on_the_last_card(cuda_device):
    """Each kernel's wrapper with its inputs on the last card launches
    there and equals its plain version (K1 within 1e-5, K2-K4 exact): the
    wrappers enter the inputs' device. Needs two or more cards."""
    count = torch.cuda.device_count()
    if count < 2:
        pytest.skip(f"needs two or more CUDA devices ({count} visible): on "
                    "one card the inputs' device is the current one")
    last = torch.device("cuda", count - 1)
    x1, x2 = _cv_inputs((2, 12, 16, 128), last)
    got = corr_cuda.cost_volume_cuda(x1, x2, 3)
    assert got.device == last
    torch.testing.assert_close(got, corr_cuda.cost_volume_plain(x1, x2, 3),
                               atol=1e-5, rtol=1e-5)
    out_size, span = (97, 131), (90, 120)
    im, T, norm = _warp_case(last, span=span)
    want = fused_warp_cuda.fused_warp_planes_plain(im, T, norm, out_size,
                                                   grid_span=span)
    got = fused_warp_cuda.fused_warp_planes(im, T, norm, out_size,
                                            grid_span=span)
    for g, r in zip(got[:4], want[:4]):
        assert g.device == last
        torch.testing.assert_close(g, r, atol=0, rtol=0)
    x, y = tps_coords_cuda.tps_coords(T, norm, out_size, grid_span=span)
    xr, yr = tps_coords_cuda.tps_coords_plain(T, norm, out_size,
                                              grid_span=span)
    assert x.device == last
    torch.testing.assert_close(x, xr, atol=0, rtol=0)
    torch.testing.assert_close(y, yr, atol=0, rtol=0)
    got = patch_gather_cuda.bilinear_sample_patch_u8_cuda(im, x, y, out_size)
    ref = patch_gather_cuda.patch_gather_plain(im, x, y, out_size, False)
    assert got[0].device == last
    torch.testing.assert_close(got[0], ref[0], atol=0, rtol=0)


# ---------------------------------------------------------------------------
# the fused motion's CUDA graphs (utils/graphs.py)
# ---------------------------------------------------------------------------

GRAPH_T = 48


def _graph_stitchers(device, **kw):
    """A stitcher at the defaults (bf16, yuv420 download) at 128x160 with
    chunk 8, fused (the default), and an eager one on the same nets."""
    import dataclasses

    st = init_stitcher(0, StitchConfig(download_format="yuv420"),
                       model_h=128, model_w=160, device=device, **kw)
    assert st.fused_motion
    return st, dataclasses.replace(st, fused_motion=False)


def _graph_clip(seed=5, T=GRAPH_T):
    from synthetic import make_two_view_clip

    return make_two_view_clip(num_frames=T, height=128, width=160,
                              overlap=0.6, shake_px=2.0, seed=seed)


def _assert_same_stitch(a, b):
    np.testing.assert_array_equal(a.frames, b.frames)
    for k in ("smooth_mesh1", "smooth_mesh2", "ori_mesh1", "ori_mesh2"):
        torch.testing.assert_close(getattr(a, k), getattr(b, k), atol=0,
                                   rtol=0)


def test_graph_replays_equal_eager(cuda_device):
    """stitch_begin/finish and motion_smooth replayed from their graphs
    give the eager functions' meshes and frames bit for bit on a 48-frame
    clip; a program's first call at a shape runs eagerly and captures it,
    every later call (the next chunk's too) replays it."""
    from stabstitch2_tpu_torch.pipeline.stitcher import model_input

    st, eager = _graph_stitchers(cuda_device)
    v1, v2 = _graph_clip()
    ref = eager.stitch_arrays(v1, None, v2, None)
    first = st.stitch_arrays(v1, None, v2, None)
    # motion, pair and smooth captured; chunks 1-5 of 6 replayed
    assert st.graphs.captures == 3 and st.graphs.replays == 10
    again = st.stitch_arrays(v1, None, v2, None)
    assert st.graphs.captures == 3 and st.graphs.replays == 10 + 13
    for res in (first, again):
        _assert_same_stitch(res, ref)
    l1, l2 = (model_input(torch.from_numpy(v).to(cuda_device), 128, 160)
              for v in (v1, v2))
    want = eager.motion_smooth(l1, l2)
    got = st.motion_smooth(l1, l2)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, atol=0, rtol=0)


def test_online_graph_replays_equal_eager(cuda_device):
    """48 pushes through the captured online step equal the eager step's
    meshes and frames bit for bit; each push after the first replays."""
    from stabstitch2_tpu_torch.pipeline.online import OnlineStitcher

    st, eager = _graph_stitchers(cuda_device)
    v1, v2 = _graph_clip(seed=6)
    fused, plain = OnlineStitcher(st), OnlineStitcher(eager)
    assert fused.graphs is not None and plain.graphs is None
    for t, (a, b) in enumerate(zip(v1, v2)):
        got, want = fused.push(a, b), plain.push(a, b)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        if want:
            for g, w in zip(fused.window_smooth, plain.window_smooth):
                torch.testing.assert_close(g, w, atol=0, rtol=0)
    assert fused.graphs.captures == 1
    assert fused.graphs.replays == GRAPH_T - 1


def test_begun_video_meshes_survive_the_next_fused_begin(cuda_device):
    """The two-deep loop begins video k+1 before video k's result is read:
    the replays of k+1 leave k's meshes (copied out of the graphs' static
    outputs) as they were."""
    st, eager = _graph_stitchers(cuda_device)
    clips = [_graph_clip(seed=s) for s in (5, 6)]
    refs = [eager.stitch_arrays(a, None, b, None) for a, b in clips]
    st.stitch_arrays(clips[1][0], None, clips[1][1], None)   # captures
    pending = st.stitch_begin(clips[0][0], None, clips[0][1], None)
    kept = {k: v.clone() for k, v in pending.smooth.items()}
    nxt = st.stitch_begin(clips[1][0], None, clips[1][1], None)
    torch.cuda.synchronize()
    for k, v in kept.items():
        torch.testing.assert_close(pending.smooth[k], v, atol=0, rtol=0)
    for p, ref in zip((pending, nxt), refs):
        _assert_same_stitch(st.stitch_finish(p), ref)


def test_replicate_makes_new_graphs(cuda_device):
    st, _ = _graph_stitchers(cuda_device)
    v1, v2 = _graph_clip(T=16)
    st.stitch_arrays(v1, None, v2, None)
    old = st.graphs
    assert len(old) == 3
    replays = old.replays
    st.replicate()
    assert st.graphs is not old and len(st.graphs) == 0
    st.stitch_arrays(v1, None, v2, None)
    assert st.graphs.captures == 3 and old.replays == replays


def test_graph_launch_counts_equal_eager(cuda_device):
    """K1's (and K2's) launches per stitch are the eager path's: a capture
    counts none, each replay what the capture recorded."""
    st, eager = _graph_stitchers(cuda_device)
    v1, v2 = _graph_clip()

    def counted(s):
        corr_cuda.LAUNCHES.clear()
        fused_warp_cuda.LAUNCHES.clear()
        s.stitch_arrays(v1, None, v2, None)
        return (dict(corr_cuda.LAUNCHES), dict(fused_warp_cuda.LAUNCHES))

    want = counted(eager)
    assert want[0] == {5: 12, 3: 6}
    first = counted(st)         # chunk 0 eager and captured, 1-5 replayed
    replayed = dict(st.graphs.replayed)
    again = counted(st)         # all replayed
    assert first == want and again == want
    assert replayed == {"cost_volume_r5": 10, "cost_volume_r3": 5}
    assert dict(st.graphs.replayed) == {"cost_volume_r5": 22,
                                        "cost_volume_r3": 11}


def _metric_clip(T, seed=5):
    from synthetic import make_two_view_clip

    return make_two_view_clip(num_frames=T, height=128, width=160,
                              overlap=0.6, shake_px=2.0, seed=seed)


def _metric_outputs(handle):
    return handle.psnr, handle.ssim, handle.scores


def test_metric_program_replays_equal_uncaptured(cuda_device):
    """The metric harness's one program per 16-frame bucket (bf16, chunk
    8, 128x160): its first call captures it, every later video of the
    bucket (T = 16, 10 and 13) is one replay and no capture, with the
    eager path's K1 and K3 launches at T = 16; each replay's outputs
    equal the program called uncaptured on the same inputs bit for bit."""
    import dataclasses

    from stabstitch2_tpu_torch.metrics import harness

    st = init_stitcher(0, model_h=128, model_w=160, device=cuda_device)
    eager = dataclasses.replace(st, fused_motion=False)
    clips = {T: _metric_clip(T, seed=T) for T in (16, 10, 13)}

    def counted(s, clip):
        corr_cuda.LAUNCHES.clear()
        tps_coords_cuda.LAUNCHES.clear()
        handle = harness._submit_video(s, *clip)
        return handle, (dict(corr_cuda.LAUNCHES),
                        dict(tps_coords_cuda.LAUNCHES))

    harness._submit_video(st, *clips[16])            # eager, then captured
    assert st.graphs.captures == 1 and st.graphs.replays == 0
    want = counted(eager, clips[16])[1]
    assert want == ({5: 4, 3: 2}, {"tps_coords": 4})
    for T, clip in clips.items():
        replays = st.graphs.replays
        handle, launches = counted(st, clip)
        assert st.graphs.replays == replays + 1 and st.graphs.captures == 1
        assert launches == want
        with torch.no_grad():
            x1, x2, n, _ = harness.metric_inputs(st, *clip, "bgr", [])
            ps, ss, *scores = harness._fused_eval(st)(x1, x2, n)
        for g, w in zip(_metric_outputs(handle), (ps, ss, torch.stack(scores))):
            torch.testing.assert_close(g, w, atol=0, rtol=0)


@pytest.mark.parametrize("upload", ["bgr", "i420"])
def test_metric_two_replicas_equal_one(cuda_device, upload):
    """Two replicas on the card (the composed programs: per-chunk motion,
    the bucket's smoothing with the masked scores, per-chunk warp) give
    one replica's one-program scores bit for bit, at two lengths of the
    bucket."""
    from stabstitch2_tpu_torch.metrics import harness

    card = torch.device("cuda", torch.cuda.current_device())
    one, two = (init_stitcher(0, model_h=128, model_w=160, chunk=4, device=d)
                for d in (card, [card, card]))
    assert len(two._motion.replicas) == 2
    for T in (10, 13):
        clip = _metric_clip(T, seed=T)
        handles = [harness._submit_video(s, *clip, upload=upload)
                   for s in (one, two)]
        for g, w in zip(*map(_metric_outputs, handles)):
            torch.testing.assert_close(g, w, atol=0, rtol=0)
    assert sorted({k[0] for k in two.graphs._graphs}) == [
        "metric_scores", "metric_warp", "motion", "pair"]


def test_trace_dir_captures_inside_the_profiler(cuda_device, tmp_path):
    """``cli stitch --trace_dir`` on a fresh stitcher: the first video's
    graphs are captured while torch.profiler traces, the second replays
    them; both traces name K1, and the frames equal the eager path's."""
    import glob
    import os

    from stabstitch2_tpu_torch import cli
    from synthetic import write_clip_dirs

    for seed in (0, 1):
        write_clip_dirs(str(tmp_path / "data"), num_frames=16, height=128,
                        width=160, seed=seed, video_name=f"clip{seed}")
    videos = sorted(glob.glob(str(tmp_path / "data" / "clip*")))
    st, eager = _graph_stitchers(cuda_device)
    got, want = {}, {}
    d = str(tmp_path / "traces")
    done, failed = cli.stitch_stream(st, cli.load_videos(videos),
                                     got.__setitem__, trace_dir=d)
    assert (done, failed) == (2, 0) and st.graphs.replays > 0
    cli.stitch_stream(eager, cli.load_videos(videos), want.__setitem__)
    for name, r in want.items():
        np.testing.assert_array_equal(got[name].frames, r.frames)
    files = sorted(glob.glob(os.path.join(d, "*.json")))
    assert len(files) == 2
    for f in files:
        with open(f) as fh:
            assert "cost_volume_kernel" in fh.read(), f


# the captured training step: each loop at 128x160, batch 2, two epochs of
# two steps (the staircase moves at step 2), on two clips of 14 frames
# (six 12-frame smooth windows)
TRAIN_STEPS = 4
TRAIN_FRAMES = 14
BATCH_RANKS = 4     # tensors of 4 or more dims are the batch's


@pytest.fixture(scope="module")
def train_tree(tmp_path_factory):
    """Two clips of TRAIN_FRAMES frames at 128x160 with seeded motions (the
    smooth stage's inputs)."""
    import os

    from synthetic import write_clip_dirs

    root = str(tmp_path_factory.mktemp("captured_train"))
    rng = np.random.default_rng(0)
    for i in range(2):
        vd = write_clip_dirs(root, num_frames=TRAIN_FRAMES, height=128,
                             width=160, seed=40 + i, video_name=f"v{i}")
        for name, sd in (("TemporalMotion1", 0.5), ("TemporalMotion2", 0.5),
                         ("SpatialMotion1", 2.0), ("SpatialMotion2", 2.0)):
            os.makedirs(f"{vd}/{name}")
            for f in range(TRAIN_FRAMES):
                np.save(f"{vd}/{name}/{f:06d}.npy",
                        rng.normal(0, sd, (7, 9, 2)).astype(np.float32))
    return root


def _train_loop(stage, root, model_dir, device, capture_step):
    """The stage's loop as a user calls it; returns the run and (each
    step's loss terms, the state, the last update's rate)."""
    from stabstitch2_tpu_torch import config
    from stabstitch2_tpu_torch.train import loop

    cfg = getattr(config, f"{stage.capitalize()}TrainConfig")(
        batch_size=2, max_epoch=2)
    losses = []
    run = getattr(loop, f"train_{stage}")(
        root, cfg=cfg, model_dir=model_dir, max_steps_per_epoch=2,
        model_h=128, model_w=160, device=device, capture_step=capture_step,
        on_step=lambda s, m: losses.append(
            {k: float(v) for k, v in m.items()}))
    state = {k: v.detach().clone() for k, v in run.net.state_dict().items()}
    return run, (losses, state, float(run.opt.adam.param_groups[0]["lr"]))


def _gaps(a, b):
    """(largest relative loss gap, largest |d| of the parameters, of the
    BatchNorm statistics, |d| of the last update's rate) between two runs'
    (losses, state, rate)."""
    (la, sa, ra), (lb, sb, rb) = a, b
    loss = max(abs(x[k] - y[k]) / max(abs(y[k]), 1e-30)
               for x, y in zip(la, lb) for k in y)
    stats = ("running_mean", "running_var")
    param = max((float((sa[k].double() - sb[k].double()).abs().max())
                 for k in sb if sb[k].dtype.is_floating_point
                 and not k.endswith(stats)), default=0.0)
    bn = max((float((sa[k].double() - sb[k].double()).abs().max())
              for k in sb if k.endswith(stats)), default=0.0)
    return loss, param, bn, abs(ra - rb)


def _held_to_eager(captured, eager):
    """The gate of ``chip_smoke.py:captured_gate``: per gap of
    :func:`_gaps`, each captured run's gap to the nearest eager run at most
    twice the largest gap between two eager runs (so bit-equal where the
    eager runs are). Returns whether it holds."""
    pairs = itertools.combinations(eager, 2)
    spread = [max(g) for g in zip(*(_gaps(a, b) for a, b in pairs))]
    for run in captured:
        gap = [min(g) for g in zip(*(_gaps(run, e) for e in eager))]
        if not all(g <= 2 * s for g, s in zip(gap, spread)):
            return False
    return True


@pytest.mark.parametrize("stage", ["spatial", "temporal", "smooth"])
def test_captured_training_step_equals_eager(cuda_device, train_tree,
                                             tmp_path, monkeypatch, stage):
    """Each loop's captured step against the same loop with
    ``capture_step=False`` over two epochs of two steps: one capture and
    three replays, the kernels' launches per replay as the eager step
    makes them, the device count and rate at the staircase's second step,
    and the gate of ``_held_to_eager`` on the losses, parameters,
    BatchNorm statistics and last rate of four eager runs, all with
    PyTorch's and cuDNN's deterministic algorithms. The planted faults, a replay that skips the
    copy of the new batch into the static inputs and a rate baked in as a
    Python number at capture, must each fail the gate."""
    def run(tag, capture):
        return _train_loop(stage, train_tree, str(tmp_path / tag),
                           cuda_device, capture)

    # the default algorithms sum in a varying order: with PyTorch's and
    # cuDNN's deterministic ones two eager runs are bit-equal, as in
    # chip_smoke.py's gate runs
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore",
                                    ".*deterministic implementation")
            _captured_step_case(stage, run, monkeypatch)
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = deterministic


def _captured_step_case(stage, run, monkeypatch):
    """The body of :func:`test_captured_training_step_equals_eager`."""
    from stabstitch2_tpu_torch.train.common import Optimizer
    from stabstitch2_tpu_torch.utils.graphs import GraphCache

    before = (collections.Counter(corr_cuda.LAUNCHES),
              collections.Counter(tps_coords_cuda.LAUNCHES))
    cap, captured = run("captured", True)
    per_step = {"spatial": {"cost_volume_r5": 2, "tps_coords": 2},
                "temporal": {"cost_volume_r3": 1, "tps_coords": 1},
                "smooth": {"tps_coords": 8}}[stage]
    g = cap.graphs
    assert (g.captures, g.replays) == (1, TRAIN_STEPS - 1)
    assert dict(g.replayed) == {k: n * (TRAIN_STEPS - 1)
                                for k, n in per_step.items()}
    launched = {"cost_volume_r5": corr_cuda.LAUNCHES[5] - before[0][5],
                "cost_volume_r3": corr_cuda.LAUNCHES[3] - before[0][3],
                "tps_coords": (tps_coords_cuda.LAUNCHES["tps_coords"]
                               - before[1]["tps_coords"])}
    assert {k: v for k, v in launched.items() if v} == {
        k: n * TRAIN_STEPS for k, n in per_step.items()}
    assert cap.opt.step_count == int(cap.opt.count) == TRAIN_STEPS
    assert float(cap.opt.adam.param_groups[0]["lr"]) == np.float32(
        cap.opt.lr(TRAIN_STEPS - 1))
    eager = [run(f"eager{i}", False)[1] for i in range(4)]
    assert _held_to_eager([captured], eager), [_gaps(captured, e)
                                               for e in eager]

    real_replay = GraphCache._replay

    def stale_batch(self, captured, inputs):
        return real_replay(self, captured, [
            s if x.dim() >= BATCH_RANKS else x
            for s, x in zip(captured.inputs, inputs)])

    monkeypatch.setattr(GraphCache, "_replay", stale_batch)
    stale = run("stale_batch", True)[1]
    monkeypatch.undo()
    monkeypatch.setattr(Optimizer, "rate", lambda self: torch.full(
        (), self.lr(self.step_count), dtype=torch.float32,
        device=self.count.device))
    baked = run("baked_rate", True)[1]
    monkeypatch.undo()
    gaps = {"eager_pairs": [_gaps(a, b)
                            for a, b in itertools.combinations(eager, 2)],
            "stale_batch": _gaps(stale, eager[0]),
            "baked_rate": _gaps(baked, eager[0])}
    assert not _held_to_eager([stale], eager), gaps
    assert not _held_to_eager([baked], eager), gaps


def test_capture_that_waits_raises(cuda_device):
    """A planted ``.item()`` inside a captured function: the first call
    runs it eagerly, then its capture raises and no graph is kept; the
    next call raises too rather than run eagerly. (After a failed capture
    the card's state is not to be trusted: on the H100 the next call
    raised before its eager run finished. So a failure ends the run, and
    this test comes last.)"""
    from stabstitch2_tpu_torch.utils.graphs import GraphCache

    ran = []

    def planted(x):
        ran.append(1)
        return x * float(x.sum().item())

    cache = GraphCache()
    x = torch.ones(4, device=cuda_device)
    with pytest.raises(RuntimeError):
        cache.run("planted", planted, x)
    assert len(ran) == 2          # the eager run, then the capture
    assert len(cache) == 0 and cache.captures == 0
    with pytest.raises(RuntimeError):
        cache.run("planted", planted, x)
    assert len(cache) == 0 and cache.captures == 0
