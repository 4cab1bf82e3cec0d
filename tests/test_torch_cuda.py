"""The port's hand-written CUDA kernels against their plain versions.

Every test here needs an NVIDIA card: it is marked ``cuda`` and skips
where ``torch.cuda.is_available()`` is false. The file imports neither JAX
nor the JAX package, so it also runs on a machine without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

Tolerances: K1 1e-5 (the kernel sums the channels in another order);
K2, K3 and K4 exact, since kernel and plain version do the same float32
operations in the same order (and K2 and K3 evaluate the spline through
the same device routine, so K3 + K4 give K2's planes exactly).
"""

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
