"""The port's hand-written CUDA kernels against their plain versions.

Every test here needs an NVIDIA card: it is marked ``cuda`` and skips
where ``torch.cuda.is_available()`` is false. The file imports neither JAX
nor the JAX package, so it also runs on a machine without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

Tolerances: K1 1e-5 (the kernel sums the channels in another order);
K2 exact, since kernel and plain version do the same float32 operations
in the same order.
"""

import numpy as np
import pytest
import torch

from stabstitch2_tpu_torch.ops import corr_cuda, fused_warp_cuda
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
                                            (900.0, (144, 256))])
def test_fused_warp_kernel(cuda_device, shift, out_size):
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
