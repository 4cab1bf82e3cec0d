"""Wrapper of the cost-volume kernel K1 (``csrc/cost_volume.cu``).

Replaces the TPU kernel ``stabstitch2_tpu/ops/pallas_corr.py:_cv_kernel``
(called through ``cost_volume_fused``). On a CPU tensor the wrapper runs
the plain version, :func:`cost_volume_plain`; on a CUDA tensor it
launches the kernel or raises. The backward of :class:`CostVolume` is
autograd through the plain version, as the JAX ``custom_vjp`` takes the
VJP of its jnp formula.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from stabstitch2_tpu_torch.ops.cost_volume import cost_volume

# launches of the kernel, keyed by search range (plain integers)
LAUNCHES: collections.Counter = collections.Counter()
# the kernel keeps its 4 (2r+1) accumulators in registers, so each search
# range is a template instance (csrc/cost_volume.cu): 0..7
MAX_SEARCH_RANGE = 7


def cost_volume_plain(x1: torch.Tensor, x2: torch.Tensor,
                      search_range: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch: ``ops/cost_volume.py``."""
    return cost_volume(x1, x2, search_range)


def _check(x1: torch.Tensor, x2: torch.Tensor, search_range: int) -> None:
    if x1.shape != x2.shape or x1.dim() != 4:
        raise ValueError(f"need two equal [B,H,W,C] maps, got "
                         f"{tuple(x1.shape)} and {tuple(x2.shape)}")
    if x1.dtype != torch.float32 or x2.dtype != torch.float32:
        raise TypeError(f"need float32, got {x1.dtype} and {x2.dtype}")
    if x1.device != x2.device:
        raise ValueError(f"inputs on {x1.device} and {x2.device}")
    if search_range < 0:
        raise ValueError(f"search_range {search_range} < 0")


def _launch(x1: torch.Tensor, x2: torch.Tensor,
            search_range: int) -> torch.Tensor:
    from stabstitch2_tpu_torch.utils.cuda_build import check_launch, load_kernels

    if not (x1.is_contiguous() and x2.is_contiguous()):
        raise ValueError("cost_volume_cuda needs contiguous NHWC inputs")
    if search_range > MAX_SEARCH_RANGE:
        raise ValueError(f"cost_volume_cuda: search_range {search_range} > "
                         f"{MAX_SEARCH_RANGE}, the largest the kernel has")
    B, H, W, C = x1.shape
    k = 2 * search_range + 1
    out = torch.empty(B, H, W, k * k, dtype=x1.dtype, device=x1.device)
    if out.numel() == 0:
        return out
    lib = load_kernels()
    with torch.cuda.device(x1.device):
        stream = torch.cuda.current_stream(x1.device).cuda_stream
        err = lib.stabstitch_cost_volume(
            ctypes.c_void_p(x1.data_ptr()), ctypes.c_void_p(x2.data_ptr()),
            ctypes.c_void_p(out.data_ptr()), B, H, W, C, search_range,
            x1.device.index, ctypes.c_void_p(stream))
    check_launch("cost_volume_kernel", err)
    LAUNCHES[search_range] += 1
    return out


class CostVolume(torch.autograd.Function):
    """K1 forward; backward = autograd through :func:`cost_volume_plain`."""

    @staticmethod
    def forward(ctx, x1, x2, search_range):
        ctx.save_for_backward(x1, x2)
        ctx.search_range = search_range
        return _launch(x1, x2, search_range)

    @staticmethod
    def backward(ctx, grad):
        x1, x2 = ctx.saved_tensors
        with torch.enable_grad():
            a = x1.detach().requires_grad_(True)
            b = x2.detach().requires_grad_(True)
            out = cost_volume_plain(a, b, ctx.search_range)
            ga, gb = torch.autograd.grad(out, (a, b), grad)
        return ga, gb, None


def cost_volume_cuda(x1: torch.Tensor, x2: torch.Tensor,
                     search_range: int) -> torch.Tensor:
    """Cost volume: [B, H, W, C] x2 -> [B, H, W, (2r+1)^2], float32 NHWC.

    CPU tensors take the plain version; CUDA tensors the kernel.
    """
    _check(x1, x2, search_range)
    if x1.device.type == "cpu":
        return cost_volume_plain(x1, x2, search_range)
    if x1.device.type != "cuda":
        raise ValueError(f"unsupported device {x1.device}")
    if x1.requires_grad or x2.requires_grad:
        return CostVolume.apply(x1, x2, search_range)
    return _launch(x1, x2, search_range)
