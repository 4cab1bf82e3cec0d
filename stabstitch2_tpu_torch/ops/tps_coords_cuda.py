"""Wrapper of the TPS-coordinate kernel K3 (``csrc/tps_coords.cu``).

Replaces the TPU kernel ``stabstitch2_tpu/ops/pallas_warp.py:_kernel``
(called through ``tps_coords_fused``): the spline's sample coordinates at
every canvas pixel, without the [B, P+3, H*W] radial basis. The TPU
kernel's (8, W) row tiles and padded rows are not carried over.

On a CPU tensor the wrapper runs :func:`ops.tps.tps_coords_plain`; on a
CUDA tensor it launches the kernel or raises. Where ``T`` or ``source``
requires grad, the launch goes through :class:`TpsCoords`, whose backward
is autograd through the plain version (as ``ops/corr_cuda.py:CostVolume``
does for K1): the kernel's forward equals the plain version bit for bit,
so the gradient is the plain route's.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Optional, Tuple

import torch

from stabstitch2_tpu_torch.ops.tps import grid_1d, tps_coords_plain

# launches of the kernel (plain integer under one key)
LAUNCHES: collections.Counter = collections.Counter()


def _check(T: torch.Tensor, source: torch.Tensor) -> None:
    B = source.shape[0] if source.dim() == 3 else -1
    P = source.shape[1] if source.dim() == 3 else -1
    if source.shape != (B, P, 2) or T.shape != (B, 2, P + 3):
        raise ValueError(f"need T [B,2,P+3] and source [B,P,2], got "
                         f"{tuple(T.shape)} / {tuple(source.shape)}")
    if T.dtype != torch.float32 or source.dtype != torch.float32:
        raise TypeError(f"need float32 T and source, got {T.dtype}, "
                        f"{source.dtype}")
    if T.device != source.device:
        raise ValueError("T and source must share a device")


def _launch(T: torch.Tensor, source: torch.Tensor,
            out_size: Tuple[int, int],
            grid_span: Optional[Tuple[float, float]]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    from stabstitch2_tpu_torch.utils.cuda_build import check_launch, load_kernels

    if not (T.is_contiguous() and source.is_contiguous()):
        raise ValueError("tps_coords needs contiguous T and source")
    B, P = source.shape[0], source.shape[1]
    oh, ow = out_size
    span_h, span_w = grid_span if grid_span is not None else out_size
    gx = grid_1d(ow, span_w, torch.float32, T.device)
    gy = grid_1d(oh, span_h, torch.float32, T.device)
    xs = torch.empty(B, oh * ow, dtype=torch.float32, device=T.device)
    ys = torch.empty_like(xs)
    if xs.numel():
        lib = load_kernels()
        with torch.cuda.device(T.device):
            stream = torch.cuda.current_stream(T.device).cuda_stream
            err = lib.stabstitch_tps_coords(
                ctypes.c_void_p(T.data_ptr()),
                ctypes.c_void_p(source.data_ptr()),
                ctypes.c_void_p(gx.data_ptr()), ctypes.c_void_p(gy.data_ptr()),
                ctypes.c_void_p(xs.data_ptr()), ctypes.c_void_p(ys.data_ptr()),
                B, oh, ow, P, T.device.index, ctypes.c_void_p(stream))
        check_launch("tps_coords_kernel", err)
        LAUNCHES["tps_coords"] += 1
    return xs, ys


class TpsCoords(torch.autograd.Function):
    """K3 forward; backward = autograd through :func:`tps_coords_plain`."""

    @staticmethod
    def forward(ctx, T, source, out_size, grid_span):
        ctx.save_for_backward(T, source)
        ctx.out_size, ctx.grid_span = out_size, grid_span
        return _launch(T, source, out_size, grid_span)

    @staticmethod
    def backward(ctx, grad_x, grad_y):
        T, source = ctx.saved_tensors
        with torch.enable_grad():
            t = T.detach().requires_grad_(True)
            s = source.detach().requires_grad_(True)
            xs, ys = tps_coords_plain(t, s, ctx.out_size,
                                      grid_span=ctx.grid_span)
            gt, gs = torch.autograd.grad((xs, ys), (t, s), (grad_x, grad_y))
        return gt, gs, None, None


def tps_coords(T: torch.Tensor, source: torch.Tensor,
               out_size: Tuple[int, int],
               grid_span: Optional[Tuple[float, float]] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """TPS sample coordinates at every pixel of ``out_size``.

    T: [B, 2, P+3]; source: [B, P, 2] (the deformed mesh, normalized);
    out_size: the (padded) canvas; grid_span: the true canvas extent used
    for normalization. Returns (x_s, y_s), each float32 [B, oh*ow].
    """
    _check(T, source)
    if T.device.type == "cpu":
        return tps_coords_plain(T, source, out_size, grid_span=grid_span)
    if T.device.type != "cuda":
        raise ValueError(f"unsupported device {T.device}")
    if T.requires_grad or source.requires_grad:
        return TpsCoords.apply(T, source, tuple(out_size), grid_span)
    return _launch(T, source, out_size, grid_span)
