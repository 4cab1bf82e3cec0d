"""Wrapper of the fused composite-warp kernel K2 (``csrc/fused_warp.cu``).

Replaces the TPU kernel ``stabstitch2_tpu/ops/pallas_fused.py:_kernel``
(called through ``fused_warp_planes``): per canvas pixel, the TPS spline,
the bilinear corner/weight algebra, the gather of the four uint8 BGR
corners and their weighted combine, plus the coverage mask.

The TPU kernel's window machinery (``window_origins``,
``fused_window_tiles``, the (8, 128) tiling and the ``bad`` overflow
plane) exists because Mosaic cannot gather from HBM. A CUDA thread reads
any source pixel from global memory, so nothing can overflow and the
returned ``viol`` is always False.

On a CPU tensor the wrapper runs :func:`fused_warp_planes_plain`; on a
CUDA tensor it launches the kernel or raises. The kernel has no backward,
so a CUDA launch with grad enabled and a ``T`` or ``source`` that requires
grad raises rather than drop the gradient; the trainers warp float
images, which take the coordinate kernel K3 and its backward instead.
"""

from __future__ import annotations

import collections
import ctypes
import struct
from typing import Optional, Tuple

import torch

from stabstitch2_tpu_torch.ops.interp import (
    _combine_planes,
    _patch_corners_u8,
    _patch_weights_idx,
    bilinear_mask,
    support_mask,
)
from stabstitch2_tpu_torch.ops.tps import grid_1d, tps_coords_plain

# launches of the kernel (plain integer under one key)
LAUNCHES: collections.Counter = collections.Counter()


def fused_warp_planes_plain(im: torch.Tensor, T: torch.Tensor,
                            source: torch.Tensor, out_size: Tuple[int, int],
                            grid_span=None):
    """The kernel's function in plain PyTorch.

    ``tps_coords_plain`` + the packed-patch sample as planes +
    ``bilinear_mask`` + the factored support mask (dead pixels exact 0).
    Returns (pb, pg, pr, mask, viol) with planes [B, oh, ow] float32.
    """
    B, H, W, _ = im.shape
    oh, ow = out_size
    x_s, y_s = tps_coords_plain(T, source, out_size, grid_span=grid_span)
    wa, wb, wc, wd, y0i, x0i = _patch_weights_idx(x_s, y_s, H, W)
    live = support_mask(x_s, y_s, H, W)
    zero = torch.zeros((), dtype=x_s.dtype, device=x_s.device)
    planes = [torch.where(live, p, zero).reshape(B, oh, ow)
              for p in _combine_planes(*_patch_corners_u8(im, y0i, x0i),
                                       wa, wb, wc, wd)]
    mask = bilinear_mask(H, W, x_s, y_s).reshape(B, oh, ow)
    viol = torch.zeros((), dtype=torch.bool, device=im.device)
    return planes[0], planes[1], planes[2], mask, viol


def _check(im, T, source):
    if im.dim() != 4 or im.shape[-1] != 3 or im.dtype != torch.uint8:
        raise ValueError(f"need uint8 [B,H,W,3], got {tuple(im.shape)} "
                         f"{im.dtype}")
    B = im.shape[0]
    P = source.shape[1] if source.dim() == 3 else -1
    if source.shape != (B, P, 2) or T.shape != (B, 2, P + 3):
        raise ValueError(f"T {tuple(T.shape)} / source {tuple(source.shape)} "
                         f"do not match a batch of {B}")
    if T.dtype != torch.float32 or source.dtype != torch.float32:
        raise TypeError(f"need float32 T and source, got {T.dtype}, "
                        f"{source.dtype}")
    if not (im.device == T.device == source.device):
        raise ValueError("im, T and source must share a device")


def fused_warp_planes(im: torch.Tensor, T: torch.Tensor,
                      source: torch.Tensor, out_size: Tuple[int, int],
                      grid_span: Optional[Tuple[float, float]] = None):
    """Fused composite warp.

    im: [B, H, W, 3] uint8; T: [B, 2, P+3]; source: [B, P, 2] (the deformed
    mesh, normalized); out_size: the (padded) canvas; grid_span: the true
    canvas extent used for normalization. Returns (pb, pg, pr, mask, viol):
    [B, oh, ow] float32 weighted samples per channel, the coverage mask,
    and a bool scalar that is always False.
    """
    _check(im, T, source)
    if im.device.type == "cpu":
        return fused_warp_planes_plain(im, T, source, out_size, grid_span)
    if im.device.type != "cuda":
        raise ValueError(f"unsupported device {im.device}")
    if torch.is_grad_enabled() and (T.requires_grad or source.requires_grad):
        raise RuntimeError(
            "fused_warp_planes: the fused warp kernel has no backward, and T "
            "or source requires grad; warp a float image (the coordinate "
            "kernel, which has one) or call under torch.no_grad()")
    from stabstitch2_tpu_torch.utils.cuda_build import check_launch, load_kernels

    if not (im.is_contiguous() and T.is_contiguous()
            and source.is_contiguous()):
        raise ValueError("fused_warp_planes needs contiguous inputs")
    B, H, W, _ = im.shape
    P = source.shape[1]
    oh, ow = out_size
    span_h, span_w = grid_span if grid_span is not None else out_size
    gx = grid_1d(ow, span_w, torch.float32, im.device)
    gy = grid_1d(oh, span_h, torch.float32, im.device)
    out = torch.empty(B, 4, oh, ow, dtype=torch.float32, device=im.device)
    if out.numel():
        lib = load_kernels()
        with torch.cuda.device(im.device):
            stream = torch.cuda.current_stream(im.device).cuda_stream
            err = lib.stabstitch_fused_warp(
                ctypes.c_void_p(im.data_ptr()), ctypes.c_void_p(T.data_ptr()),
                ctypes.c_void_p(source.data_ptr()),
                ctypes.c_void_p(gx.data_ptr()), ctypes.c_void_p(gy.data_ptr()),
                ctypes.c_void_p(out.data_ptr()), B, H, W, oh, ow, P,
                im.device.index, ctypes.c_void_p(stream))
        check_launch("fused_warp_kernel", err)
        LAUNCHES["fused_warp"] += 1
    viol = torch.zeros((), dtype=torch.bool, device=im.device)
    return out[:, 0], out[:, 1], out[:, 2], out[:, 3], viol


# log_core's domain in the kernel: every float32 from 1e-6 to FLT_MAX
LOG_CHECK_LO = struct.unpack("<I", struct.pack("<f", 1e-6))[0]
LOG_CHECK_HI = 0x7F7FFFFF


def log_core_check(device) -> Tuple[int, Optional[int]]:
    """The kernel's branch-free log (``warp_common.cuh:log_core``) against
    the accurate ``logf``, on the card, over every float32 with bits from
    LOG_CHECK_LO to LOG_CHECK_HI: (inputs whose results differ in any bit,
    the smallest such bits or None)."""
    from stabstitch2_tpu_torch.utils.cuda_build import check_launch, load_kernels

    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"log_core_check runs on the card, not {device}")
    bad = torch.zeros(1, dtype=torch.int64, device=device)
    first = torch.full((1,), -1, dtype=torch.int32, device=device)
    lib = load_kernels()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.stabstitch_log_core_check(
            LOG_CHECK_LO, LOG_CHECK_HI - LOG_CHECK_LO + 1,
            ctypes.c_void_p(bad.data_ptr()), ctypes.c_void_p(first.data_ptr()),
            device.index if device.index is not None else 0,
            ctypes.c_void_p(stream))
    check_launch("log_core_check_kernel", err)
    n = int(bad.item())
    return n, (int(first.item()) & 0xFFFFFFFF) if n else None
