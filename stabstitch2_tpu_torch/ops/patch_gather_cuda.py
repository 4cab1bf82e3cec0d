"""Wrapper of the patch-gather kernel K4 (``csrc/patch_gather.cu``).

Replaces the TPU kernel ``stabstitch2_tpu/ops/pallas_gather.py:_kernel``
(called through ``bilinear_sample_patch_u8_pallas``): the NORMAL-mode
bilinear sample of uint8 BGR images at given coordinates, with dead pixels
(outside the factored support, NaN coordinates included) exact zeros.

The TPU kernel's source windows, row tiles and overflow flag exist because
Mosaic cannot gather from HBM. A CUDA thread reads any source pixel, so
nothing can overflow: the returned ``viol`` is always False, and there is
no repair leg. Its ``flat`` and ``canvas2d`` layouts differ only in where
XLA combined, so both are the interleaved output here; ``planes`` is the
planar one.

On a CPU tensor the wrapper runs :func:`patch_gather_plain`; on a CUDA
tensor it launches the kernel or raises. The kernel has no backward, so a
CUDA launch with grad enabled and coordinates that require grad raises
rather than drop the gradient.

On the card a call issues the one kernel and nothing else, so that the
host keeps ahead of it: the output is one ``torch.empty``; the stream is
read as a raw handle (``torch._C._cuda_getCurrentRawStream``, the call
PyTorch's own generated code makes, which builds no ``Stream`` object
as ``torch.cuda.current_stream`` does); the C entry point makes the card
current only if it is not, and restores it; and ``viol`` is one False
tensor per card (:func:`_false`).
"""

from __future__ import annotations

import collections
from typing import Dict, Tuple

import torch

from stabstitch2_tpu_torch.ops.interp import bilinear_sample_patch_u8, support_mask
from stabstitch2_tpu_torch.utils.cuda_build import check_launch, load_kernels

# launches of the kernel (plain integer under one key)
LAUNCHES: collections.Counter = collections.Counter()
# the largest B * N the kernel's 32-bit flat pixel index takes
MAX_PIXELS = 2**31 - 1 - 4
# viol per card (_false)
_FALSE: Dict[torch.device, torch.Tensor] = {}


def patch_gather_plain(im: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                       out_hw: Tuple[int, int], planes: bool = False):
    """The kernel's function in plain PyTorch: the packed-patch sample
    with dead pixels set to 0 by ``support_mask``."""
    B, H, W, _ = im.shape
    oh, ow = out_hw
    live = support_mask(x, y, H, W)[..., None]
    s = bilinear_sample_patch_u8(im, x, y)
    s = torch.where(live, s, torch.zeros((), dtype=s.dtype, device=s.device))
    viol = torch.zeros((), dtype=torch.bool, device=im.device)
    if planes:
        p = s.reshape(B, oh, ow, 3)
        return p[..., 0], p[..., 1], p[..., 2], viol
    return s.reshape(B, oh, ow, 3), viol


def _check(im, x, y, out_hw):
    if im.dim() != 4 or im.shape[-1] != 3 or im.dtype != torch.uint8:
        raise ValueError(f"need uint8 [B,H,W,3], got {tuple(im.shape)} "
                         f"{im.dtype}")
    B = im.shape[0]
    N = out_hw[0] * out_hw[1]
    if x.shape != (B, N) or y.shape != (B, N):
        raise ValueError(f"need x, y [{B}, {N}] for a {out_hw} raster, got "
                         f"{tuple(x.shape)} / {tuple(y.shape)}")
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError(f"need float32 coordinates, got {x.dtype}, {y.dtype}")
    if not (im.device == x.device == y.device):
        raise ValueError("im, x and y must share a device")


def _false(device: torch.device) -> torch.Tensor:
    """The card's shared False, an inference tensor: an in-place write to
    it outside ``inference_mode`` raises (PyTorch checks the version
    counter after the write, so a caller that writes to it fails at
    once; no caller does). One made while a CUDA graph is captured lives
    in the graph's pool, so it is not kept."""
    viol = _FALSE.get(device)
    if viol is None:
        with torch.inference_mode():
            viol = torch.zeros((), dtype=torch.bool, device=device)
        if not torch.cuda.is_current_stream_capturing():
            _FALSE[device] = viol
    return viol


def bilinear_sample_patch_u8_cuda(im: torch.Tensor, x: torch.Tensor,
                                  y: torch.Tensor, out_hw: Tuple[int, int],
                                  planes: bool = False):
    """Bilinear sample of uint8 BGR images at normalized coordinates.

    im: [B, H, W, 3] uint8; x, y: [B, oh*ow] float32, an (oh, ow) raster.
    Returns ([B, oh, ow, 3] float32, viol), or with ``planes`` the
    B, G, R planes [B, oh, ow] and viol; ``viol`` is always False (on the
    card one tensor shared by every call, see :func:`_false`).
    """
    _check(im, x, y, out_hw)
    if im.device.type == "cpu":
        return patch_gather_plain(im, x, y, out_hw, planes)
    if im.device.type != "cuda":
        raise ValueError(f"unsupported device {im.device}")
    if torch.is_grad_enabled() and (x.requires_grad or y.requires_grad):
        raise RuntimeError(
            "bilinear_sample_patch_u8_cuda: the patch-gather kernel has no "
            "backward, and x or y requires grad; sample a float image or "
            "call under torch.no_grad()")
    if not (im.is_contiguous() and x.is_contiguous() and y.is_contiguous()):
        raise ValueError("bilinear_sample_patch_u8_cuda needs contiguous inputs")
    B, H, W, _ = im.shape
    oh, ow = out_hw
    N = oh * ow
    if B * N > MAX_PIXELS:
        raise ValueError(f"bilinear_sample_patch_u8_cuda: {B} x {N} pixels, "
                         f"more than the kernel's {MAX_PIXELS}")
    dev = im.device
    out = torch.empty((B, 3, oh, ow) if planes else (B, oh, ow, 3),
                      dtype=torch.float32, device=dev)
    if out.numel():
        err = load_kernels().stabstitch_patch_gather(
            im.data_ptr(), x.data_ptr(), y.data_ptr(), out.data_ptr(),
            B, H, W, N, int(planes), dev.index,
            torch._C._cuda_getCurrentRawStream(dev.index))
        check_launch("patch_gather_kernel", err)
        LAUNCHES["patch_gather"] += 1
    if planes:
        return out[:, 0], out[:, 1], out[:, 2], _false(dev)
    return out, _false(dev)
