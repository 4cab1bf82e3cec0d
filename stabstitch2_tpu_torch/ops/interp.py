"""Bilinear resampling with the reference's arithmetic (port of ``ops/interp.py``).

Normalized coordinates map to pixels as ``x_px = (x + 1) * W / 2``; corner
indices are clamped to the image and the weights are taken from the
clamped corners against the unclamped position, so samples far outside
the image sum to zero (the NORMAL warp mode's border semantics).

Images are NHWC; coordinates are flat [B, N] sample positions.
"""

from __future__ import annotations

import torch


def _gather_pixels(flat_im: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """flat_im: [B, H*W, C]; idx: [B, N] int64 -> [B, N, C]."""
    C = flat_im.shape[-1]
    return torch.gather(flat_im, 1, idx[..., None].expand(-1, -1, C))


def _index(c: torch.Tensor) -> torch.Tensor:
    """A clamped corner coordinate as a gather index (NaN reads pixel 0;
    its weights are NaN or zero)."""
    return torch.nan_to_num(c, nan=0.0).long()


def _corners(x: torch.Tensor, y: torch.Tensor, H: int, W: int):
    """Unclamped sample position and clamped corner coordinates."""
    xf = (x + 1.0) * (W / 2.0)
    yf = (y + 1.0) * (H / 2.0)
    x0 = torch.floor(xf)
    y0 = torch.floor(yf)
    x0c = torch.clamp(x0, 0.0, W - 1)
    x1c = torch.clamp(x0 + 1.0, 0.0, W - 1)
    y0c = torch.clamp(y0, 0.0, H - 1)
    y1c = torch.clamp(y0 + 1.0, 0.0, H - 1)
    return xf, yf, x0, y0, x0c, x1c, y0c, y1c


def bilinear_sample(im: torch.Tensor, x: torch.Tensor,
                    y: torch.Tensor) -> torch.Tensor:
    """Sample ``im`` [B, H, W, C] at normalized (x, y) [B, N] -> [B, N, C]."""
    B, H, W, C = im.shape
    xf, yf, _, _, x0c, x1c, y0c, y1c = _corners(x, y, H, W)
    wa = (x1c - xf) * (y1c - yf)
    wb = (x1c - xf) * (yf - y0c)
    wc = (xf - x0c) * (y1c - yf)
    wd = (xf - x0c) * (yf - y0c)
    x0i, x1i, y0i, y1i = (_index(v) for v in (x0c, x1c, y0c, y1c))
    flat = im.reshape(B, H * W, C).to(x.dtype)
    Ia = _gather_pixels(flat, y0i * W + x0i)
    Ib = _gather_pixels(flat, y1i * W + x0i)
    Ic = _gather_pixels(flat, y0i * W + x1i)
    Id = _gather_pixels(flat, y1i * W + x1i)
    return (wa[..., None] * Ia + wb[..., None] * Ib
            + wc[..., None] * Ic + wd[..., None] * Id)


def _patch_weights_idx(x: torch.Tensor, y: torch.Tensor, H: int, W: int):
    """Corner/weight algebra of the packed-patch samplers.

    Returns (wa, wb, wc, wd, y0i, x0i): the reference's four weights, set
    to zero where the low-side corner lies outside (x0 < 0 or y0 < 0, or
    NaN), and the clamped top-left corner indices.
    """
    xf, yf, x0, y0, x0c, x1c, y0c, y1c = _corners(x, y, H, W)
    inside = (x0 >= 0.0) & (y0 >= 0.0)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    wa = torch.where(inside, (x1c - xf) * (y1c - yf), zero)
    wb = torch.where(inside, (x1c - xf) * (yf - y0c), zero)
    wc = torch.where(inside, (xf - x0c) * (y1c - yf), zero)
    wd = torch.where(inside, (xf - x0c) * (yf - y0c), zero)
    return wa, wb, wc, wd, _index(y0c), _index(x0c)


def support_mask(x: torch.Tensor, y: torch.Tensor, H: int,
                 W: int) -> torch.Tensor:
    """Live pixels in the FACTORED form ``inside & (x1c-x0c)*(y1c-y0c) > 0``.

    The product is exactly zero at dead pixels, so no cancellation noise
    decides liveness (the four-weight sum is the same quantity but is
    evaluated with cancellation).
    """
    _, _, x0, y0, x0c, x1c, y0c, y1c = _corners(x, y, H, W)
    inside = (x0 >= 0.0) & (y0 >= 0.0)
    return inside & ((x1c - x0c) * (y1c - y0c) > 0)


def pack_bgr_u8(im: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 3] uint8 -> [B, H, W] int32 packed as B | G<<8 | R<<16."""
    im = im.to(torch.int32)
    return im[..., 0] | (im[..., 1] << 8) | (im[..., 2] << 16)


def _patch_corners_u8(im: torch.Tensor, y0i: torch.Tensor, x0i: torch.Tensor):
    """Packed corners (a, b, c, d) = (y0x0, y1x0, y0x1, y1x1).

    The +1 neighbours are clamped to the last row/column, which equals the
    JAX version's edge-padded 2x2 patch gathered at (y0, x0).
    """
    B, H, W, _ = im.shape
    flat = pack_bgr_u8(im).reshape(B, H * W)
    x1i = torch.clamp(x0i + 1, max=W - 1)
    y1i = torch.clamp(y0i + 1, max=H - 1)

    def at(yi, xi):
        return torch.gather(flat, 1, yi * W + xi)

    return at(y0i, x0i), at(y1i, x0i), at(y0i, x1i), at(y1i, x1i)


def _combine_planes(ga, gb, gc, gd, wa, wb, wc, wd):
    """Per-channel weighted combine of packed corners, reference order."""
    def ch(shift):
        ua = ((ga >> shift) & 0xFF).to(wa.dtype)
        ub = ((gb >> shift) & 0xFF).to(wa.dtype)
        uc = ((gc >> shift) & 0xFF).to(wa.dtype)
        ud = ((gd >> shift) & 0xFF).to(wa.dtype)
        return wa * ua + wb * ub + wc * uc + wd * ud

    return ch(0), ch(8), ch(16)


def bilinear_sample_patch_u8(im: torch.Tensor, x: torch.Tensor,
                             y: torch.Tensor) -> torch.Tensor:
    """:func:`bilinear_sample` for uint8 BGR images through one patch gather.

    im: [B, H, W, 3] uint8; x, y: [B, N]. Returns [B, N, 3] in x's dtype.
    Low-side out-of-image samples are exact zeros; NaN coordinates give 0.
    """
    B, H, W, C = im.shape
    if C != 3 or im.dtype != torch.uint8:
        raise ValueError(f"need uint8 [B,H,W,3], got {tuple(im.shape)} {im.dtype}")
    wa, wb, wc, wd, y0i, x0i = _patch_weights_idx(x, y, H, W)
    ga, gb, gc, gd = _patch_corners_u8(im, y0i, x0i)
    return torch.stack(_combine_planes(ga, gb, gc, gd, wa, wb, wc, wd), -1)


def bilinear_mask(im_h: int, im_w: int, x: torch.Tensor,
                  y: torch.Tensor) -> torch.Tensor:
    """The warped all-ones channel (coverage) as the sum of the four weights."""
    xf, yf, _, _, x0c, x1c, y0c, y1c = _corners(x, y, im_h, im_w)
    return ((x1c - xf) * (y1c - yf) + (x1c - xf) * (yf - y0c)
            + (xf - x0c) * (y1c - yf) + (xf - x0c) * (yf - y0c))
