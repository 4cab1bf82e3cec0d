"""YUV 4:2:0 (I420) conversions (port of ``ops/yuv.py``).

Download side: the mp4 encoder converts to 4:2:0 anyway, so the
compositor can emit I420 planes, half the device->host bytes of uint8
BGR. Conventions are OpenCV's ``COLOR_BGR2YUV_I420``: limited-range BT.601
coefficients and top-left 2x2 chroma decimation. Quantization rounds half
to even (``torch.round``, as ``jnp.round``), then clips to 0..255.

Upload side: frames go up as packed I420 (1.5 bytes per pixel; source
jpgs and mp4s are 4:2:0 anyway) and :func:`unpack_i420_u8` turns them
into uint8 BGR on the device. Plain tensor ops, as the JAX package
computes them in XLA.
"""

from __future__ import annotations

from typing import Tuple

import torch

Planes = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _q(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x), 0.0, 255.0).to(torch.uint8)


def _yuv(b: torch.Tensor, g: torch.Tensor, r: torch.Tensor) -> Planes:
    y = 16.0 + 0.256788 * r + 0.504129 * g + 0.097906 * b
    bd, gd, rd = b[:, ::2, ::2], g[:, ::2, ::2], r[:, ::2, ::2]
    u = 128.0 - 0.148223 * rd - 0.290993 * gd + 0.439216 * bd
    v = 128.0 + 0.439216 * rd - 0.367788 * gd - 0.071427 * bd
    return _q(y), _q(u), _q(v)


def bgr_to_yuv420(frames: torch.Tensor) -> Planes:
    """float BGR [B, H, W, 3] (0..255, H and W even) -> (Y, U, V) uint8.

    Y: [B, H, W]; U, V: [B, H/2, W/2].
    """
    return _yuv(frames[..., 0], frames[..., 1], frames[..., 2])


def bgr_u8_to_yuv420(frames_u8: torch.Tensor) -> Planes:
    """uint8 BGR [B, H, W, 3] -> (Y, U, V): quantize first, then convert,
    as the bgr download and the mp4 writer do."""
    return bgr_to_yuv420(frames_u8.to(torch.float32))


def bgr_planes_to_yuv420(b: torch.Tensor, g: torch.Tensor,
                         r: torch.Tensor) -> Planes:
    """Planar float BGR [B, H, W] x3 (0..255) -> (Y, U, V) uint8.

    The planes are rounded to uint8 BGR before converting, as the JAX
    package's planar route does. (Its bgr download truncates instead, so
    the chained route's bytes can differ from these by a level.)
    """
    return _yuv(*(_q(c).to(torch.float32) for c in (b, g, r)))


def pack_i420(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor
              ) -> torch.Tensor:
    """(Y [B, H, W], U, V [B, H/2, W/2]) -> packed I420 [B, H*3//2, W]."""
    B, H, W = y.shape
    flat = torch.cat([y.reshape(B, -1), u.reshape(B, -1), v.reshape(B, -1)],
                     dim=1)
    return flat.reshape(B, H * 3 // 2, W)


def i420_to_bgr(packed: torch.Tensor) -> torch.Tensor:
    """Packed I420 [B, H*3//2, W] (uint8 or float) -> float32 BGR
    [B, H, W, 3], clipped to 0..255: limited-range BT.601, 2x nearest
    chroma upsampling (the inverse of the conventions above).

    The planes lie one after the other in the buffer (cv2's layout), so
    they are split by element count, not by rows: when H % 4 != 0 the U
    plane ends in the middle of a row.
    """
    B, H15, W = packed.shape
    H = H15 * 2 // 3
    flat = packed.to(torch.float32).reshape(B, -1)
    n = H * W
    y = flat[:, :n].reshape(B, H, W)
    u = flat[:, n:n + n // 4].reshape(B, H // 2, W // 2)
    v = flat[:, n + n // 4:].reshape(B, H // 2, W // 2)

    def up(c):   # 2x nearest, by broadcasting (no data-dependent sizes)
        return c[:, :, None, :, None].expand(B, H // 2, 2, W // 2, 2).reshape(
            B, H, W)

    u = up(u) - 128.0
    v = up(v) - 128.0
    c = (y - 16.0) * 1.164383
    b = c + 2.017232 * u
    g = c - 0.391762 * u - 0.812968 * v
    r = c + 1.596027 * v
    return torch.clamp(torch.stack([b, g, r], -1), 0.0, 255.0)


def unpack_i420_u8(packed_u8: torch.Tensor) -> torch.Tensor:
    """Packed I420 [.., H*3//2, W] -> uint8 BGR [.., H, W, 3]: rounded
    half to even, then uint8 (``i420_to_bgr`` clips)."""
    return torch.round(i420_to_bgr(packed_u8)).to(torch.uint8)
