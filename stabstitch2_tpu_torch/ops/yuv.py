"""BGR -> YUV 4:2:0 (I420) conversion for the yuv420 download (port of
``ops/yuv.py``, output side).

The mp4 encoder converts to 4:2:0 anyway, so the compositor can emit I420
planes: half the device->host bytes of uint8 BGR. Conventions are
OpenCV's ``COLOR_BGR2YUV_I420``: limited-range BT.601 coefficients and
top-left 2x2 chroma decimation. Quantization rounds half to even
(``torch.round``, as ``jnp.round``), then clips to 0..255.
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
