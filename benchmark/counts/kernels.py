"""Bytes and float32 operations that each kernel's work needs, from its
shapes: the work of the call whatever kernel does it, so a redesign of a
kernel leaves the counts as they are.

Each input byte is counted read once and each output byte written once;
an FMA counts two operations. The bound of a call is the larger of its
bytes over the HBM rate and its operations over the float32 rate
(``peaks.py``); a kernel's roofline share is that bound over its device
time.

- K1, the local correlation volume (search range r): both maps read, the
  (2r+1)^2 channels written; per output a product and an add per channel
  (2C), the mean's scale and the leaky ReLU (2).
- The TPS spline at every pixel of a canvas (K2's and K3's core):
  (X - sx_p)^2 once per column and point and (Y - sy_p)^2 once per row
  and point (2 each), then per pixel the affine part (4 per coordinate)
  and per pixel and point the sum of the squares, + 1e-6, the log
  (``LOG_OPS``), a product and a multiply-add per coordinate.
- K2, the fused composite warp: the uint8 images, T, the sources and the
  grid read; three planes and the mask written (float32); the spline, 30
  operations a pixel for corners, weights, mask and support, and 21 per
  live pixel (3 channels x 4 multiplies and 3 adds).
- K3, the spline's sample coordinates: T, the sources and the grid read,
  two coordinates a pixel written; the spline.
- K4, the patch gather: the uint8 images and two coordinates a pixel
  read, three float32 channels a pixel written; 27 operations a pixel
  and 21 per live pixel.
"""

from __future__ import annotations

from typing import Tuple

from benchmark.counts import peaks

# float32 operations of the log inside the spline, as the SASS of the
# kernels' bit-equal log counts them
LOG_OPS = 25


def bound_s(nbytes: float, ops: float) -> float:
    """The least seconds the chip could take: bytes over the HBM rate or
    float32 operations over the float32 peak, whichever is larger."""
    return max(nbytes / peaks.HBM_BYTES_PER_S,
               ops / peaks.FLOP_PER_S["float32"])


def k1(B: int, H: int, W: int, C: int, r: int) -> Tuple[float, float]:
    k2 = (2 * r + 1) ** 2
    return (2 * B * H * W * C * 4 + B * H * W * k2 * 4,
            B * H * W * k2 * (2 * C + 2))


def spline_ops(images: int, oh: int, ow: int, P: int) -> float:
    return images * (2 * P * (oh + ow) + oh * ow * (8 + P * (7 + LOG_OPS)))


def k2(images: int, H: int, W: int, oh: int, ow: int, P: int,
       live: float) -> Tuple[float, float]:
    """``live``: the live pixels of all ``images`` canvases."""
    npix = images * oh * ow
    nbytes = (images * H * W * 3 + (images * 2 * (P + 3) + images * P * 2
                                    + oh + ow) * 4 + npix * 4 * 4)
    return nbytes, spline_ops(images, oh, ow, P) + npix * 30 + live * 21


def k3(images: int, oh: int, ow: int, P: int) -> Tuple[float, float]:
    npix = images * oh * ow
    nbytes = (images * 2 * (P + 3) + images * P * 2 + oh + ow) * 4 + npix * 8
    return nbytes, spline_ops(images, oh, ow, P)


def k4(images: int, H: int, W: int, oh: int, ow: int,
       live: float) -> Tuple[float, float]:
    npix = images * oh * ow
    return images * H * W * 3 + npix * 8 + npix * 12, npix * 27 + live * 21
