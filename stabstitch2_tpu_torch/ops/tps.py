"""Thin-plate-spline solve and evaluation (port of ``ops/tps.py``).

The (P+3)x(P+3) system is solved in float32, as the JAX package does
(PARITY.md "Known deviations": the evaluated coordinates stay within
~0.015 px of the reference's float64 solve at 360x480).

:func:`spline_eval` evaluates the spline point by point in one fixed
order, ``a0 + a1*x + a2*y`` then ``+ w_p * U(d_p^2)`` for p = 0..P-1. That
is the order of the fused composite-warp kernel (``csrc/fused_warp.cu``)
and of the TPS-coordinate kernel (``csrc/tps_coords.cu``), so the kernels
and this plain version give the same float32 coordinates, and no
[B, P+3, H*W] basis is ever built.

:func:`tps_params` solves on a card with cuSOLVER/cuBLAS
(:func:`batched_lu_on_cublas`): PyTorch's default hands a batch of more
than 16 systems of more than 16 unknowns, as every TPS system here has,
to MAGMA, whose batched LU waits for the host and so drains the card. At
16 systems or fewer the default takes the same kernels, so the results
are those of the default route.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import numpy as np
import torch

from stabstitch2_tpu_torch.utils.profiling import annotate, count

_RBF_EPS = 1e-6  # reference: U(d2) = d2 * log(d2 + 1e-6)


def _rbf(d2: torch.Tensor) -> torch.Tensor:
    return d2 * torch.log(d2 + _RBF_EPS)


def _system(source: torch.Tensor) -> torch.Tensor:
    """The TPS system matrix [B, P+3, P+3] for source points [B, P, 2]."""
    B, P, _ = source.shape
    kw = dict(dtype=source.dtype, device=source.device)
    p = torch.cat([torch.ones(B, P, 1, **kw), source], dim=2)       # [B,P,3]
    diff = p[:, :, None, :] - p[:, None, :, :]
    r = _rbf(torch.sum(diff * diff, dim=3))                          # [B,P,P]
    W_top = torch.cat([p, r], dim=2)
    W_bot = torch.cat([torch.zeros(B, 3, 3, **kw), p.transpose(1, 2)], dim=2)
    return torch.cat([W_top, W_bot], dim=1)


@contextlib.contextmanager
def batched_lu_on_cublas(device):
    """On a card, PyTorch's cuSOLVER/cuBLAS linear algebra for the enclosed
    code (a solve, or a whole training step), eager or captured alike.
    Its default hands a batch of more than 16 systems of more than 16
    unknowns to MAGMA, which waits for the host and so cannot be captured:
    the smooth step solves 56 TPS systems of 66 unknowns at batch 8.
    cuBLAS factors and solves such batches in one batched call each.

    The setting is the process's, not the thread's: a solve that another
    thread makes meanwhile takes this route too, so the enclosed code must
    not run on several threads at once. Inside an enclosing use the
    setting is already cuSOLVER and is left alone."""
    backends = torch.backends.cuda
    if (torch.device(device).type != "cuda"
            or backends.preferred_linalg_library()
            == torch._C._LinalgBackend.Cusolver):
        yield
        return
    previous = backends.preferred_linalg_library()
    backends.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        backends.preferred_linalg_library(previous)


def tps_params(source: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """TPS coefficients mapping ``source`` [B, P, 2] onto ``target``.

    Returns T: [B, 2, P+3], affine part in columns 0..2, RBF weights after.
    float32 LU with partial pivoting, on a card under
    :func:`batched_lu_on_cublas` (so not from several threads at once).
    Under a profiler: a ``tps_solve`` span, and the counter
    ``tps_systems`` (B).
    """
    with annotate("tps_solve"):
        B = source.shape[0]
        rhs = torch.cat([target, torch.zeros(B, 3, 2, dtype=target.dtype,
                                             device=target.device)], dim=1)
        count("tps_systems", B)
        with batched_lu_on_cublas(source.device):
            T = torch.linalg.solve_ex(_system(source), rhs).result
        return T.transpose(1, 2)


def tps_params_shared_source(source: torch.Tensor,
                             targets: torch.Tensor) -> torch.Tensor:
    """TPS coefficients for ONE source [P, 2] and many targets [B, P, 2].

    The system is factored once and back-substituted for every target.
    """
    B = targets.shape[0]
    LU, piv, _ = torch.linalg.lu_factor_ex(_system(source[None])[0])
    rhs = torch.cat([targets, torch.zeros(B, 3, 2, dtype=targets.dtype,
                                          device=targets.device)], dim=1)
    P3 = rhs.shape[1]
    flat = rhs.permute(1, 2, 0).reshape(P3, 2 * B)       # cols = (xy, batch)
    sol = torch.linalg.lu_solve(LU, piv, flat)
    return sol.reshape(P3, 2, B).permute(2, 1, 0)        # [B, 2, P+3]


def _eval_grid_rows(points_x: torch.Tensor, points_y: torch.Tensor,
                    source: torch.Tensor) -> torch.Tensor:
    """Rows [1, x, y, U_1..U_P] for points [B, N]: [B, P+3, N]."""
    px = source[:, :, 0:1]
    py = source[:, :, 1:2]
    r = _rbf((points_x[:, None, :] - px) ** 2 + (points_y[:, None, :] - py) ** 2)
    B, N = source.shape[0], points_x.shape[-1]
    ones = torch.ones(B, 1, N, dtype=source.dtype, device=source.device)
    return torch.cat([ones, points_x[:, None, :].expand(B, 1, N),
                      points_y[:, None, :].expand(B, 1, N), r], dim=1)


def _span_step(span_n) -> float:
    """Grid step 2/(span-1) of linspace(-1, 1, span).

    A Python number divides in double precision (rounded to float32 where
    it is used); a float32 scalar, as the compositor passes its true
    canvas extent, divides in float32, as the JAX package does for a
    traced extent.
    """
    if isinstance(span_n, (int, float)):
        return 2.0 / (span_n - 1) if span_n > 1 else 0.0
    s = np.float32(span_n)
    if not s > 1:
        return 0.0
    return float(np.float32(2.0) / np.maximum(s - np.float32(1.0),
                                              np.float32(1.0)))


def grid_1d(n: int, span_n, dtype=torch.float32, device=None) -> torch.Tensor:
    """linspace(-1, 1, span_n) extended with the same step to n points.

    A canvas padded past its true extent keeps the true extent's
    normalization (TPS is only similarity-invariant).
    """
    return -1.0 + _span_step(span_n) * torch.arange(n, dtype=dtype,
                                                    device=device)


def spline_eval(T: torch.Tensor, source: torch.Tensor, gx: torch.Tensor,
                gy: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Evaluate the spline at points gx, gy [B or 1, N] in the kernel's order.

    T: [B, 2, P+3]; source: [B, P, 2]. Returns (x_s, y_s), each [B, N].
    """
    acc_x = T[:, 0, 0:1] + T[:, 0, 1:2] * gx + T[:, 0, 2:3] * gy
    acc_y = T[:, 1, 0:1] + T[:, 1, 1:2] * gx + T[:, 1, 2:3] * gy
    for p in range(source.shape[1]):
        dx = gx - source[:, p, 0:1]
        dy = gy - source[:, p, 1:2]
        d2 = dx * dx + dy * dy
        r = d2 * torch.log(d2 + _RBF_EPS)
        acc_x = acc_x + T[:, 0, 3 + p:4 + p] * r
        acc_y = acc_y + T[:, 1, 3 + p:4 + p] * r
    return acc_x, acc_y


def tps_coords_plain(T: torch.Tensor, source: torch.Tensor,
                     out_size: Tuple[int, int],
                     grid_span: Optional[Tuple[float, float]] = None,
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The spline over the normalized output grid at stride 1, in plain
    PyTorch: (x_s, y_s) [B, H*W].

    ``grid_span`` gives the true canvas extent when ``out_size`` is a
    padded superset.
    """
    out_h, out_w = out_size
    span_h, span_w = grid_span or out_size
    kw = dict(dtype=T.dtype, device=T.device)
    gx = grid_1d(out_w, span_w, **kw)[None, :].expand(out_h, out_w).reshape(1, -1)
    gy = grid_1d(out_h, span_h, **kw)[:, None].expand(out_h, out_w).reshape(1, -1)
    return spline_eval(T, source, gx, gy)


def _lerp_upsample_1d(coarse: torch.Tensor, n: int, stride: int,
                      dim: int) -> torch.Tensor:
    """Linear interpolation from samples at 0, s, 2s, ... to 0..n-1."""
    j = torch.arange(n, device=coarse.device)
    i0 = torch.div(j, stride, rounding_mode="floor")
    frac = (j % stride).to(coarse.dtype) / stride
    a = torch.index_select(coarse, dim, i0)
    b = torch.index_select(coarse, dim, i0 + 1)
    shape = [1] * coarse.dim()
    shape[dim] = n
    frac = frac.reshape(shape)
    return a * (1.0 - frac) + b * frac


def _strided_coords(T: torch.Tensor, source: torch.Tensor,
                    out_size: Tuple[int, int], grid_span, stride: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The spline on every ``stride``-th pixel, interpolated linearly to
    full resolution (the JAX package's coarse-lattice path)."""
    out_h, out_w = out_size
    span_h, span_w = grid_span or out_size
    B = source.shape[0]
    hc = (out_h - 1) // stride + 2
    wc = (out_w - 1) // stride + 2
    kw = dict(dtype=T.dtype, device=T.device)
    # the lattice step in float32, as the JAX package computes it
    step_x = float(np.float32(_span_step(span_w)) * np.float32(stride))
    step_y = float(np.float32(_span_step(span_h)) * np.float32(stride))
    x1 = -1.0 + step_x * torch.arange(wc, **kw)
    y1 = -1.0 + step_y * torch.arange(hc, **kw)
    gx = x1[None, :].expand(hc, wc).reshape(1, -1).expand(B, -1)
    gy = y1[:, None].expand(hc, wc).reshape(1, -1).expand(B, -1)
    rows = _eval_grid_rows(gx, gy, source)
    field = torch.einsum("bij,bjn->bin", T, rows).reshape(B, 2, hc, wc)
    field = _lerp_upsample_1d(field, out_h, stride, 2)
    field = _lerp_upsample_1d(field, out_w, stride, 3)
    flat = field.reshape(B, 2, out_h * out_w)
    # contiguous, as K3 returns them: K4 takes only contiguous coordinates
    return flat[:, 0].contiguous(), flat[:, 1].contiguous()


def tps_sample_coords(T: torch.Tensor, source: torch.Tensor,
                      out_size: Tuple[int, int],
                      grid_span: Optional[Tuple[float, float]] = None,
                      coord_stride: int = 1,
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Spline over the normalized output grid: (x_s, y_s) [B, H*W].

    At stride 1 the TPS-coordinate kernel K3 (``ops/tps_coords_cuda.py``)
    evaluates it on a CUDA tensor and :func:`tps_coords_plain` on a CPU
    tensor, with the same float32 result. ``coord_stride`` > 1 evaluates
    every s-th pixel of a coarse lattice (one matrix product, float32; the
    caller keeps TF32 off) and interpolates linearly.
    """
    if coord_stride > 1:
        return _strided_coords(T, source, out_size, grid_span, coord_stride)
    from stabstitch2_tpu_torch.ops.tps_coords_cuda import tps_coords

    return tps_coords(T, source, out_size, grid_span=grid_span)


def tps_warp(im: torch.Tensor, source: torch.Tensor, target: torch.Tensor,
             out_size: Tuple[int, int], mode: str = "NORMAL",
             T: Optional[torch.Tensor] = None,
             grid_span: Optional[Tuple[float, float]] = None,
             coord_stride: int = 1) -> torch.Tensor:
    """TPS image warp [B, oh, ow, C] of ``im`` as float32: the coordinate
    route of :func:`tps_warp_with_mask` with ``bilinear_sample`` in NORMAL
    mode whatever the input's dtype, as the JAX package's ``tps_warp``."""
    return tps_warp_with_mask(im.to(torch.float32), source, target, out_size,
                              mode=mode, T=T, grid_span=grid_span,
                              coord_stride=coord_stride)[0]


def tps_warp_with_mask(im: torch.Tensor, source: torch.Tensor,
                       target: Optional[torch.Tensor],
                       out_size: Tuple[int, int], mode: str = "NORMAL",
                       T: Optional[torch.Tensor] = None,
                       grid_span: Optional[Tuple[float, float]] = None,
                       coord_stride: int = 1, fused_warp: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """TPS warp of ``im`` [B, H, W, C] and its coverage mask.

    ``source`` is the deformed mesh and ``target`` the rigid lattice, both
    [B, P, 2] normalized; each output pixel is mapped through the
    source->target spline and sampled from ``im`` (backward warping).
    ``T`` skips the solve (``target`` is then unused). Returns the warped
    image float32 [B, oh, ow, C] and the mask [B, oh, ow].

    The routes, one per input:
    - uint8 BGR, NORMAL, ``coord_stride`` 1 and ``fused_warp``: the fused
      composite-warp kernel K2 (``ops/fused_warp_cuda.py``) does the
      spline, the sample and the mask;
    - otherwise the coordinates come from :func:`tps_sample_coords` (K3 at
      stride 1), then NORMAL samples uint8 BGR with the patch-gather
      kernel K4 (``ops/patch_gather_cuda.py``) and anything else with
      ``bilinear_sample``, with ``bilinear_mask``; FAST uses the
      ``grid_sample``-style sampler and mask.
    Each wrapper runs its plain version on a CPU tensor.
    """
    from stabstitch2_tpu_torch.ops.interp import (
        bilinear_mask, bilinear_sample, grid_sample_align_corners,
        grid_sample_mask_align_corners)

    B, H, W, C = im.shape
    u8_bgr = im.dtype == torch.uint8 and C == 3
    if T is None:
        T = tps_params(source, target).contiguous()
    source = source.contiguous()
    if fused_warp and mode == "NORMAL" and u8_bgr and coord_stride == 1:
        from stabstitch2_tpu_torch.ops.fused_warp_cuda import fused_warp_planes

        pb, pg, pr, mask, _ = fused_warp_planes(im, T, source, out_size,
                                                grid_span=grid_span)
        return torch.stack([pb, pg, pr], dim=-1), mask
    x_s, y_s = tps_sample_coords(T, source, out_size, grid_span=grid_span,
                                 coord_stride=coord_stride)
    if mode == "NORMAL":
        if u8_bgr:
            from stabstitch2_tpu_torch.ops.patch_gather_cuda import (
                bilinear_sample_patch_u8_cuda)

            sampled, _ = bilinear_sample_patch_u8_cuda(im, x_s, y_s, out_size)
        else:
            sampled = bilinear_sample(im, x_s, y_s)
        m = bilinear_mask(H, W, x_s, y_s)
    elif mode == "FAST":
        sampled = grid_sample_align_corners(im.to(torch.float32), x_s, y_s)
        m = grid_sample_mask_align_corners(H, W, x_s, y_s)
    else:
        raise ValueError(f"unknown warp mode {mode!r}")
    return sampled.reshape(B, *out_size, C), m.reshape(B, *out_size)


def tps_transform_points(points: torch.Tensor, source: torch.Tensor,
                         target: torch.Tensor,
                         T: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Map points [B, N, 2] through the source->target spline: [B, N, 2]."""
    if T is None:
        T = tps_params(source, target)
    rows = _eval_grid_rows(points[..., 0], points[..., 1], source)
    return torch.einsum("bij,bjn->bin", T, rows).transpose(1, 2)
