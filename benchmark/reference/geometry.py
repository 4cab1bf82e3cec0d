"""The geometry of the pipeline in plain PyTorch, float32.

A frozen copy of the reference's arithmetic: the local correlation volume
(mean over C of shifted products, leaky ReLU 0.1), the CCL flow, the
4-point DLT, the homography warp with the reference's sampling convention
(``x_px = (x + 1) * W / 2``, corners clamped, weights from the clamped
corners), meshes, the thin-plate spline (solved in float32, evaluated in
the order ``a0 + a1 x + a2 y + sum_p w_p U(d_p^2)``, ``U(d2) = d2 log(d2 +
1e-6)``), AVERAGE and LINEAR fusion and the BT.601 I420 conversions.
Meshes are [..., GH+1, GW+1, 2] in (x, y) order; images are NHWC.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

RBF_EPS = 1e-6


def const(data, device, dtype=torch.float32) -> torch.Tensor:
    return torch.tensor(data, dtype=dtype, device=device)


# -- correlation --------------------------------------------------------------

def cost_volume(x1, x2, r: int):
    """[B, H, W, C] x2 -> [B, H, W, (2r+1)^2]."""
    B, H, W, C = x1.shape
    k = 2 * r + 1
    padded = F.pad(x2, (0, 0, r, r, r, r))
    slices = [torch.mean(x1 * padded[:, dy:dy + H, dx:dx + W, :], dim=-1)
              for dy in range(k) for dx in range(k)]
    return F.leaky_relu(torch.stack(slices, -1), negative_slope=0.1)


def _l2n(x, eps=1e-12):
    return x / torch.clamp(torch.sqrt(torch.sum(x * x, -1, keepdim=True)),
                           min=eps)


def _patches3(x):
    B, H, W, C = x.shape
    p = F.pad(x, (0, 0, 1, 1, 1, 1))
    return torch.cat([p[:, dy:dy + H, dx:dx + W, :] for dy in range(3)
                      for dx in range(3)], -1).reshape(B, H * W, 9 * C)


def ccl_flow(f1, f2, scale: float = 10.0):
    """Contextual correlation flow [B, H, W, 2] (w, h)."""
    B, H, W, C = f1.shape
    attn = torch.softmax(torch.matmul(_patches3(_l2n(f1)),
                                      _patches3(_l2n(f2)).transpose(1, 2))
                         * scale, dim=2)
    idx = torch.arange(H * W, dtype=attn.dtype, device=attn.device)
    pos = torch.stack([idx % W, torch.div(idx, W, rounding_mode="floor")], 1)
    return (torch.matmul(attn, pos) - pos[None]).reshape(B, H, W, 2)


# -- homographies -------------------------------------------------------------

def solve_dlt(src, dst):
    """H [B, 3, 3] mapping 4 points src onto dst ([B, 4, 2])."""
    B = src.shape[0]
    kw = dict(dtype=src.dtype, device=src.device)
    xy1 = torch.cat([src, torch.ones(B, 4, 1, **kw)], 2)
    z = torch.zeros(B, 4, 3, **kw)
    M1 = torch.stack([torch.cat([xy1, z], 2), torch.cat([z, xy1], 2)],
                     2).reshape(B, 8, 6)
    M2 = torch.einsum("bpi,bpj->bpij", dst, src).reshape(B, 8, 2)
    h8 = torch.linalg.solve(torch.cat([M1, -M2], 2),
                            dst.reshape(B, 8, 1)).reshape(B, 8)
    return torch.cat([h8, torch.ones(B, 1, **kw)], 1).reshape(B, 3, 3)


def bidirectional_homographies(H_motion, img_h, img_w, scale=1.0):
    """(H_ref, H_tgt) from a 4-point motion [B, 4, 2] (TL, TR, BL, BR)."""
    B = H_motion.shape[0]
    src = const([[0.0, 0.0], [img_w, 0.0], [0.0, img_h], [img_w, img_h]],
                H_motion.device)[None].expand(B, 4, 2) / scale
    H = solve_dlt(src, src + H_motion / scale)
    H_tgt = solve_dlt(src, src + (H_motion / 2.0) / scale)
    return torch.linalg.inv(H) @ H_tgt, H_tgt


def normalize_homography(H, h, w):
    w2, h2 = float(w) / 2.0, float(h) / 2.0
    M = const([[w2, 0.0, w2], [0.0, h2, h2], [0.0, 0.0, 1.0]], H.device)
    Mi = const([[1.0 / w2, 0.0, -1.0], [0.0, 1.0 / h2, -1.0],
                [0.0, 0.0, 1.0]], H.device)
    return torch.einsum("ij,bjk,kl->bil", Mi, H, M)


def homo_warp(im, theta, out_size):
    """Warp NHWC [B, H, W, C] by normalized homographies [B, 3, 3]."""
    oh, ow = out_size
    x = torch.linspace(-1.0, 1.0, ow, device=im.device)
    y = torch.linspace(-1.0, 1.0, oh, device=im.device)
    gy, gx = torch.meshgrid(y, x, indexing="ij")
    grid = torch.stack([gx.reshape(-1), gy.reshape(-1),
                        torch.ones(oh * ow, device=im.device)], 0)
    T = torch.einsum("bij,jn->bin", theta, grid)
    t = T[:, 2]
    t = t + 1e-6 * (1.0 - (t.abs() >= 1e-7).to(t.dtype))
    return bilinear_sample(im, T[:, 0] / t, T[:, 1] / t).reshape(
        im.shape[0], oh, ow, im.shape[-1])


# -- sampling -----------------------------------------------------------------

def _corners(x, y, H, W):
    xf = (x + 1.0) * (W / 2.0)
    yf = (y + 1.0) * (H / 2.0)
    x0, y0 = torch.floor(xf), torch.floor(yf)
    return (xf, yf, x0, y0, torch.clamp(x0, 0.0, W - 1),
            torch.clamp(x0 + 1.0, 0.0, W - 1), torch.clamp(y0, 0.0, H - 1),
            torch.clamp(y0 + 1.0, 0.0, H - 1))


def _idx(c):
    return torch.nan_to_num(c, nan=0.0).long()


def bilinear_sample(im, x, y):
    """``im`` [B, H, W, C] at normalized (x, y) [B, N] -> [B, N, C]."""
    B, H, W, C = im.shape
    xf, yf, _, _, x0c, x1c, y0c, y1c = _corners(x, y, H, W)
    flat = im.reshape(B, H * W, C).to(x.dtype)

    def at(yi, xi):
        return torch.gather(flat, 1, (_idx(yi) * W + _idx(xi))[..., None]
                            .expand(-1, -1, C))

    return (((x1c - xf) * (y1c - yf))[..., None] * at(y0c, x0c)
            + ((x1c - xf) * (yf - y0c))[..., None] * at(y1c, x0c)
            + ((xf - x0c) * (y1c - yf))[..., None] * at(y0c, x1c)
            + ((xf - x0c) * (yf - y0c))[..., None] * at(y1c, x1c))


def sample_u8_live(im, x, y):
    """Bilinear samples of uint8 BGR ``im`` [B, H, W, 3] at (x, y) [B, N]
    as float32 [B, N, 3], exact zeros where the pixel is dead (its low
    corner outside the image, or a zero-area support), the coverage mask
    [B, N] (the four weights' sum) and the live pixels [B, N]."""
    B, H, W, _ = im.shape
    xf, yf, x0, y0, x0c, x1c, y0c, y1c = _corners(x, y, H, W)
    inside = (x0 >= 0.0) & (y0 >= 0.0)
    live = inside & ((x1c - x0c) * (y1c - y0c) > 0)
    zero = torch.zeros((), device=x.device)
    wa = torch.where(inside, (x1c - xf) * (y1c - yf), zero)
    wb = torch.where(inside, (x1c - xf) * (yf - y0c), zero)
    wc = torch.where(inside, (xf - x0c) * (y1c - yf), zero)
    wd = torch.where(inside, (xf - x0c) * (yf - y0c), zero)
    yi, xi = _idx(y0c), _idx(x0c)
    x1i, y1i = torch.clamp(xi + 1, max=W - 1), torch.clamp(yi + 1, max=H - 1)
    flat = im.reshape(B, H * W, 3).to(torch.float32)

    def at(a, b):
        return torch.gather(flat, 1, (a * W + b)[..., None].expand(-1, -1, 3))

    out = (wa[..., None] * at(yi, xi) + wb[..., None] * at(y1i, xi)
           + wc[..., None] * at(yi, x1i) + wd[..., None] * at(y1i, x1i))
    out = torch.where(live[..., None], out, zero)
    mask = ((x1c - xf) * (y1c - yf) + (x1c - xf) * (yf - y0c)
            + (xf - x0c) * (y1c - yf) + (xf - x0c) * (yf - y0c))
    return out, mask, live


# -- meshes -------------------------------------------------------------------

def rigid_mesh(h, w, gh, gw, device):
    xs = torch.linspace(0.0, float(w), gw + 1, device=device)
    ys = torch.linspace(0.0, float(h), gh + 1, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], -1)


def normalize_mesh(mesh, h, w):
    """Pixels -> [-1, 1] by ``x * 2 / W - 1``: Python sizes divide in
    double precision, float32 extents in float32."""
    if isinstance(w, (int, float)) and isinstance(h, (int, float)):
        scale = const([2.0 / w, 2.0 / h], mesh.device)
    else:
        scale = const([np.float32(2.0) / np.float32(w),
                       np.float32(2.0) / np.float32(h)], mesh.device)
    return mesh * scale - 1.0


def denormalize_mesh(mesh, h, w):
    return (mesh + 1.0) * const([w / 2.0, h / 2.0], mesh.device)


def points(mesh):
    return mesh.reshape(*mesh.shape[:-3], -1, 2)


def h2mesh(H, rigid):
    """The rigid lattice pulled back through H [B, 3, 3]."""
    B = H.shape[0]
    pts = points(rigid).expand(B, -1, 2)
    homog = torch.cat([pts, torch.ones(*pts.shape[:-1], 1,
                                       device=pts.device)], -1)
    m = torch.einsum("bij,bpj->bpi", torch.linalg.inv(H), homog)
    return (m[..., :2] / m[..., 2:3]).reshape(B, *rigid.shape)


def spatial_motions(offset, mref, mtgt, img_h, img_w):
    """Per-view motions [B, GH+1, GW+1, 2] relative to the rigid lattice."""
    B = offset.shape[0]
    H_ref, H_tgt = bidirectional_homographies(offset.reshape(B, 4, 2),
                                              img_h, img_w)
    rigid = rigid_mesh(img_h, img_w, mref.shape[1] - 1, mref.shape[2] - 1,
                       offset.device)
    return (h2mesh(H_ref, rigid) + mref - rigid,
            h2mesh(H_tgt, rigid) + mtgt - rigid)


# -- thin-plate spline --------------------------------------------------------

def _rbf(d2):
    return d2 * torch.log(d2 + RBF_EPS)


def tps_params(source, target):
    """Coefficients [B, 2, P+3] of the spline source -> target ([B, P, 2])."""
    B, P, _ = source.shape
    kw = dict(dtype=source.dtype, device=source.device)
    p = torch.cat([torch.ones(B, P, 1, **kw), source], 2)
    diff = p[:, :, None, :] - p[:, None, :, :]
    A = torch.cat([torch.cat([p, _rbf(torch.sum(diff * diff, 3))], 2),
                   torch.cat([torch.zeros(B, 3, 3, **kw), p.transpose(1, 2)],
                             2)], 1)
    rhs = torch.cat([target, torch.zeros(B, 3, 2, **kw)], 1)
    return torch.linalg.solve(A, rhs).transpose(1, 2)


def spline_eval(T, source, gx, gy):
    """The spline at points gx, gy [B or 1, N]: (x, y) [B, N]."""
    ax = T[:, 0, 0:1] + T[:, 0, 1:2] * gx + T[:, 0, 2:3] * gy
    ay = T[:, 1, 0:1] + T[:, 1, 1:2] * gx + T[:, 1, 2:3] * gy
    for p in range(source.shape[1]):
        dx = gx - source[:, p, 0:1]
        dy = gy - source[:, p, 1:2]
        r = _rbf(dx * dx + dy * dy)
        ax = ax + T[:, 0, 3 + p:4 + p] * r
        ay = ay + T[:, 1, 3 + p:4 + p] * r
    return ax, ay


def transform_points(pts, source, target):
    """Points [B, N, 2] through the spline source -> target: [B, N, 2]."""
    x, y = spline_eval(tps_params(source, target), source, pts[..., 0],
                       pts[..., 1])
    return torch.stack([x, y], -1)


def grid_1d(n, span, device):
    """linspace(-1, 1, span) continued with its step to n points (a canvas
    padded past its true extent keeps the extent's normalization)."""
    if isinstance(span, (int, float)):
        step = 2.0 / (span - 1) if span > 1 else 0.0
    else:
        s = np.float32(span)
        step = (float(np.float32(2.0) / np.maximum(s - np.float32(1.0),
                                                   np.float32(1.0)))
                if s > 1 else 0.0)
    return -1.0 + step * torch.arange(n, dtype=torch.float32, device=device)


def canvas_coords(T, source, size, span):
    """The spline over the padded canvas ``size`` normalized by the true
    extent ``span``: (x, y) [B, oh*ow]."""
    oh, ow = size
    dev = T.device
    gx = grid_1d(ow, span[1], dev)[None, :].expand(oh, ow).reshape(1, -1)
    gy = grid_1d(oh, span[0], dev)[:, None].expand(oh, ow).reshape(1, -1)
    return spline_eval(T, source, gx.to(T.dtype), gy.to(T.dtype))


# -- fusion -------------------------------------------------------------------

def average_fusion(a, b, eps=1e-6):
    total = a + b + eps
    return a * (a / total) + b * (b / total)


def _gauss(k, sigma, device):
    x = np.arange(k, dtype=np.float64) - (k - 1) / 2.0
    g = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return torch.tensor((g / g.sum()).astype(np.float32), device=device)


def blur(x, k=21, sigma=20.0):
    """Separable Gaussian blur with reflect padding of [B, H, W]."""
    g = _gauss(k, sigma, x.device).to(x.dtype)
    y = F.pad(x[:, None], (k // 2,) * 4, mode="reflect")
    y = F.conv2d(y, g.reshape(1, 1, k, 1))
    return F.conv2d(y, g.reshape(1, 1, 1, k))[:, 0]


def _center(m):
    _, H, W = m.shape
    rows = torch.arange(H, dtype=m.dtype, device=m.device)[:, None]
    cols = torch.arange(W, dtype=m.dtype, device=m.device)[None, :]
    tot = m.sum(dim=(1, 2)) + 1e-8
    return torch.stack([(m * rows).sum(dim=(1, 2)),
                        (m * cols).sum(dim=(1, 2))], 1) / tot[:, None]


def linear_mask(ref_m, tgt_m):
    """The reference view's seam weight [B, H, W]."""
    c1 = _center(ref_m)
    vec = _center(tgt_m) - c1
    ovl = torch.round(ref_m * tgt_m)
    ref_only = ref_m - ovl
    _, H, W = ref_m.shape
    kw = dict(dtype=ref_m.dtype, device=ref_m.device)
    rows = torch.arange(H, **kw)[None, :, None]
    cols = torch.arange(W, **kw)[None, None, :]
    proj = ((rows - c1[:, 0, None, None]) * vec[:, 0, None, None]
            + (cols - c1[:, 1, None, None]) * vec[:, 1, None, None])
    on = ovl > 0
    big = torch.finfo(ref_m.dtype).max
    pmin = torch.where(on, proj, big).amin(dim=(1, 2), keepdim=True)
    pmax = torch.where(on, proj, -big).amax(dim=(1, 2), keepdim=True)
    om = torch.where(on, (proj - pmin) / (pmax - pmin + 1e-3),
                     torch.zeros((), device=ref_m.device))
    seam = ref_only + (1.0 - om) * ref_m
    return torch.clamp(blur(seam) * ref_m + ref_only, 0.0, 1.0)


def linear_fusion(ref, tgt, ref_m, tgt_m):
    m1 = linear_mask(ref_m, tgt_m)
    m2 = (1.0 - m1) * tgt_m
    return ref * m1[..., None] + tgt * m2[..., None]


# -- colour -------------------------------------------------------------------

def _q(x):
    return torch.clamp(torch.round(x), 0.0, 255.0).to(torch.uint8)


def bgr_to_i420(f):
    """float BGR [B, H, W, 3] (0..255, even sizes) -> packed I420
    [B, H*3//2, W] uint8 (BT.601 limited range, top-left chroma)."""
    b, g, r = f[..., 0], f[..., 1], f[..., 2]
    y = 16.0 + 0.256788 * r + 0.504129 * g + 0.097906 * b
    bd, gd, rd = b[:, ::2, ::2], g[:, ::2, ::2], r[:, ::2, ::2]
    u = 128.0 - 0.148223 * rd - 0.290993 * gd + 0.439216 * bd
    v = 128.0 + 0.439216 * rd - 0.367788 * gd - 0.071427 * bd
    B, H, W = y.shape
    return torch.cat([_q(y).reshape(B, -1), _q(u).reshape(B, -1),
                      _q(v).reshape(B, -1)], 1).reshape(B, H * 3 // 2, W)


def i420_to_bgr_u8(packed):
    """Packed I420 [B, H*3//2, W] uint8 -> uint8 BGR [B, H, W, 3]."""
    B, H15, W = packed.shape
    H = H15 * 2 // 3
    flat = packed.to(torch.float32).reshape(B, -1)
    n = H * W
    y = flat[:, :n].reshape(B, H, W)

    def up(c):
        return c.reshape(B, H // 2, 1, W // 2, 1).expand(
            B, H // 2, 2, W // 2, 2).reshape(B, H, W) - 128.0

    u, v = up(flat[:, n:n + n // 4]), up(flat[:, n + n // 4:])
    c = (y - 16.0) * 1.164383
    bgr = torch.stack([c + 2.017232 * u, c - 0.391762 * u - 0.812968 * v,
                       c + 1.596027 * v], -1)
    return torch.round(torch.clamp(bgr, 0.0, 255.0)).to(torch.uint8)


def model_input(hi, mh, mw):
    """uint8 frames [T, H, W, 3] -> [T, mh, mw, 3] in [-1, 1]: bilinear with
    half-pixel centres, antialiased when it shrinks."""
    x = hi.to(torch.float32)
    if tuple(x.shape[1:3]) != (mh, mw):
        x = F.interpolate(x.permute(0, 3, 1, 2), size=(mh, mw),
                          mode="bilinear", align_corners=False,
                          antialias=True).permute(0, 2, 3, 1)
    return x / 127.5 - 1.0


Size = Tuple[int, int]
