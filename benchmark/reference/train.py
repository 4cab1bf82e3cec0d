"""The spatial training step in plain PyTorch, float32: what the first
steps of a training run should give.

A frozen copy of the published recipe (the reference's ``SpatialWarp``
training with the StabStitch-D weights of its loss): the pair scaled to
[-1, 1]; the net's input augmented by one brightness and one colour
factor per view, clamped to [-1, 1]; the net (``nets.SpatialNet``) with
BatchNorm in train mode (the batch's biased statistics); both views
warped at full resolution by the bidirectional homographies and by the
thin-plate splines of their meshes (rigid lattice plus the homography's
pull-back plus the mesh motion), each with its coverage mask (the
bilinear weights' sum); the loss

    3 * L1(H-warps on their joint mask) + L1(TPS-warps on theirs)
      + w * (inter + intra grid terms of both meshes)

(inter: 1 - cos between successive edges along rows and columns, each
summed over the two rows or columns an edge angle touches; intra: cells
stretched past twice their nominal size). Autograd gives the gradients;
they are clipped to a global norm of ``clip`` (scaled where the norm is
at least ``clip``, with no epsilon) and Adam (bias-corrected, ``eps``
outside the square root) takes its step at the rate ``lr``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from benchmark.reference import geometry as G
from benchmark.reference import nets as N


def coverage(x, y, H, W):
    """The warped all-ones channel at normalized (x, y): the sum of the
    four bilinear weights from the clamped corners."""
    xf, yf, _, _, x0c, x1c, y0c, y1c = G._corners(x, y, H, W)
    return ((x1c - xf) * (y1c - yf) + (x1c - xf) * (yf - y0c)
            + (xf - x0c) * (y1c - yf) + (xf - x0c) * (yf - y0c))


def warp_with_mask(im, x, y):
    """``im`` [B, H, W, C] sampled at (x, y) [B, H*W], with its coverage
    as a last channel: [B, H, W, C + 1]."""
    B, H, W, C = im.shape
    s = G.bilinear_sample(im, x, y).reshape(B, H, W, C)
    return torch.cat([s, coverage(x, y, H, W).reshape(B, H, W, 1)], -1)


def homo_coords(theta, H, W):
    """The output grid through normalized homographies [B, 3, 3]."""
    x = torch.linspace(-1.0, 1.0, W, device=theta.device)
    y = torch.linspace(-1.0, 1.0, H, device=theta.device)
    gy, gx = torch.meshgrid(y, x, indexing="ij")
    grid = torch.stack([gx.reshape(-1), gy.reshape(-1),
                        torch.ones(H * W, device=theta.device)], 0)
    T = torch.einsum("bij,jn->bin", theta, grid)
    t = T[:, 2]
    t = t + 1e-6 * (1.0 - (t.abs() >= 1e-7).to(t.dtype))
    return T[:, 0] / t, T[:, 1] / t


def tps_coords(mesh, rigid, H, W):
    """Every output pixel through the spline from the deformed mesh to the
    rigid lattice (both [B, GH+1, GW+1, 2] in pixels), normalized."""
    src = G.points(G.normalize_mesh(mesh, H, W))
    tgt = G.points(G.normalize_mesh(rigid, H, W))[None].expand_as(src)
    return G.canvas_coords(G.tps_params(src, tgt), src, (H, W), (H, W))


def _angle(a, b):
    num = torch.sum(a * b, -1)
    den = torch.sqrt(torch.sum(a * a, -1)) * torch.sqrt(torch.sum(b * b, -1))
    return 1.0 - num / den


def inter_grid(mesh):
    gh, gw = mesh.shape[-3] - 1, mesh.shape[-2] - 1
    we = mesh[..., :, :gw, :] - mesh[..., :, 1:, :]
    dw = _angle(we[..., :, :gw - 1, :], we[..., :, 1:, :])
    dw = dw[..., :gh, :] + dw[..., 1:, :]
    he = mesh[..., :gh, :, :] - mesh[..., 1:, :, :]
    dh = _angle(he[..., :gh - 1, :, :], he[..., 1:, :, :])
    dh = dh[..., :, :gw] + dh[..., :, 1:]
    return dw.mean() + dh.mean()


def intra_grid(mesh, H, W):
    gh, gw = mesh.shape[-3] - 1, mesh.shape[-2] - 1
    dx = mesh[..., :, 1:, 0] - mesh[..., :, :gw, 0]
    dy = mesh[..., 1:, :, 1] - mesh[..., :gh, :, 1]
    return (torch.clamp(dx - W / gw * 2.0, min=0.0).mean()
            + torch.clamp(dy - H / gh * 2.0, min=0.0).mean())


def masked_l1(a, b):
    ov = a[..., 3:4] * b[..., 3:4]
    return torch.mean(torch.abs(a[..., :3] * ov - b[..., :3] * ov))


def spatial_loss(net, img1, img2, factors, grid_weight: float):
    """The recipe's loss of one batch: uint8 [B, H, W, 3] pairs and the
    factors (brightness 1, brightness 2, colour 1 [3], colour 2 [3])."""
    i1 = img1.to(torch.float32) / 127.5 - 1.0
    i2 = img2.to(torch.float32) / 127.5 - 1.0
    b1, b2, c1, c2 = factors
    offset, mref, mtgt = net(torch.clamp(i1 * b1 * c1, -1.0, 1.0),
                             torch.clamp(i2 * b2 * c2, -1.0, 1.0))
    B, H, W, _ = i1.shape
    H_ref, H_tgt = G.bidirectional_homographies(offset.reshape(B, 4, 2), H, W)
    h_ref = warp_with_mask(i1, *homo_coords(
        G.normalize_homography(H_ref, H, W), H, W))
    h_tgt = warp_with_mask(i2, *homo_coords(
        G.normalize_homography(H_tgt, H, W), H, W))
    rigid = G.rigid_mesh(H, W, net.grid_h, net.grid_w, i1.device)
    mesh_ref = G.h2mesh(H_ref, rigid) + mref
    mesh_tgt = G.h2mesh(H_tgt, rigid) + mtgt
    t_ref = warp_with_mask(i1, *tps_coords(mesh_ref, rigid, H, W))
    t_tgt = warp_with_mask(i2, *tps_coords(mesh_tgt, rigid, H, W))
    grid = sum(inter_grid(m) + intra_grid(m, H, W)
               for m in (mesh_ref, mesh_tgt))
    return 3.0 * masked_l1(h_ref, h_tgt) + masked_l1(t_ref, t_tgt) \
        + grid_weight * grid


def train_steps(cfg: dict, recipe: dict, state_dict: Dict[str, torch.Tensor],
                batches: Sequence[Tuple], device, tf32: bool = False
                ) -> Dict[str, object]:
    """The recipe's first ``len(batches)`` steps from ``state_dict`` (the
    spatial net's, reference keys) on ``batches`` of (img1, img2,
    factors), uint8 pairs on ``device``. Returns the loss of each step,
    the gradient of every parameter as the first Adam update took it
    (clipped) and every parameter's change over all the steps. ``tf32``
    runs the matrix products and convolutions in TF32: the control."""
    N.float32()
    if tf32:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    net = N.SpatialNet(cfg["model_h"], cfg["model_w"], cfg["grid_h"],
                       cfg["grid_w"])
    net.load_state_dict(state_dict, strict=True)
    net.to(device).train()
    names = [n for n, _ in net.named_parameters()]
    params = [p for _, p in net.named_parameters()]
    start = [p.detach().clone() for p in params]
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    b1, b2 = recipe["b1"], recipe["b2"]
    losses: List[float] = []
    first: List[torch.Tensor] = []
    for t, (img1, img2, factors) in enumerate(batches, start=1):
        for p in params:
            p.grad = None
        loss = spatial_loss(net, img1, img2, factors, recipe["grid_weight"])
        loss.backward()
        losses.append(float(loss.detach()))
        with torch.no_grad():
            grads = [p.grad for p in params]
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            if float(norm) >= recipe["clip"]:
                grads = [g / norm * recipe["clip"] for g in grads]
            if t == 1:
                first = [g.clone() for g in grads]
            for p, g, mi, vi in zip(params, grads, m, v):
                mi.mul_(b1).add_(g, alpha=1.0 - b1)
                vi.mul_(b2).addcmul_(g, g, value=1.0 - b2)
                mhat = mi / (1.0 - b1 ** t)
                vhat = vi / (1.0 - b2 ** t)
                p.sub_(recipe["lr"] * mhat / (torch.sqrt(vhat) + recipe["eps"]))
    with torch.no_grad():
        return {"losses": losses,
                "grad_norm": {n: float(g.norm()) for n, g in zip(names, first)},
                "change_norm": {n: float((p - s).norm())
                                for n, p, s in zip(names, params, start)}}
