"""The losses of the three trainers (port of ``train/losses.py``).

Grid regularizers (the 4-D inter-grid loss, the reference's 5-D one with
its axis quirk, the intra-grid loss), the spatial photometric and
perceptual terms, the temporal photometric term, and the smooth stage's
brightness-balanced alignment, path smoothness and online-collaboration
terms. The metric scores read three of them. Images are NHWC, with the
warp mask as the last channel where the JAX function has it.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from stabstitch2_tpu_torch.config import MODEL_H, MODEL_W


def l_num_loss(a: torch.Tensor, b: torch.Tensor, l_num: int = 1
               ) -> torch.Tensor:
    """mean(|(a - b)^n|), the reference's generic distance."""
    return torch.mean(torch.abs((a - b) ** l_num))


def _edge_angle_loss(edges_a: torch.Tensor, edges_b: torch.Tensor,
                     dim: int = -1) -> torch.Tensor:
    """1 - cos of the angle between successive edges, the products summed
    over ``dim`` (the (x, y) axis, except in the reference's 5-D quirk)."""
    num = torch.sum(edges_a * edges_b, dim)
    den = (torch.sqrt(torch.sum(edges_a ** 2, dim))
           * torch.sqrt(torch.sum(edges_b ** 2, dim)))
    return 1.0 - num / den


def inter_grid_loss(mesh: torch.Tensor) -> torch.Tensor:
    """Angle preservation between successive mesh edges (1 - cos).

    mesh: [..., GH+1, GW+1, 2], any leading dims.
    """
    gh, gw = mesh.shape[-3] - 1, mesh.shape[-2] - 1
    w_edges = mesh[..., :, 0:gw, :] - mesh[..., :, 1:gw + 1, :]
    dw = _edge_angle_loss(w_edges[..., :, 0:gw - 1, :],
                          w_edges[..., :, 1:gw, :])
    dw = dw[..., 0:gh, :] + dw[..., 1:gh + 1, :]
    h_edges = mesh[..., 0:gh, :, :] - mesh[..., 1:gh + 1, :, :]
    dh = _edge_angle_loss(h_edges[..., 0:gh - 1, :, :],
                          h_edges[..., 1:gh, :, :])
    dh = dh[..., :, 0:gw] + dh[..., :, 1:gw + 1]
    return torch.mean(dw) + torch.mean(dh)


def inter_grid_loss_5d_ref(mesh: torch.Tensor) -> torch.Tensor:
    """Angle preservation between successive mesh edges (1 - cos), as the
    reference's smooth stage and distortion metric compute it on
    [B, T, GH+1, GW+1, 2]: it reduces over axis 3, the grid-column axis,
    not the (x, y) axis. The published numbers were made with that quirk,
    so it is kept."""
    gh, gw = mesh.shape[2] - 1, mesh.shape[3] - 1
    w_edges = mesh[:, :, :, 0:gw, :] - mesh[:, :, :, 1:gw + 1, :]
    dw = _edge_angle_loss(w_edges[:, :, :, 0:gw - 1, :],
                          w_edges[:, :, :, 1:gw, :], 3)   # [B, T, GH+1, 2]
    dw = dw[:, :, 0:gh, :] + dw[:, :, 1:gh + 1, :]

    h_edges = mesh[:, :, 0:gh, :, :] - mesh[:, :, 1:gh + 1, :, :]
    dh = _edge_angle_loss(h_edges[:, :, 0:gh - 1, :, :],
                          h_edges[:, :, 1:gh, :, :], 3)   # [B, T, GH-1, 2]
    dh = dh[:, :, :, 0:gw] + dh[:, :, :, 1:gw + 1]
    return torch.mean(dw) + torch.mean(dh)


def intra_grid_loss(mesh: torch.Tensor, model_h: int = MODEL_H,
                    model_w: int = MODEL_W) -> torch.Tensor:
    """Penalty on grid cells stretched beyond twice their nominal size."""
    gh, gw = mesh.shape[-3] - 1, mesh.shape[-2] - 1
    max_w = model_w / gw * 2.0
    max_h = model_h / gh * 2.0
    dx = mesh[..., :, 1:gw + 1, 0] - mesh[..., :, 0:gw, 0]
    dy = mesh[..., 1:gh + 1, :, 1] - mesh[..., 0:gh, :, 1]
    return (torch.mean(torch.clamp(dx - max_w, min=0.0))
            + torch.mean(torch.clamp(dy - max_h, min=0.0)))


def path_smoothness_loss(path: torch.Tensor,
                         weights: Sequence[float] = (0.9, 0.3, 0.1)
                         ) -> torch.Tensor:
    """Weighted L2 to the +-1/2/3 neighbours around each window centre.

    path: [B, T, GH+1, GW+1, 2] with T >= 7.
    """
    T = path.shape[1]
    mid = path[:, 3:T - 3]
    total = torch.zeros((), dtype=path.dtype, device=path.device)
    for off, w in ((3, weights[2]), (2, weights[1]), (1, weights[0])):
        left = path[:, 3 - off:T - 3 - off]
        right = path[:, 3 + off:T - 3 + off]
        total = total + (l_num_loss(left, mid, 2)
                         + l_num_loss(right, mid, 2)) * w
    return total


def _overlap(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The product of two warps' mask channels (the last), as [..., 1]."""
    return (a[..., 3] * b[..., 3])[..., None]


def spatial_photometric_loss(out_H_ref, out_H_tgt, out_tps_ref, out_tps_tgt
                             ) -> torch.Tensor:
    """3x the homography stage's + 1x the TPS stage's masked L1.

    Inputs: [B, H, W, 4] (3 image channels + the warp mask).
    """
    ov_h = _overlap(out_H_ref, out_H_tgt)
    l1 = l_num_loss(out_H_ref[..., :3] * ov_h, out_H_tgt[..., :3] * ov_h, 1)
    return 3.0 * l1 + tps_photometric_loss(out_tps_ref, out_tps_tgt)


def tps_photometric_loss(out_tps_ref, out_tps_tgt) -> torch.Tensor:
    """The TPS stage's masked L1, the second term of
    :func:`spatial_photometric_loss`."""
    ov_t = _overlap(out_tps_ref, out_tps_tgt)
    return l_num_loss(out_tps_ref[..., :3] * ov_t,
                      out_tps_tgt[..., :3] * ov_t, 1)


def perceptual_loss(vgg: Callable[[torch.Tensor], torch.Tensor],
                    out_H_ref, out_H_tgt, out_tps_ref, out_tps_tgt
                    ) -> torch.Tensor:
    """VGG relu3_2 masked L1, 3x the homography stage + 1x the TPS stage.

    ``vgg(img_255) -> [B, H/4, W/4, 256]``; the overlap masks are resized
    to the feature resolution with torch's bicubic (align_corners=False).
    """
    from stabstitch2_tpu_torch.ops.resize import resize_bicubic

    def term(ref, tgt):
        fh, fw = ref.shape[1] // 4, ref.shape[2] // 4
        ov = resize_bicubic(_overlap(ref, tgt), (fh, fw), align_corners=False)
        f_ref = vgg((ref[..., :3] + 1.0) * 127.5)
        f_tgt = vgg((tgt[..., :3] + 1.0) * 127.5)
        return l_num_loss(f_ref * ov, f_tgt * ov, 1)

    return (3.0 * term(out_H_ref, out_H_tgt)
            + 1.0 * term(out_tps_ref, out_tps_tgt))


def temporal_photometric_loss(img_prev: torch.Tensor,
                              warped_next: torch.Tensor) -> torch.Tensor:
    """L1 between frame t-1 and the TPS-warped frame t on the warp mask.

    img_prev: [B, H, W, 3]; warped_next: [B, H, W, 6] (3 warped image + 3
    mask channels).
    """
    warp, mask = warped_next[..., 0:3], warped_next[..., 3:6]
    return l_num_loss(img_prev * mask, warp * mask, 1)


def brightness_balanced_l1(wimg1, wimg2, overlap) -> torch.Tensor:
    """Masked L1 after matching the mean brightness in the overlap.

    wimg*: [B, H, W, 3]; overlap: [B, H, W, 1].
    """
    num = torch.sum(wimg1 * overlap - wimg2 * overlap, dim=(1, 2))
    den = torch.sum(overlap, dim=(1, 2))
    delta = (num / den)[:, None, None, :]
    return l_num_loss(wimg1 * overlap, (wimg2 + delta) * overlap, 1)


def online_collaboration_loss(paths: Sequence[torch.Tensor]) -> torch.Tensor:
    """Disagreement of overlapping shifted windows' paths, already re-based
    onto one trajectory origin."""
    total = torch.zeros((), dtype=paths[0].dtype, device=paths[0].device)
    for k in range(len(paths) - 1):
        total = total + l_num_loss(paths[k][:, 1:], paths[k + 1][:, :-1], 2)
    return total
