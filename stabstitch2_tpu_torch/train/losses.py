"""Grid and path losses (port of part of ``train/losses.py``).

Only the three terms the metric scores read are here: the reference's 5-D
inter-grid loss (its axis quirk kept), the intra-grid loss and the path
smoothness. The trainers' other losses come with training.
"""

from __future__ import annotations

from typing import Sequence

import torch

from stabstitch2_tpu_torch.config import MODEL_H, MODEL_W


def l_num_loss(a: torch.Tensor, b: torch.Tensor, l_num: int = 1
               ) -> torch.Tensor:
    """mean(|(a - b)^n|), the reference's generic distance."""
    return torch.mean(torch.abs((a - b) ** l_num))


def inter_grid_loss_5d_ref(mesh: torch.Tensor) -> torch.Tensor:
    """Angle preservation between successive mesh edges (1 - cos), as the
    reference's smooth stage and distortion metric compute it on
    [B, T, GH+1, GW+1, 2]: it reduces over axis 3, the grid-column axis,
    not the (x, y) axis. The published numbers were made with that quirk,
    so it is kept."""
    gh, gw = mesh.shape[2] - 1, mesh.shape[3] - 1
    w_edges = mesh[:, :, :, 0:gw, :] - mesh[:, :, :, 1:gw + 1, :]
    num = torch.sum(w_edges[:, :, :, 0:gw - 1, :] * w_edges[:, :, :, 1:gw, :],
                    3)
    den = (torch.sqrt(torch.sum(w_edges[:, :, :, 0:gw - 1, :] ** 2, 3))
           * torch.sqrt(torch.sum(w_edges[:, :, :, 1:gw, :] ** 2, 3)))
    dw = 1.0 - num / den                       # [B, T, GH+1, 2]
    dw = dw[:, :, 0:gh, :] + dw[:, :, 1:gh + 1, :]

    h_edges = mesh[:, :, 0:gh, :, :] - mesh[:, :, 1:gh + 1, :, :]
    num = torch.sum(h_edges[:, :, 0:gh - 1, :, :] * h_edges[:, :, 1:gh, :, :],
                    3)
    den = (torch.sqrt(torch.sum(h_edges[:, :, 0:gh - 1, :, :] ** 2, 3))
           * torch.sqrt(torch.sum(h_edges[:, :, 1:gh, :, :] ** 2, 3)))
    dh = 1.0 - num / den                       # [B, T, GH-1, 2]
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
