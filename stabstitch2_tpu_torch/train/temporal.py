"""TemporalWarp trainer (port of ``train/temporal.py``).

The reference's training wrapper (``build_model``): augment the pair,
predict the mesh motion of frame t toward frame t-1, TPS-warp frame t
(with a 3-channel coverage mask; K3 and its backward on the card) and
compare it with frame t-1 on the mask; grid regularizers at weight 5.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from stabstitch2_tpu_torch.config import TemporalTrainConfig
from stabstitch2_tpu_torch.models import TemporalNet
from stabstitch2_tpu_torch.ops.mesh import mesh_points, normalize_mesh, rigid_mesh
from stabstitch2_tpu_torch.ops.tps import tps_warp_with_mask
from stabstitch2_tpu_torch.train import losses
from stabstitch2_tpu_torch.train.common import (AugFactors, Optimizer,
                                                apply_aug, device_factors,
                                                normalize_images, run_step,
                                                step_body)


def temporal_train_outputs(net: TemporalNet, img_prev: torch.Tensor,
                           img_next: torch.Tensor,
                           factors: Optional[AugFactors] = None
                           ) -> Dict[str, torch.Tensor]:
    """The warped frame t [B, H, W, 6] (image + 3 mask channels), its mesh
    and motion."""
    img_prev, img_next = normalize_images(img_prev), normalize_images(img_next)
    B, H, W, _ = img_prev.shape
    a1, a2 = apply_aug(img_prev, img_next, factors) if factors is not None \
        else (img_prev, img_next)
    motion = net(a1, a2)
    rigid = rigid_mesh(H, W, grid_h=net.grid_h, grid_w=net.grid_w,
                       dtype=img_prev.dtype, device=img_prev.device)
    mesh = rigid[None] + motion
    norm_rigid = mesh_points(normalize_mesh(rigid, H, W))
    norm_rigid = norm_rigid[None].expand(B, *norm_rigid.shape)
    w, m = tps_warp_with_mask(img_next, mesh_points(normalize_mesh(mesh, H, W)),
                              norm_rigid, (H, W))
    warped = torch.cat([w, m[..., None].expand(w.shape)], -1)
    return {"output_mesh": warped, "mesh": mesh, "motion": motion}


def temporal_loss_fn(net: TemporalNet, img_prev, img_next,
                     factors: Optional[AugFactors], cfg: TemporalTrainConfig
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    img_prev = normalize_images(img_prev)
    out = temporal_train_outputs(net, img_prev, img_next, factors)
    overlap = losses.temporal_photometric_loss(img_prev, out["output_mesh"])
    gw = cfg.grid_weight
    nonoverlap = (gw * losses.inter_grid_loss(out["mesh"])
                  + gw * losses.intra_grid_loss(out["mesh"]))
    total = overlap + nonoverlap
    return total, {"overlap": overlap, "nonoverlap": nonoverlap,
                   "total": total}


def temporal_step_body(net: TemporalNet, opt: Optimizer,
                       cfg: TemporalTrainConfig):
    """The device body of a step (``train/common.py:step_body``):
    ``body(img_prev, img_next, *factors)`` -> the loss terms, detached."""
    return step_body(opt, lambda prev, nxt, *factors: temporal_loss_fn(
        net, prev, nxt, factors or None, cfg))


def temporal_train_step(net: TemporalNet, opt: Optimizer, img_prev, img_next,
                        factors: Optional[AugFactors],
                        cfg: TemporalTrainConfig, graphs=None
                        ) -> Dict[str, torch.Tensor]:
    """One optimizer step in train mode: :func:`temporal_step_body` run
    directly or through ``graphs`` (``train/common.py:run_step``); the
    loss terms, detached."""
    net.train()
    inputs = (img_prev, img_next) + device_factors(factors, img_prev.device)
    return run_step(graphs, "temporal", temporal_step_body(net, opt, cfg),
                    inputs, (net,), opt)
