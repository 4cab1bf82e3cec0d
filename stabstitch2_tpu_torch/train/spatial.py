"""SpatialWarp trainer (port of ``train/spatial.py``).

The reference's training wrapper (``build_model``): augment the pair, run
the net, warp both full-resolution images (and their coverage masks) by
the bidirectional homographies and by the TPS meshes, and score the
overlaps; the tra recipe adds the frozen VGG-19 perceptual term. The TPS
warps take the coordinate kernel K3 on the card, through
``ops/tps_coords_cuda.py:TpsCoords``, so the photometric terms reach the
mesh heads.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from stabstitch2_tpu_torch.config import SpatialTrainConfig
from stabstitch2_tpu_torch.models import SpatialNet, VGG19Features
from stabstitch2_tpu_torch.models.spatial import bidirectional_homographies
from stabstitch2_tpu_torch.ops.homography import (homo_warp_with_mask,
                                                  normalize_homography)
from stabstitch2_tpu_torch.ops.mesh import (h2mesh, mesh_points,
                                            normalize_mesh, rigid_mesh)
from stabstitch2_tpu_torch.ops.tps import tps_warp_with_mask
from stabstitch2_tpu_torch.train import losses
from stabstitch2_tpu_torch.train.common import (AugFactors, Optimizer,
                                                apply_aug, device_factors,
                                                normalize_images, run_step,
                                                step_body)


def with_mask(warped: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The reference's image + mask layout [B, H, W, C + 1]."""
    return torch.cat([warped, mask[..., None]], -1)


def spatial_train_outputs(net: SpatialNet, img1: torch.Tensor,
                          img2: torch.Tensor,
                          factors: Optional[AugFactors] = None
                          ) -> Dict[str, torch.Tensor]:
    """The warps and meshes the loss reads (the reference ``build_model``).

    img*: [B, H, W, 3], uint8 or [-1, 1]; ``factors`` augments the net's
    input (the warps sample the unaugmented images). BatchNorm follows the
    net's mode.
    """
    img1, img2 = normalize_images(img1), normalize_images(img2)
    B, H, W, _ = img1.shape
    a1, a2 = apply_aug(img1, img2, factors) if factors is not None else (
        img1, img2)
    offset_1, mesh_motion_ref, mesh_motion_tgt = net(a1, a2)

    H_ref, H_tgt = bidirectional_homographies(offset_1.reshape(B, 4, 2), H, W)
    out_H_ref = with_mask(*homo_warp_with_mask(
        img1, normalize_homography(H_ref, H, W), (H, W)))
    out_H_tgt = with_mask(*homo_warp_with_mask(
        img2, normalize_homography(H_tgt, H, W), (H, W)))

    rigid = rigid_mesh(H, W, grid_h=net.grid_h, grid_w=net.grid_w,
                       dtype=img1.dtype, device=img1.device)
    mesh_ref = h2mesh(H_ref, rigid) + mesh_motion_ref
    mesh_tgt = h2mesh(H_tgt, rigid) + mesh_motion_tgt
    norm_rigid = mesh_points(normalize_mesh(rigid, H, W))
    norm_rigid = norm_rigid[None].expand(B, *norm_rigid.shape)
    out_tps_ref = with_mask(*tps_warp_with_mask(
        img1, mesh_points(normalize_mesh(mesh_ref, H, W)), norm_rigid,
        (H, W)))
    out_tps_tgt = with_mask(*tps_warp_with_mask(
        img2, mesh_points(normalize_mesh(mesh_tgt, H, W)), norm_rigid,
        (H, W)))
    return {"output_H_ref": out_H_ref, "output_H_tgt": out_H_tgt,
            "output_tps_ref": out_tps_ref, "output_tps_tgt": out_tps_tgt,
            "mesh_ref": mesh_ref, "mesh_tgt": mesh_tgt, "mesh_rigid": rigid}


def spatial_loss_fn(net: SpatialNet, img1, img2, factors: Optional[AugFactors],
                    cfg: SpatialTrainConfig,
                    vgg: Optional[VGG19Features] = None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The recipe's total loss and its terms (as tensors)."""
    out = spatial_train_outputs(net, img1, img2, factors)
    overlap = losses.spatial_photometric_loss(
        out["output_H_ref"], out["output_H_tgt"],
        out["output_tps_ref"], out["output_tps_tgt"])
    gw = cfg.grid_weight
    nonoverlap = (gw * losses.inter_grid_loss(out["mesh_ref"])
                  + gw * losses.intra_grid_loss(out["mesh_ref"])
                  + gw * losses.inter_grid_loss(out["mesh_tgt"])
                  + gw * losses.intra_grid_loss(out["mesh_tgt"]))
    total = overlap + nonoverlap
    metrics = {"overlap": overlap, "nonoverlap": nonoverlap}
    if cfg.perception_weight > 0.0 and vgg is not None:
        perc = losses.perceptual_loss(vgg, out["output_H_ref"],
                                      out["output_H_tgt"],
                                      out["output_tps_ref"],
                                      out["output_tps_tgt"])
        total = total + cfg.perception_weight * perc
        metrics["perception"] = perc
    metrics["total"] = total
    return total, metrics


def spatial_step_body(net: SpatialNet, opt: Optimizer,
                      cfg: SpatialTrainConfig,
                      vgg: Optional[VGG19Features] = None):
    """The device body of a step (``train/common.py:step_body``):
    ``body(img1, img2, *factors)`` -> the loss terms, detached; the four
    factors as device tensors, or none."""
    return step_body(opt, lambda img1, img2, *factors: spatial_loss_fn(
        net, img1, img2, factors or None, cfg, vgg))


def spatial_train_step(net: SpatialNet, opt: Optimizer, img1, img2,
                       factors: Optional[AugFactors], cfg: SpatialTrainConfig,
                       vgg: Optional[VGG19Features] = None, graphs=None
                       ) -> Dict[str, torch.Tensor]:
    """One optimizer step in train mode (BatchNorm statistics move): the
    factors copied to the images' device, :func:`spatial_step_body` run
    directly or through ``graphs`` (``train/common.py:run_step``), the step
    counted. Returns the loss terms, detached, on the device."""
    net.train()
    inputs = (img1, img2) + device_factors(factors, img1.device)
    return run_step(graphs, "spatial", spatial_step_body(net, opt, cfg, vgg),
                    inputs, (net, vgg), opt)


def frozen_vgg(state_dict, device) -> VGG19Features:
    """The perceptual loss's VGG-19 trunk: eval mode, no parameter grads
    (gradients still flow to its input)."""
    vgg = VGG19Features()
    vgg.load_state_dict(state_dict, strict=True)
    vgg.to(device).eval()
    for p in vgg.parameters():
        p.requires_grad_(False)
    return vgg
