"""SmoothWarp trainer, the six-term online-collaboration recipe (port of
``train/smooth.py``).

Per window (the reference's ``build_model``): transport the temporal
motions into the stitched frame, run SmoothNet, TPS-warp the window's last
images by the smoothed meshes (alignment term) and warp 1/4-resolution
dense smooth-path fields into the panorama (trajectory term). The loss
runs ``train_sqe`` shifted windows and re-bases the later ones' paths onto
the first's origin for the online-collaboration term. Each window makes
four K3 launches on the card (two image warps, two dense-path warps), all
through ``TpsCoords`` and its backward.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from stabstitch2_tpu_torch.config import SmoothTrainConfig
from stabstitch2_tpu_torch.models import SmoothNet
from stabstitch2_tpu_torch.models.smooth import smooth_outputs
from stabstitch2_tpu_torch.ops.mesh import mesh_points, normalize_mesh, rigid_mesh
from stabstitch2_tpu_torch.ops.resize import resize_bicubic
from stabstitch2_tpu_torch.ops.tps import tps_warp, tps_warp_with_mask
from stabstitch2_tpu_torch.pipeline.transport import transport
from stabstitch2_tpu_torch.train import losses
from stabstitch2_tpu_torch.train.common import (Optimizer, normalize_images,
                                                run_step, step_body)


def transport_window(tmotion: torch.Tensor, smotion: torch.Tensor,
                     img_h: int, img_w: int) -> torch.Tensor:
    """Transported motions of [B, T, GH+1, GW+1, 2] windows, frame 0 zero:
    the stitcher's one-step :func:`pipeline.transport.transport` over all
    B * (T - 1) frame pairs at once."""
    B, T, gh1, gw1, _ = tmotion.shape

    def flat(x):
        return x.reshape(B * (T - 1), gh1, gw1, 2)

    rest = transport(flat(tmotion[:, 1:]), flat(smotion[:, :-1]),
                     flat(smotion[:, 1:]), img_h, img_w)
    rest = rest.reshape(B, T - 1, gh1, gw1, 2)
    return torch.cat([torch.zeros_like(rest[:, :1]), rest], 1)


def smooth_train_outputs(net: SmoothNet, tmotion1, tmotion2, smotion1,
                         smotion2, img1, img2) -> Dict[str, torch.Tensor]:
    """One window's forward and loss tensors.

    tmotion*/smotion*: [B, T, GH+1, GW+1, 2]; img*: [B, T, H, W, 3] in
    [-1, 1].
    """
    B, T, gh1, gw1, _ = tmotion1.shape
    H, W = img1.shape[2], img1.shape[3]
    ts1 = transport_window(tmotion1, smotion1, H, W)
    ts2 = transport_window(tmotion2, smotion2, H, W)
    rigid = rigid_mesh(H, W, grid_h=gh1 - 1, grid_w=gw1 - 1,
                       dtype=smotion1.dtype, device=smotion1.device)
    out = smooth_outputs(net(rigid + smotion1, rigid + smotion2, ts1, ts2))
    # the warp actually applied: the stitched mesh minus the delta
    target_mesh1, target_mesh2 = out["smooth_mesh1"], out["smooth_mesh2"]
    norm_rigid = mesh_points(normalize_mesh(rigid, H, W))

    def warp_last(img, target_mesh):
        src = mesh_points(normalize_mesh(target_mesh[:, -1], H, W))
        tgt = norm_rigid[None].expand(src.shape)
        return tps_warp_with_mask(img[:, -1], src, tgt, (H, W))

    w1, m1 = warp_last(img1, target_mesh1)
    w2, m2 = warp_last(img2, target_mesh2)

    qh, qw = H // 4, W // 4

    def dense_paths(smooth_path, target_mesh):
        flat = smooth_path.reshape(B * T, gh1, gw1, 2)
        dense = resize_bicubic(flat, (qh, qw), align_corners=True)
        dense = torch.cat([dense, torch.ones_like(dense[..., :1])], -1)
        src = mesh_points(normalize_mesh(
            target_mesh.reshape(B * T, gh1, gw1, 2), H, W))
        tgt = norm_rigid[None].expand(src.shape)
        return tps_warp(dense, src, tgt, (qh, qw))

    d1 = dense_paths(out["smooth_path1"], target_mesh1)
    d2 = dense_paths(out["smooth_path2"], target_mesh2)
    return {
        "tsmotion1": ts1, "tsmotion2": ts2,
        "ori_path1": out["ori_path1"], "ori_path2": out["ori_path2"],
        "smooth_path1": out["smooth_path1"],
        "smooth_path2": out["smooth_path2"],
        "target_mesh1": target_mesh1, "target_mesh2": target_mesh2,
        "ori_mesh1": out["ori_mesh1"], "ori_mesh2": out["ori_mesh2"],
        "wimg1": w1, "wimg2": w2, "ovmask_img": (m1 * m2)[..., None],
        "dense_spath1": d1[..., :2], "dense_spath2": d2[..., :2],
        "ovmask_spath": (d1[..., 2] * d2[..., 2])[..., None],
    }


def smooth_loss_fn(net: SmoothNet, batch: Sequence[torch.Tensor],
                   cfg: SmoothTrainConfig
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The six terms over ``train_sqe`` shifted windows of ``frame_num``.

    batch: (tmotion1, tmotion2, smotion1, smotion2, img1, img2), each
    [B, L, ...] with L = frame_num + train_sqe - 1; images uint8 or
    [-1, 1].
    """
    tmotion1, tmotion2, smotion1, smotion2, img1, img2 = batch
    img1, img2 = normalize_images(img1), normalize_images(img2)
    F = cfg.frame_num
    terms: Dict[str, torch.Tensor] = {}
    paths1, paths2 = [], []
    for k in range(cfg.train_sqe):
        sl = slice(k, k + F)
        out = smooth_train_outputs(
            net, tmotion1[:, sl], tmotion2[:, sl], smotion1[:, sl],
            smotion2[:, sl], img1[:, sl], img2[:, sl])
        if k == 0:
            terms["data"] = (
                losses.l_num_loss(out["ori_path1"], out["smooth_path1"], 2)
                + losses.l_num_loss(out["ori_path2"], out["smooth_path2"], 2))
            terms["smoothness"] = (
                losses.path_smoothness_loss(out["smooth_path1"])
                + losses.path_smoothness_loss(out["smooth_path2"]))
            # the reference's 5-D grid loss, axis quirk kept
            terms["shape"] = (
                losses.inter_grid_loss_5d_ref(out["target_mesh1"])
                + losses.intra_grid_loss(out["target_mesh1"])
                + losses.inter_grid_loss_5d_ref(out["target_mesh2"])
                + losses.intra_grid_loss(out["target_mesh2"]))
            terms["trajectory"] = losses.l_num_loss(
                out["dense_spath1"] * out["ovmask_spath"],
                out["dense_spath2"] * out["ovmask_spath"], 1)
            terms["align"] = losses.brightness_balanced_l1(
                out["wimg1"], out["wimg2"], out["ovmask_img"])
            paths1.append(out["smooth_path1"])
            paths2.append(out["smooth_path2"])
            # window k is based at frame k: window 0's ori_path (the
            # cumulated transported motion) at index k is its offset
            base_path1, base_path2 = out["ori_path1"], out["ori_path2"]
        else:
            paths1.append(out["smooth_path1"] + base_path1[:, k][:, None])
            paths2.append(out["smooth_path2"] + base_path2[:, k][:, None])
    terms["online"] = (losses.online_collaboration_loss(paths1)
                       + losses.online_collaboration_loss(paths2))
    total = (cfg.data_weight * terms["data"]
             + cfg.smooth_weight * terms["smoothness"]
             + cfg.shape_weight * terms["shape"]
             + cfg.trajectory_weight * terms["trajectory"]
             + cfg.online_weight * terms["online"]
             + cfg.align_weight * terms["align"])
    return total, {"total": total, **terms}


def smooth_step_body(net: SmoothNet, opt: Optimizer, cfg: SmoothTrainConfig):
    """The device body of a step (``train/common.py:step_body``):
    ``body(*batch)`` -> the loss terms, detached."""
    return step_body(opt, lambda *batch: smooth_loss_fn(net, batch, cfg))


def smooth_train_step(net: SmoothNet, opt: Optimizer,
                      batch: Sequence[torch.Tensor], cfg: SmoothTrainConfig,
                      graphs=None) -> Dict[str, torch.Tensor]:
    """One optimizer step: :func:`smooth_step_body` run directly or through
    ``graphs`` (``train/common.py:run_step``); the loss terms, detached."""
    net.train()
    return run_step(graphs, "smooth", smooth_step_body(net, opt, cfg),
                    tuple(batch), (net,), opt)
