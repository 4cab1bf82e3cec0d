"""SpatialWarp network: cross-view alignment (port of ``models/spatial.py``).

Stage 1: shared ResNet-18 features at H/16 -> CCL flow -> conv+FC head ->
4-point homography motion. Bidirectional split at 1/8 scale and a
homography warp of both H/8 maps toward the middle plane. Stage 2: two
cost volumes at search range 5 (kernel K1, ``ops/corr_cuda.py``) ->
per-view conv+FC heads -> residual TPS mesh motions.

``compute_dtype`` runs the trunk and the heads in that dtype (the JAX
package's ``SpatialNet(dtype=...)``); their results return to float32
where the JAX module casts them: before the CCL flow, ``offset_1``, the
H/8 features before the homography warp (so K1 always sees float32) and
the mesh offsets.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from stabstitch2_tpu_torch.config import GRID_H, GRID_W, MODEL_H, MODEL_W
from stabstitch2_tpu_torch.models.backbone import (
    ConvHead,
    MLPHead,
    ResNetStage1,
    ResNetStage2,
    conv_out,
)
from stabstitch2_tpu_torch.ops.corr_cuda import cost_volume_cuda
from stabstitch2_tpu_torch.ops.cost_volume import ccl_flow
from stabstitch2_tpu_torch.ops.dlt import solve_dlt
from stabstitch2_tpu_torch.ops.homography import homo_warp, normalize_homography
from stabstitch2_tpu_torch.ops.mesh import h2mesh, rigid_mesh
from stabstitch2_tpu_torch.utils.transfer import shape_constant


def feature_sizes(model_h: int, model_w: int):
    """(H/8, W/8) and (H/16, W/16) map sizes of the trunk at this input."""
    h8 = conv_out(conv_out(conv_out(model_h)))
    w8 = conv_out(conv_out(conv_out(model_w)))
    return (h8, w8), (conv_out(h8), conv_out(w8))


def corner_points(img_h: float, img_w: float, batch: int,
                  dtype=torch.float32, device=None) -> torch.Tensor:
    """The four image corners [B, 4, 2] in the reference's order TL, TR, BL, BR."""
    pts = shape_constant([[0.0, 0.0], [img_w, 0.0], [0.0, img_h],
                          [img_w, img_h]], dtype, device)
    return pts[None].expand(batch, 4, 2)


def bidirectional_homographies(H_motion: torch.Tensor, img_h: float,
                               img_w: float, scale: float = 1.0
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split a 4-point motion [B, 4, 2] into the (H_ref, H_tgt) pair."""
    B = H_motion.shape[0]
    src = corner_points(img_h, img_w, B, H_motion.dtype,
                        H_motion.device) / scale
    H = solve_dlt(src, src + H_motion / scale)
    H_tgt = solve_dlt(src, src + (H_motion / 2.0) / scale)
    H_ref = torch.einsum("bij,bjk->bik", torch.linalg.inv_ex(H).inverse, H_tgt)
    return H_ref, H_tgt


class SpatialNet(nn.Module):
    """(H_motion [B, 8], mesh_motion_ref, mesh_motion_tgt [B, GH+1, GW+1, 2])."""

    def __init__(self, model_h: int = MODEL_H, model_w: int = MODEL_W,
                 grid_h: int = GRID_H, grid_w: int = GRID_W,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.grid_h, self.grid_w = grid_h, grid_w
        (h8, w8), (h16, w16) = feature_sizes(model_h, model_w)
        mesh_out = (grid_h + 1) * (grid_w + 1) * 2
        dt = compute_dtype
        self.feature_extractor_stage1 = ResNetStage1(dt)
        self.feature_extractor_stage2 = ResNetStage2()
        self.regressNet1_part1 = ConvHead(2, (64, 128, 128), dt)
        self.regressNet1_part2 = MLPHead(
            (128 * (h16 // 8) * (w16 // 8), 512, 128, 8), dt)
        head_in = 256 * (h8 // 16) * (w8 // 16)
        self.regressNet2_part1_ref = ConvHead(121, (64, 128, 128, 256), dt)
        self.regressNet2_part2_ref = MLPHead((head_in, 1024, 512, mesh_out), dt)
        self.regressNet2_part1_tgt = ConvHead(121, (64, 128, 128, 256), dt)
        self.regressNet2_part2_tgt = MLPHead((head_in, 1024, 512, mesh_out), dt)

    def forward(self, img1: torch.Tensor, img2: torch.Tensor):
        B, img_h, img_w, _ = img1.shape
        f1_8 = self.feature_extractor_stage1(img1)
        f1_16 = self.feature_extractor_stage2(f1_8)
        f2_8 = self.feature_extractor_stage1(img2)
        f2_16 = self.feature_extractor_stage2(f2_8)

        # stage 1: global 4-point homography from the CCL flow
        flow = ccl_flow(f1_16.float(), f2_16.float())
        offset_1 = self.regressNet1_part2(self.regressNet1_part1(flow)).float()

        # bidirectional split at 1/8 scale and feature warp
        H_ref, H_tgt = bidirectional_homographies(
            offset_1.reshape(B, 4, 2), img_h, img_w, scale=8.0)
        h8, w8 = img_h // 8, img_w // 8
        wf1 = homo_warp(f1_8.float(), normalize_homography(H_ref, h8, w8),
                        (h8, w8))
        wf2 = homo_warp(f2_8.float(), normalize_homography(H_tgt, h8, w8),
                        (h8, w8))

        # stage 2: residual mesh motion per view (two K1 launches)
        corr_ref = cost_volume_cuda(wf1.contiguous(), wf2.contiguous(), 5)
        offset_ref = self.regressNet2_part2_ref(
            self.regressNet2_part1_ref(corr_ref))
        corr_tgt = cost_volume_cuda(wf2.contiguous(), wf1.contiguous(), 5)
        offset_tgt = self.regressNet2_part2_tgt(
            self.regressNet2_part1_tgt(corr_tgt))
        shape = (B, self.grid_h + 1, self.grid_w + 1, 2)
        return (offset_1, offset_ref.float().reshape(shape),
                offset_tgt.float().reshape(shape))


def spatial_motions(H_motion: torch.Tensor, mesh_motion_ref: torch.Tensor,
                    mesh_motion_tgt: torch.Tensor, img_h: float, img_w: float
                    ) -> Dict[str, torch.Tensor]:
    """Per-view meshes from the net outputs (reference ``build_SpatialNet``).

    Returns ``motion1``/``motion2`` [B, GH+1, GW+1, 2] relative to the rigid
    lattice, plus the meshes and homographies.
    """
    B = H_motion.shape[0]
    H_ref, H_tgt = bidirectional_homographies(H_motion.reshape(B, 4, 2),
                                              img_h, img_w)
    rigid = rigid_mesh(img_h, img_w, grid_h=mesh_motion_ref.shape[1] - 1,
                       grid_w=mesh_motion_ref.shape[2] - 1,
                       dtype=H_motion.dtype, device=H_motion.device)
    mesh_ref = h2mesh(H_ref, rigid) + mesh_motion_ref
    mesh_tgt = h2mesh(H_tgt, rigid) + mesh_motion_tgt
    return {"motion1": mesh_ref - rigid[None], "motion2": mesh_tgt - rigid[None],
            "mesh_ref": mesh_ref, "mesh_tgt": mesh_tgt, "mesh_rigid": rigid,
            "H_ref": H_ref, "H_tgt": H_tgt}
