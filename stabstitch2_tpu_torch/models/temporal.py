"""TemporalWarp network: inter-frame mesh motion (port of ``models/temporal.py``).

``features`` runs the trunk once per frame; ``motion_from_features`` takes
the cost volume at search range 3 (kernel K1) between neighbouring
frames' H/8 maps and regresses the mesh motion.

``compute_dtype`` runs the trunk and the head in that dtype, as the JAX
package's ``TemporalNet(dtype=...)``: the features stay in it, and return
to float32 before K1; the offsets return to float32.
"""

from __future__ import annotations

import torch
from torch import nn

from stabstitch2_tpu_torch.config import GRID_H, GRID_W, MODEL_H, MODEL_W
from stabstitch2_tpu_torch.models.backbone import ConvHead, MLPHead, ResNetStage1
from stabstitch2_tpu_torch.models.spatial import feature_sizes
from stabstitch2_tpu_torch.ops.corr_cuda import cost_volume_cuda


class TemporalNet(nn.Module):
    """Trunk + cost volume (49 ch) + conv/FC head -> mesh motion."""

    def __init__(self, model_h: int = MODEL_H, model_w: int = MODEL_W,
                 grid_h: int = GRID_H, grid_w: int = GRID_W,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.grid_h, self.grid_w = grid_h, grid_w
        (h8, w8), _ = feature_sizes(model_h, model_w)
        mesh_out = (grid_h + 1) * (grid_w + 1) * 2
        self.feature_extractor_stage1 = ResNetStage1(compute_dtype)
        self.regressNet2_part1 = ConvHead(49, (64, 128, 128, 256),
                                          compute_dtype)
        self.regressNet2_part2 = MLPHead(
            (256 * (h8 // 16) * (w8 // 16), 1024, 512, mesh_out),
            compute_dtype)

    def features(self, img: torch.Tensor) -> torch.Tensor:
        """Trunk features [B, H/8, W/8, 128] of frames [B, H, W, 3], in
        the compute dtype."""
        return self.feature_extractor_stage1(img)

    def motion_from_features(self, feat_prev: torch.Tensor,
                             feat_next: torch.Tensor) -> torch.Tensor:
        """Mesh motion [B, GH+1, GW+1, 2] warping frame t toward frame t-1."""
        corr = cost_volume_cuda(feat_prev.float().contiguous(),
                                feat_next.float().contiguous(), 3)
        offset = self.regressNet2_part2(self.regressNet2_part1(corr))
        return offset.float().reshape(-1, self.grid_h + 1, self.grid_w + 1, 2)

    def forward(self, img_prev: torch.Tensor, img_next: torch.Tensor):
        return self.motion_from_features(self.features(img_prev),
                                         self.features(img_next))

