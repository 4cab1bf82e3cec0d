"""Temporal-motion transport into the stitched frame (port of ``pipeline/transport.py``).

For t >= 1: tsmesh_t = TPS_point(norm(rigid + tmotion_t); rigid ->
norm(smesh_{t-1})), tsmotion_t = denorm(tsmesh_t) - smesh_t; tsmotion_0 = 0.
The spline's source is always the rigid lattice, so the system is
factored once for all frames. :func:`transport` is one step for any
batch of frames (the online stitcher's two views of one frame).
"""

from __future__ import annotations

from typing import Tuple

import torch

from stabstitch2_tpu_torch.ops.mesh import (
    denormalize_mesh,
    mesh_points,
    normalize_mesh,
    points_mesh,
    rigid_mesh,
)
from stabstitch2_tpu_torch.ops.tps import (
    tps_params_shared_source,
    tps_transform_points,
)


def _rigid(like: torch.Tensor, img_h: int, img_w: int) -> torch.Tensor:
    return rigid_mesh(img_h, img_w, grid_h=like.shape[1] - 1,
                      grid_w=like.shape[2] - 1, dtype=like.dtype,
                      device=like.device)


def transport(tmotion: torch.Tensor, smotion_prev: torch.Tensor,
              smotion: torch.Tensor, img_h: int, img_w: int) -> torch.Tensor:
    """Temporal motions [N, GH+1, GW+1, 2] into the stitched frame: each
    tmesh = rigid + tmotion is mapped through the spline rigid ->
    rigid + smotion_prev, and rigid + smotion is subtracted."""
    rigid = _rigid(tmotion, img_h, img_w)
    norm_rigid_pts = mesh_points(normalize_mesh(rigid, img_h, img_w))
    smesh = rigid[None] + smotion
    targets = mesh_points(normalize_mesh(rigid[None] + smotion_prev,
                                         img_h, img_w))
    points = mesh_points(normalize_mesh(rigid[None] + tmotion, img_h, img_w))
    Tc = tps_params_shared_source(norm_rigid_pts, targets)
    src_b = norm_rigid_pts[None].expand(targets.shape)
    tsmesh = tps_transform_points(points, src_b, targets, T=Tc)
    tsmesh = points_mesh(tsmesh, grid_h=tmotion.shape[1] - 1,
                         grid_w=tmotion.shape[2] - 1)
    return denormalize_mesh(tsmesh, img_h, img_w) - smesh


def transport_temporal_motion(tmotion: torch.Tensor, smotion: torch.Tensor,
                              img_h: int, img_w: int) -> torch.Tensor:
    """tmotion, smotion: [T, GH+1, GW+1, 2] for one view -> tsmotion [T, ...]."""
    rest = transport(tmotion[1:], smotion[:-1], smotion[1:], img_h, img_w)
    return torch.cat([torch.zeros_like(rest[:1]), rest], 0)


def stitched_meshes(smotion: torch.Tensor, img_h: int,
                    img_w: int) -> torch.Tensor:
    """smesh = rigid + smotion, batched over frames."""
    return _rigid(smotion, img_h, img_w)[None] + smotion


def transport_both_views(tmotion1, smotion1, tmotion2, smotion2,
                         img_h: int, img_w: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    return (transport_temporal_motion(tmotion1, smotion1, img_h, img_w),
            transport_temporal_motion(tmotion2, smotion2, img_h, img_w))
