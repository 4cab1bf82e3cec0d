"""Control-point mesh helpers (port of ``stabstitch2_tpu/ops/mesh.py``).

Meshes are ``[..., grid_h+1, grid_w+1, 2]`` tensors in (x, y) order;
normalization is ``x * 2 / W - 1`` (not the align_corners convention).
"""

from __future__ import annotations

import numpy as np
import torch

from stabstitch2_tpu_torch.config import GRID_H, GRID_W
from stabstitch2_tpu_torch.utils.transfer import constant, shape_constant


def rigid_mesh(height: float, width: float, *, grid_h: int = GRID_H,
               grid_w: int = GRID_W, dtype=torch.float32,
               device=None) -> torch.Tensor:
    """The undeformed lattice over [0, W] x [0, H]: [grid_h+1, grid_w+1, 2]."""
    xs = torch.linspace(0.0, float(width), grid_w + 1, dtype=dtype,
                        device=device)
    ys = torch.linspace(0.0, float(height), grid_h + 1, dtype=dtype,
                        device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1)


def normalize_mesh(mesh: torch.Tensor, height, width) -> torch.Tensor:
    """Pixel coordinates -> [-1, 1] with ``x * 2 / W - 1``.

    Python numbers divide in double precision and round once; float32
    scalars (the compositor's true canvas extent) divide in float32. These
    are the JAX package's two cases, a static and a traced extent.
    """
    if isinstance(width, (int, float)) and isinstance(height, (int, float)):
        scale = _constant(height, width)([2.0 / width, 2.0 / height],
                                         mesh.dtype, mesh.device)
    else:
        scale = constant([np.float32(2.0) / np.float32(width),
                          np.float32(2.0) / np.float32(height)],
                         mesh.dtype, mesh.device)
    return mesh * scale - 1.0


def _constant(height, width):
    """Integer sizes (a model's, a feature map's) are few and fixed, so
    their constants are made once and kept (``shape_constant``, which a
    captured program may read); other extents (a canvas's) are not."""
    sized = isinstance(height, int) and isinstance(width, int)
    return shape_constant if sized else constant


def denormalize_mesh(mesh: torch.Tensor, height: float,
                     width: float) -> torch.Tensor:
    """Inverse of :func:`normalize_mesh`."""
    return (mesh + 1.0) * _constant(height, width)(
        [width / 2.0, height / 2.0], mesh.dtype, mesh.device)


def mesh_points(mesh: torch.Tensor) -> torch.Tensor:
    """Flatten the two lattice dims into one point dim: [..., P, 2]."""
    return mesh.reshape(*mesh.shape[:-3], -1, 2)


def points_mesh(points: torch.Tensor, *, grid_h: int = GRID_H,
                grid_w: int = GRID_W) -> torch.Tensor:
    """Inverse of :func:`mesh_points`."""
    return points.reshape(*points.shape[:-2], grid_h + 1, grid_w + 1, 2)


def apply_homography_points(H: torch.Tensor,
                            points: torch.Tensor) -> torch.Tensor:
    """H: [B, 3, 3]; points: [B, P, 2] -> [B, P, 2] with perspective division."""
    ones = torch.ones(*points.shape[:-1], 1, dtype=points.dtype,
                      device=points.device)
    homog = torch.cat([points, ones], dim=-1)
    mapped = torch.einsum("bij,bpj->bpi", H, homog)
    return mapped[..., :2] / mapped[..., 2:3]


def h2mesh(H: torch.Tensor, rigid: torch.Tensor) -> torch.Tensor:
    """Pull the rigid lattice back through H (apply H^-1 to its points).

    H: [B, 3, 3]; rigid: [GH+1, GW+1, 2] or batched. Returns [B, GH+1, GW+1, 2].
    """
    B = H.shape[0]
    if rigid.dim() == 3:
        rigid = rigid.expand(B, *rigid.shape)
    gh, gw = rigid.shape[-3] - 1, rigid.shape[-2] - 1
    mapped = apply_homography_points(torch.linalg.inv_ex(H).inverse,
                                     mesh_points(rigid))
    return points_mesh(mapped, grid_h=gh, grid_w=gw)
