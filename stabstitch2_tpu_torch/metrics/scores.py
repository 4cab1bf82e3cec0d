"""Stability and distortion scores and the cross-window path continuation
(port of ``metrics/scores.py``; the reference's ``test_metric_ssd.py``).

- Path continuation: window 0 gives its whole trajectory; each later
  window k appends ori[t] = ori[t-1] + (win_ori[k][-1] - win_ori[k][-2])
  and smooth[t] = ori[t] + (win_smooth[k][-1] - win_ori[k][-1]).
- Stability: the 0.9/0.3/0.1-weighted neighbour L2 of the continued
  smooth path (view 2), the term the smooth trainer optimizes.
- Distortion: the maximum over frames of the reference's 5-D inter-grid
  loss plus the intra-grid loss of each frame's smooth mesh (view 2).

The ``_masked`` forms score the first ``n_valid`` frames of a longer
array (a padded batch), equal to the scores of the slice, with the count
kept on the device (:func:`stability_distortion` is the metric program's
use of them).
"""

from __future__ import annotations

from typing import Tuple

import torch

from stabstitch2_tpu_torch.train.losses import (inter_grid_loss_5d_ref,
                                                intra_grid_loss,
                                                path_smoothness_loss)


def continue_paths(win_ori: torch.Tensor, win_smooth: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """win_*: [num_windows, window, GH+1, GW+1, 2] -> paths [T, ...]."""
    ori_head = win_ori[0]
    deltas = win_ori[1:, -1] - win_ori[1:, -2]
    ori_tail = ori_head[-1][None] + torch.cumsum(deltas, dim=0)
    ori = torch.cat([ori_head, ori_tail], dim=0)
    smooth_tail = ori_tail + (win_smooth[1:, -1] - win_ori[1:, -1])
    smooth = torch.cat([win_smooth[0], smooth_tail], dim=0)
    return ori, smooth


def stability_score(path: torch.Tensor) -> torch.Tensor:
    """Weighted neighbour-L2 smoothness of path [T, GH+1, GW+1, 2], T >= 7
    (the smooth trainer's path term, so the two cannot drift apart)."""
    return path_smoothness_loss(path[None])


def distortion_per_frame(mesh_seq: torch.Tensor) -> torch.Tensor:
    """Inter- plus intra-grid loss of each frame: [T, GH+1, GW+1, 2] -> [T]."""
    def one(m):
        mm = m[None, None]
        return inter_grid_loss_5d_ref(mm) + intra_grid_loss(mm)

    return torch.vmap(one)(mesh_seq)


def distortion_score(mesh_seq: torch.Tensor) -> torch.Tensor:
    """The largest per-frame distortion of [T, GH+1, GW+1, 2]."""
    return torch.max(distortion_per_frame(mesh_seq))


def stability_score_masked(path: torch.Tensor, n_valid) -> torch.Tensor:
    """``stability_score(path[:n_valid])`` on the whole array [Tp, ...]
    (Tp >= n_valid >= 7): the same recurrence, averaged over the
    n_valid - 6 true centres only.

    ``n_valid`` is an int or a 0-dim integer tensor on the path's device.
    Its value is never read on the host: the denominator
    ``max(n_valid - 6, 1) * numel`` is computed on the device in the
    path's dtype, as the JAX package computes it from a traced count, so a
    captured program (``utils/graphs.py``) serves every count."""
    Tp = path.shape[0]
    if not torch.is_tensor(n_valid):
        n_valid = torch.full((), n_valid, dtype=torch.int32,
                             device=path.device)
    mid = path[3:Tp - 3]
    centers = torch.arange(Tp - 6, device=path.device)
    valid = (centers < n_valid - 6)[:, None, None, None]
    denom = (torch.clamp(n_valid - 6, min=1)
             * path[0].numel()).to(path.dtype)
    total = torch.zeros((), dtype=path.dtype, device=path.device)
    zero = torch.zeros((), dtype=path.dtype, device=path.device)
    for off, w in ((1, 0.9), (2, 0.3), (3, 0.1)):
        left = path[3 - off:Tp - 3 - off]
        right = path[3 + off:Tp - 3 + off]
        for nb in (left, right):
            sq = torch.where(valid, (nb - mid) ** 2, zero)
            total = total + w * (torch.sum(sq) / denom)
    return total


def distortion_score_masked(mesh_seq: torch.Tensor, n_valid) -> torch.Tensor:
    """``distortion_score(mesh_seq[:n_valid])`` on the whole array
    (``n_valid`` as in :func:`stability_score_masked`)."""
    per = distortion_per_frame(mesh_seq)
    keep = torch.arange(per.shape[0], device=per.device) < n_valid
    return torch.max(torch.where(keep, per, torch.full_like(per, -torch.inf)))


def stability_distortion(win_ori2: torch.Tensor, win_smooth2: torch.Tensor,
                         ori_mesh2: torch.Tensor, smooth_mesh2: torch.Tensor,
                         n_valid) -> Tuple[torch.Tensor, ...]:
    """Stability and distortion of view 2, before smoothing and after
    (stability_ori, stability, distortion_ori, distortion), from the
    smoothing's padded outputs (win_*: [Tp - window + 1, window, ...],
    meshes [Tp, ...]) and the true frame count ``n_valid`` (port of the
    JAX package's ``metrics/harness.py:_stability_distortion``)."""
    ori_path2, smooth_path2 = continue_paths(win_ori2, win_smooth2)
    return (stability_score_masked(ori_path2, n_valid),
            stability_score_masked(smooth_path2, n_valid),
            distortion_score_masked(ori_mesh2, n_valid),
            distortion_score_masked(smooth_mesh2, n_valid))
