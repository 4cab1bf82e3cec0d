"""Sliding-window smoothing in one batch (port of ``pipeline/smoothing.py``).

Window k covers frames [k, k+window); each window's transported motion
starts at zero; the first window is kept whole and every later window
contributes its last frame.
"""

from __future__ import annotations

from typing import Dict

import torch

from stabstitch2_tpu_torch.models.smooth import SmoothNet, smooth_outputs


def window_indices(num_frames: int, window: int, device=None) -> torch.Tensor:
    """[num_windows, window] gather indices: row k = k .. k+window-1."""
    base = torch.arange(num_frames - window + 1, device=device)[:, None]
    return base + torch.arange(window, device=device)[None, :]


@torch.no_grad()
def smooth_all_windows(net: SmoothNet, smesh1, smesh2, tsmotion1, tsmotion2,
                       window: int = 7, chunk: int = 64
                       ) -> Dict[str, torch.Tensor]:
    """Run SmoothNet on every window; returns per-frame [T, GH+1, GW+1, 2]
    smooth/ori meshes of both views and the per-window paths."""
    T = smesh1.shape[0]
    if T < window:
        raise ValueError(f"need at least {window} frames, got {T}")
    idx = window_indices(T, window, smesh1.device)
    w_smesh1, w_smesh2 = smesh1[idx], smesh2[idx]
    w_ts1, w_ts2 = tsmotion1[idx].clone(), tsmotion2[idx].clone()
    w_ts1[:, 0] = 0.0
    w_ts2[:, 0] = 0.0

    outs = []
    for s in range(0, idx.shape[0], chunk):
        e = min(s + chunk, idx.shape[0])
        outs.append(smooth_outputs(net(w_smesh1[s:e], w_smesh2[s:e],
                                       w_ts1[s:e], w_ts2[s:e])))
    d = {k: torch.cat([o[k] for o in outs], 0) for k in outs[0]}

    def assemble(per_window):   # [nw, window, ...] -> [T, ...]
        return torch.cat([per_window[0], per_window[1:, -1]], 0)

    return {
        "smooth_mesh1": assemble(d["smooth_mesh1"]),
        "smooth_mesh2": assemble(d["smooth_mesh2"]),
        "ori_mesh1": assemble(d["ori_mesh1"]),
        "ori_mesh2": assemble(d["ori_mesh2"]),
        "win_ori_path1": d["ori_path1"],
        "win_ori_path2": d["ori_path2"],
        "win_smooth_path1": d["smooth_path1"],
        "win_smooth_path2": d["smooth_path2"],
    }
