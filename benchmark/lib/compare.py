"""The numbers that decide ``correct``: gaps between what the program gave
and what the plain reference gives.

- ``mesh_gap_px``: the largest distance, in model pixels, between a
  control point of the program's smooth meshes and the reference's, over
  every frame and view compared; the reference works the meshes out from
  the same frames and weights.
- ``frame_gap``: the mean absolute difference in levels of one emitted
  frame (all its planes) against the reference's, the largest over the
  frames compared; a frame of another shape reads infinite.
- ``canvas_rule_px``: the largest difference between the program's
  canvas (size, padding, anchor) and the canvas the rule gives for the
  program's own meshes: exact by construction.
- ``loss_gap``, ``grad_gap``, ``change_gap``: a training run's, in
  ``drivers/train.py``.
- ``canvas_outside_px``: how far the content of an emitted frame (the
  program's meshes at frame resolution) reaches outside its canvas.
"""

from __future__ import annotations

import math

import numpy as np


def mesh_gap(prog, ref) -> float:
    return float(np.abs(np.asarray(prog, np.float64)
                        - np.asarray(ref, np.float64)).max())


def frame_gap(prog: np.ndarray, ref: np.ndarray) -> float:
    """Largest per-frame mean |prog - ref| over frames [T, ...] (uint8)."""
    if prog.shape != ref.shape:
        return math.inf
    d = np.abs(prog.astype(np.int16) - ref.astype(np.int16))
    return float(d.reshape(d.shape[0], -1).mean(axis=1).max())


def canvas_rule(prog: dict, ref,
                keys=("out_h", "out_w", "pad_h", "pad_w", "x_min",
                      "y_min")) -> float:
    return max(abs(prog[k] - getattr(ref, k)) for k in keys)


def canvas_outside(canvas: dict, meshes) -> float:
    m = np.stack([np.asarray(x) for x in meshes])
    x0, y0 = canvas["x_min"], canvas["y_min"]
    return float(max(0.0, x0 - m[..., 0].min(), y0 - m[..., 1].min(),
                     m[..., 0].max() - (x0 + canvas["out_w"]),
                     m[..., 1].max() - (y0 + canvas["out_h"])))
