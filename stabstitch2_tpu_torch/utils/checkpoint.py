"""Training checkpoints and stitchers from trained weights (port of
``utils/checkpoint.py``, without orbax).

:class:`TrainCheckpointer` keeps a trainer's ``step_<N>.pth`` files, each
the reference trainers' wrapper ``{'model': state_dict, 'optimizer': ...,
'step': N, 'epoch': E}``, so a trained model loads wherever a reference
``.pth`` does (:func:`load_reference_state_dict`). The JAX package's orbax
format is not read or written: the card's machine has no ``tensorstore``.

The reference ships its three models as ``spatial_warp.pth``,
``temporal_warp.pth`` and ``smooth_warp.pth``, each a state_dict or a
``{'model': state_dict}`` wrapper. The port's modules carry the
reference's parameter names, so the state_dicts load as they are; only
the two submodules the reference defines and never calls are dropped
(the temporal net's ``feature_extractor_stage2``, SmoothNet's
``MotionPre.embedding2``). The orbax triad (``--ckpt_dir`` of the JAX
package) is not read here.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Any, Dict, Optional

import torch

TRIAD = ("spatial_warp.pth", "temporal_warp.pth", "smooth_warp.pth")
# parameters of reference submodules that its forward passes never use
UNUSED = {"temporal_warp.pth": ("feature_extractor_stage2.",),
          "smooth_warp.pth": ("MotionPre.embedding2.",)}


class TrainCheckpointer:
    """``step_<N>.pth`` files in one directory, the latest ``max_to_keep``
    kept; :meth:`restore` reads the latest."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.saved = []         # the paths this checkpointer wrote
        os.makedirs(self.directory, exist_ok=True)

    def steps(self):
        """The saved steps, ascending."""
        found = []
        for p in glob.glob(os.path.join(self.directory, "step_*.pth")):
            m = re.fullmatch(r"step_(\d+)\.pth", os.path.basename(p))
            if m:
                found.append(int(m.group(1)))
        return sorted(found)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pth")

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, payload: Dict[str, Any]) -> str:
        """Write ``payload`` as ``step_<step>.pth`` (through a temporary
        file, so a cut run leaves no partial checkpoint) and drop all but
        the latest ``max_to_keep``. Returns the path."""
        path = self.path(step)
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        self.saved.append(path)
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self.path(old))
        return path

    def restore(self, map_location="cpu") -> Optional[Dict[str, Any]]:
        """The latest payload, or None."""
        step = self.latest_step()
        if step is None:
            return None
        return torch.load(self.path(step), map_location=map_location,
                          weights_only=True)


def load_reference_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """One reference ``.pth``: its state_dict (the ``{'model': sd}``
    wrapper unwrapped), without the parameters of unused submodules."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    sd = obj.get("model", obj) if isinstance(obj, dict) else obj
    drop = UNUSED.get(os.path.basename(path), ())
    return {k: v for k, v in sd.items()
            if not any(k.startswith(p) for p in drop)}


def stitcher_from_checkpoint(reference_pth_dir: Optional[str] = None,
                             files=TRIAD, upload_mode: str = "bulk",
                             **init_kwargs):
    """``init_stitcher(**init_kwargs)`` with ``upload_mode`` ('bulk' or
    'stream', ``VideoStitcher.upload_mode``), then the reference triad from
    ``reference_pth_dir`` loaded into its models (strictly: every key must
    match); with ``n_devices`` in ``init_kwargs``, every device's replica
    holds the loaded weights. Without a directory the random weights stay.
    ``files`` names the ones to load, a part of :data:`TRIAD`
    (``export-motions`` needs only the spatial and temporal nets); the
    other nets keep the random weights.

    Raises FileNotFoundError naming the missing files before the models
    are built.
    """
    from stabstitch2_tpu_torch.pipeline.stitcher import init_stitcher

    if reference_pth_dir:
        missing = [n for n in files
                   if not os.path.exists(os.path.join(reference_pth_dir, n))]
        if missing:
            raise FileNotFoundError(
                f"reference triad incomplete in {reference_pth_dir}: "
                f"missing {missing}")
    stitcher = init_stitcher(**init_kwargs)
    stitcher.upload_mode = upload_mode
    if reference_pth_dir:
        nets = (stitcher.spatial_net, stitcher.temporal_net,
                stitcher.smooth_net)
        for net, name in zip(nets, TRIAD):
            if name not in files:
                continue
            sd = load_reference_state_dict(os.path.join(reference_pth_dir,
                                                        name))
            net.load_state_dict(sd, strict=True)
        stitcher.replicate()
    return stitcher
