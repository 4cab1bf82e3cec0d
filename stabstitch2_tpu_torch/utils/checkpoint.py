"""Stitchers from trained weights (port of ``utils/checkpoint.py``, the
reference ``.pth`` part).

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

import os
from typing import Dict, Optional

import torch

TRIAD = ("spatial_warp.pth", "temporal_warp.pth", "smooth_warp.pth")
# parameters of reference submodules that its forward passes never use
UNUSED = {"temporal_warp.pth": ("feature_extractor_stage2.",),
          "smooth_warp.pth": ("MotionPre.embedding2.",)}


def load_reference_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """One reference ``.pth``: its state_dict (the ``{'model': sd}``
    wrapper unwrapped), without the parameters of unused submodules."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    sd = obj.get("model", obj) if isinstance(obj, dict) else obj
    drop = UNUSED.get(os.path.basename(path), ())
    return {k: v for k, v in sd.items()
            if not any(k.startswith(p) for p in drop)}


def stitcher_from_checkpoint(reference_pth_dir: Optional[str] = None,
                             **init_kwargs):
    """``init_stitcher(**init_kwargs)``, then the reference triad from
    ``reference_pth_dir`` loaded into its models (strictly: every key must
    match). Without a directory the random weights stay.

    Raises FileNotFoundError naming the missing files before the models
    are built.
    """
    from stabstitch2_tpu_torch.pipeline.stitcher import init_stitcher

    if reference_pth_dir:
        missing = [n for n in TRIAD
                   if not os.path.exists(os.path.join(reference_pth_dir, n))]
        if missing:
            raise FileNotFoundError(
                f"reference triad incomplete in {reference_pth_dir}: "
                f"missing {missing}")
    stitcher = init_stitcher(**init_kwargs)
    if reference_pth_dir:
        nets = (stitcher.spatial_net, stitcher.temporal_net,
                stitcher.smooth_net)
        for net, name in zip(nets, TRIAD):
            sd = load_reference_state_dict(os.path.join(reference_pth_dir,
                                                        name))
            net.load_state_dict(sd, strict=True)
    return stitcher
