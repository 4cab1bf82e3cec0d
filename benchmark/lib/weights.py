"""Random weights of the triad, made on the device from the seed.

One reference-keyed state_dict per net ('spatial', 'temporal', 'smooth'),
float32, in the distributions of the repository's random init: every
convolution and linear weight normal with variance gain / fan_in (gain 2
in the regression heads' convolutions, the ``*_part1*`` Sequentials, He;
1 elsewhere, LeCun), zero biases, BatchNorm at identity statistics. All
random leaves come from one ``torch.randn`` on the device's generator,
scaled by one product, and are handed out as views: a few large calls,
not one per leaf. The benchmark gives the same tensors to the program
(copied into its nets) and to the plain reference.

The configuration's ``weights`` entry scales the spread of two output
layers, the smoothing net's decoder and the homography head's last
layer: random, their outputs move the views by 26-94 and ~10 pixels, a
canvas of its own for every seed; scaled, by 0.5-2 pixels, so that every
seed composites onto the same canvas. Where it names a ``baseline`` (the
homography head's last bias), that bias is set, for all four corners,
to the camera baseline of the run's traffic (:func:`for_run`): the views
then lie side by side, as a trained model would place them, and LINEAR
fusion has a seam to find (with the views on top of each other its seam
direction is the direction between two nearly equal centres, and any
rounding turns it).
"""

from __future__ import annotations

from typing import Dict

import torch

from benchmark.reference import nets as N


def _skeletons(cfg: dict) -> Dict[str, torch.nn.Module]:
    mh, mw, gh, gw = (cfg["model_h"], cfg["model_w"], cfg["grid_h"],
                      cfg["grid_w"])
    with torch.device("meta"):
        return {"spatial": N.SpatialNet(mh, mw, gh, gw),
                "temporal": N.TemporalNet(mh, mw, gh, gw),
                "smooth": N.SmoothNet()}


def make_state_dicts(cfg: dict, seed: int, device, baseline_px: float = 0.0
                     ) -> Dict[str, Dict[str, torch.Tensor]]:
    device = torch.device(device)
    shaped = cfg.get("weights", {})
    scale = shaped.get("scale", {})
    bias = ({shaped["baseline"]: [baseline_px, 0.0] * 4}
            if "baseline" in shaped else {})
    leaves = []         # (net, key, shape, scale or None)
    for name, net in _skeletons(cfg).items():
        for key, t in net.state_dict().items():
            if key.endswith("weight") and t.dim() >= 2:
                gain = 2.0 if "_part1" in key else 1.0
                leaves.append((name, key, t.shape, t.dtype,
                               (gain / t[0].numel()) ** 0.5
                               * scale.get(f"{name}.{key}", 1.0)))
            else:
                leaves.append((name, key, t.shape, t.dtype, None))
    rand = [x for x in leaves if x[4] is not None]
    sizes = [int(torch.Size(x[2]).numel()) for x in rand]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    flat.mul_(torch.repeat_interleave(
        torch.tensor([x[4] for x in rand], device=device),
        torch.tensor(sizes, device=device)))
    parts = dict(zip(((x[0], x[1]) for x in rand), flat.split(sizes)))
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for name, key, shape, dtype, spread in leaves:
        if spread is not None:
            value = parts[(name, key)].view(shape)
        elif f"{name}.{key}" in bias:
            value = torch.tensor(bias[f"{name}.{key}"], dtype=dtype,
                                 device=device).view(shape)
        elif key.endswith(("running_var", ".weight")):
            value = torch.ones(shape, dtype=dtype, device=device)
        else:       # biases, running means, num_batches_tracked
            value = torch.zeros(shape, dtype=dtype, device=device)
        out.setdefault(name, {})[key] = value
    return out



def for_run(run) -> Dict[str, Dict[str, torch.Tensor]]:
    """The state_dicts of a run: its configuration's, from its seed, the
    baseline that of its traffic (view k + 1 lies ``1 - overlap`` of a
    view to the right of view k, so the corners move left by as much, in
    model pixels)."""
    return make_state_dicts(run.cfg, run.seed, run.device,
                            -(1.0 - run.mix["overlap"]) * run.cfg["model_w"])
