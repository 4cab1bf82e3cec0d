"""Carry the JAX package's Flax variables into the port's modules.

:func:`from_jax_params` is the inverse of the JAX package's
``utils/torch_import.py:convert_state_dict``: it takes Flax variable trees
as nested dicts of numpy arrays (``params`` and ``batch_stats``) and
returns the ``state_dict``s of :class:`SpatialNet`, :class:`TemporalNet`
and :class:`SmoothNet`. Layouts: conv ``[kh, kw, I, O] -> [O, I, kh, kw]``,
conv3d ``[kt, kh, kw, I, O] -> [O, I, kt, kh, kw]``, dense ``[I, O] ->
[O, I]``, BatchNorm ``scale/bias -> weight/bias`` and
``batch_stats mean/var -> running_mean/running_var``.

:func:`flax_grads_to_named` maps a Flax gradient tree (the ``params``
structure) onto the port's parameter names, so gradients compare by name;
:func:`vgg19_mapping` maps ``VGG19Features`` with torchvision's keys.

The mapping tables are this package's own copy of the JAX package's.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# (torch prefix, flax path, kind) tables
# ---------------------------------------------------------------------------


def _block_entries(tp: str, fp: str):
    return [(f"{tp}.conv1", f"{fp}/conv1", "conv"),
            (f"{tp}.bn1", f"{fp}/bn1", "bn"),
            (f"{tp}.conv2", f"{fp}/conv2", "conv"),
            (f"{tp}.bn2", f"{fp}/bn2", "bn"),
            (f"{tp}.downsample.0", f"{fp}/downsample_conv", "conv"),
            (f"{tp}.downsample.1", f"{fp}/downsample_bn", "bn")]


def _stage1_entries(tp: str, fp: str):
    out = [(f"{tp}.0", f"{fp}/conv1", "conv"), (f"{tp}.1", f"{fp}/bn1", "bn")]
    for i in range(2):
        out += _block_entries(f"{tp}.4.{i}", f"{fp}/layer1_{i}")
        out += _block_entries(f"{tp}.5.{i}", f"{fp}/layer2_{i}")
    return out


def _conv_head_entries(tp: str, fp: str, num_stages: int):
    out = []
    for si in range(num_stages):
        out.append((f"{tp}.{5 * si}", f"{fp}/conv{si}_0", "conv"))
        out.append((f"{tp}.{5 * si + 2}", f"{fp}/conv{si}_1", "conv"))
    return out


def _mlp_entries(tp: str, fp: str, num_layers: int = 3):
    return [(f"{tp}.{2 * i}", f"{fp}/fc{i}", "linear")
            for i in range(num_layers)]


def spatial_mapping():
    m = _stage1_entries("feature_extractor_stage1", "stage1")
    for i in range(2):
        m += _block_entries(f"feature_extractor_stage2.0.{i}",
                            f"stage2/layer3_{i}")
    m += _conv_head_entries("regressNet1_part1", "regress1_conv", 3)
    m += _mlp_entries("regressNet1_part2", "regress1_fc")
    m += _conv_head_entries("regressNet2_part1_ref", "regress2_conv_ref", 4)
    m += _mlp_entries("regressNet2_part2_ref", "regress2_fc_ref")
    m += _conv_head_entries("regressNet2_part1_tgt", "regress2_conv_tgt", 4)
    m += _mlp_entries("regressNet2_part2_tgt", "regress2_fc_tgt")
    return m


def temporal_mapping():
    m = _stage1_entries("feature_extractor_stage1", "stage1")
    m += _conv_head_entries("regressNet2_part1", "regress_conv", 4)
    m += _mlp_entries("regressNet2_part2", "regress_fc")
    return m


def smooth_mapping():
    return [("MotionPre.embedding1.0", "motion_pre/embed_mesh_fc", "linear"),
            ("MotionPre.embedding3.0", "motion_pre/embed_flow_fc", "linear"),
            ("MotionPre.MotionConv3D.0", "motion_pre/conv3d_0", "conv3d"),
            ("MotionPre.MotionConv3D.2", "motion_pre/conv3d_1", "conv3d"),
            ("MotionPre.MotionConv3D.4", "motion_pre/conv3d_2", "conv3d"),
            ("MotionPre.decoding.0", "motion_pre/decode_fc", "linear")]


def vgg19_mapping():
    """torchvision ``vgg19.features`` indices -> ``VGG19Features`` names."""
    names = [(0, "conv1_1"), (2, "conv1_2"), (5, "conv2_1"), (7, "conv2_2"),
             (10, "conv3_1"), (12, "conv3_2")]
    return [(f"features.{i}", name, "conv") for i, name in names]


# ---------------------------------------------------------------------------
# conversion
# ---------------------------------------------------------------------------


def _get(tree: Mapping, path: str):
    node = tree
    for part in path.split("/"):
        if not isinstance(node, Mapping) or part not in node:
            return None
        node = node[part]
    return node


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


def flax_to_state_dict(variables: Mapping, mapping) -> Dict[str, torch.Tensor]:
    """Apply one mapping table to ``{'params': ..., 'batch_stats': ...}``.
    Without ``batch_stats`` a BatchNorm maps its weight and bias only."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd: Dict[str, torch.Tensor] = {}
    for tname, fpath, kind in mapping:
        node = _get(params, fpath)
        if node is None:
            continue  # e.g. the downsample of a stride-1 block
        if kind == "conv":
            sd[f"{tname}.weight"] = _t(np.transpose(node["kernel"], (3, 2, 0, 1)))
        elif kind == "conv3d":
            sd[f"{tname}.weight"] = _t(np.transpose(node["kernel"],
                                                    (4, 3, 0, 1, 2)))
        elif kind == "linear":
            sd[f"{tname}.weight"] = _t(np.asarray(node["kernel"]).T)
        elif kind == "bn":
            sd[f"{tname}.weight"] = _t(node["scale"])
            st = _get(stats, fpath)
            if st is not None:
                sd[f"{tname}.running_mean"] = _t(st["mean"])
                sd[f"{tname}.running_var"] = _t(st["var"])
                sd[f"{tname}.num_batches_tracked"] = torch.tensor(0)
        else:
            raise ValueError(kind)
        if "bias" in node:
            sd[f"{tname}.bias"] = _t(node["bias"])
    return sd


def flax_grads_to_named(grads: Mapping, mapping) -> Dict[str, torch.Tensor]:
    """A Flax gradient tree (shaped like ``params``) under the port's
    parameter names, in the port's layouts: what ``named_parameters``'
    ``.grad`` holds for the same loss."""
    return flax_to_state_dict({"params": grads}, mapping)


def from_jax_params(spatial_vars: Mapping, temporal_vars: Mapping,
                    smooth_vars: Mapping
                    ) -> Tuple[Dict[str, torch.Tensor], ...]:
    """state_dicts of (SpatialNet, TemporalNet, SmoothNet) from Flax trees."""
    return (flax_to_state_dict(spatial_vars, spatial_mapping()),
            flax_to_state_dict(temporal_vars, temporal_mapping()),
            flax_to_state_dict(smooth_vars, smooth_mapping()))
