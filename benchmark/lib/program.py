"""The program under test as a user runs it: the stitcher that the CLI
builds from its own parser's defaults, holding the benchmark's weights."""

from __future__ import annotations

import numpy as np
import torch

NETS = ("spatial", "temporal", "smooth")


def stitcher(cfg: dict, weights: dict, device, command: str = "stitch"):
    """``cli.build_stitcher`` on ``cli <command>``'s defaults with the
    configuration's preset and chunk, then the benchmark's state_dicts
    loaded into its nets. Raises where the program would not run what the
    configuration states (its model size or trunk precision)."""
    from stabstitch2_tpu_torch import cli

    where = "--video_dir" if command == "stitch-multi" else "--test_path"
    dev = "cuda" if torch.device(device).type == "cuda" else "cpu"
    args = cli.make_parser().parse_args(
        [command, where, ".", "--preset", cfg["preset"], "--chunk",
         str(cfg["chunk"]), "--device", dev])
    st = cli.build_stitcher(args)
    trunk = st.spatial_net.feature_extractor_stage1.compute_dtype
    if (st.model_h, st.model_w) != (cfg["model_h"], cfg["model_w"]) or \
            trunk != getattr(torch, cfg["trunk_dtype"]) or \
            st.config.fusion_mode != cfg["fusion_mode"] or \
            st.config.download_format != cfg["download_format"]:
        raise RuntimeError(
            f"the program's stitcher ({st.model_h}x{st.model_w}, {trunk}, "
            f"{st.config.fusion_mode}, {st.config.download_format}) is not "
            f"the configuration's")
    for name, net in zip(NETS, (st.spatial_net, st.temporal_net,
                                st.smooth_net)):
        net.load_state_dict(weights[name], strict=True)
    st.replicate()
    return st


def canvas_fields(c) -> dict:
    """A program canvas as plain numbers."""
    return {"out_h": int(c.out_h), "out_w": int(c.out_w),
            "pad_h": int(c.pad_h), "pad_w": int(c.pad_w),
            "x_min": float(c.x_min), "y_min": float(c.y_min)}


def host_copy(x) -> np.ndarray:
    return np.array(x.detach().cpu().numpy() if torch.is_tensor(x) else x)
