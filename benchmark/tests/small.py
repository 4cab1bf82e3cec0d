"""A copy of the benchmark at a size the CPU runs in seconds: the checkout's
``benchmark/`` and ``BENCHMARK.json`` under a temporary root, every
configuration at 128x160 (model and frames), the mixes cut to a few
short clips, and the program's stitcher built at that model size."""

from __future__ import annotations

import functools
import json
import os
import shutil

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SIZE = {"frame_h": 128, "frame_w": 160, "model_h": 128, "model_w": 160}
MIXES = {"offline": {"lengths": [16, 24, 16]},
         "offline-3view": {"lengths": [16, 16]},
         "online": {"path_frames": 20, "warm_pushes": 2, "check_pushes": 4,
                    "slice_pushes": 3, "control_pushes": 30},
         "train-spatial": {"videos": 3, "frames": 10, "warm_steps": 1,
                           "slice_steps": 2}}


def rewrite(path: str, **changes) -> None:
    with open(path) as f:
        d = json.load(f)
    d.update(changes)
    with open(path, "w") as f:
        json.dump(d, f, indent=2)


def small_root(tmp: str) -> str:
    """A benchmark root under ``tmp`` at the small size."""
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    os.path.join(tmp, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp)
    for name in os.listdir(os.path.join(tmp, "benchmark", "configs")):
        rewrite(os.path.join(tmp, "benchmark", "configs", name), **SIZE)
    for name, changes in MIXES.items():
        rewrite(os.path.join(tmp, "benchmark", "mixes", name + ".json"),
                **changes)
    return tmp


def small_program(monkeypatch) -> None:
    """The program's stitcher at the small model size."""
    from stabstitch2_tpu_torch.pipeline import stitcher

    monkeypatch.setattr(stitcher, "init_stitcher", functools.partial(
        stitcher.init_stitcher, model_h=SIZE["model_h"],
        model_w=SIZE["model_w"]))
