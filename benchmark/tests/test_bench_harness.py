"""The harness on the CPU at a small size (``small.py``): a run without a
card prints no result; a traffic mix, a metric and a cell added as new
files run through the harness as they are; and with the timed path
broken underneath (a frame altered where it is produced, the spatial
motion of half of each chunk left out, a stream step that returns its
state unchanged; a training step that keeps its state, half of the batch
left out with the mean over the rest, the loss altered where it is
produced) a run comes out not correct."""

from __future__ import annotations

import json
import os
import time

import pytest
import torch

from benchmark import harness
from benchmark.tests import small


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    rc = harness.main(["--workload", "ssd-2view.offline", "--seed", "1",
                       "--seconds", "1", "--trace", "0"], time.perf_counter())
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "no CUDA device" in out.err


def run_cell(root, cell, seed=2 ** 31 + 11, traced=False, seconds=2.0):
    run = harness.make_run(root, cell, seed, seconds, traced,
                           torch.device("cpu"))
    return harness.execute(run, time.perf_counter())


def test_a_new_mix_metric_and_cell_run_as_files(tmp_path, monkeypatch):
    small.small_program(monkeypatch)
    root = small.small_root(str(tmp_path))
    bench = os.path.join(root, "benchmark")
    with open(os.path.join(bench, "mixes", "dummy.json"), "w") as f:
        json.dump({"driver": "offline", "lengths": [16], "overlap": 0.5,
                   "shake_px": 4.0, "check_videos": 1, "warm_passes": 1}, f)
    with open(os.path.join(bench, "metrics", "frames_per_video.dummy.py"),
              "w") as f:
        f.write("def read(run):\n"
                "    v = run.layer.get('videos')\n"
                "    return run.layer['frames'] / len(v) if v else None\n")
    with open(os.path.join(bench, "limits", "ssd-2view.dummy.json"),
              "w") as f:
        json.dump({"mesh_gap_px": 1.0, "delta_gap_px": 1.0,
                   "canvas_rule_px": 0.0, "frame_gap": 0.5}, f)
    spec_path = os.path.join(root, "BENCHMARK.json")
    with open(spec_path) as f:
        spec = json.load(f)
    spec["workloads"].append({"name": "ssd-2view.dummy",
                              "config": "ssd-2view", "traffic": "dummy",
                              "chips": 1, "why": "a test cell"})
    for m in spec["end_to_end"]:
        if m["name"] == "stitch_fps":
            m["workloads"].append("ssd-2view.dummy")
    spec["per_layer"].append({"name": "frames_per_video.dummy",
                              "unit": "frames", "better": "higher",
                              "source": "program_counter", "layer": "entry",
                              "moves": "stitch_fps",
                              "workloads": ["ssd-2view.dummy"]})
    with open(spec_path, "w") as f:
        json.dump(spec, f)

    res = run_cell(root, "ssd-2view.dummy")
    assert res["correct"], res
    assert set(res["metrics"]) == {"stitch_fps", "setup_s"}
    res = run_cell(root, "ssd-2view.dummy", traced=True)
    assert res["metrics"]["frames_per_video.dummy"]["value"] == 16.0
    assert list(res)[-1] == "checks"


def shift(x):
    """An answer altered where it is produced: moved by three pixels."""
    if isinstance(x, tuple):
        return tuple(shift(p) for p in x)
    return torch.roll(x, 3, dims=2)


def plant(monkeypatch, fault):
    from stabstitch2_tpu_torch.pipeline import compositor, motion, online
    from stabstitch2_tpu_torch.pipeline import threeview

    if fault == "frame altered":
        orig = compositor.clip_and_convert
        monkeypatch.setattr(compositor, "clip_and_convert",
                            lambda f, fmt: shift(orig(f, fmt)))
        monkeypatch.setattr(threeview, "clip_and_convert",
                            lambda f, fmt: shift(orig(f, fmt)))
    elif fault == "half a chunk left out":
        orig_chunk = motion.MotionEstimator.motion_chunk

        def half(self, a, b, k=0, graphs=None):
            m1, m2, f1, f2 = orig_chunk(self, a, b, k, graphs)
            n = m1.shape[0] // 2
            m1, m2 = m1.clone(), m2.clone()
            m1[n:], m2[n:] = 0.0, 0.0       # never computed
            return m1, m2, f1, f2

        monkeypatch.setattr(motion.MotionEstimator, "motion_chunk", half)
    elif fault == "state unchanged":
        orig_step = online.OnlineStitcher._step

        def stale(self, frames):
            keep = [t.clone() for t in (self._prev_feat, self._prev_smotion,
                                        self._buf_smesh, self._buf_ts)]
            out = orig_step(self, frames)
            for t, k in zip((self._prev_feat, self._prev_smotion,
                             self._buf_smesh, self._buf_ts), keep):
                t.copy_(k)
            return out

        monkeypatch.setattr(online.OnlineStitcher, "_step", stale)
    elif fault == "step keeps its state":
        from stabstitch2_tpu_torch.train import common

        monkeypatch.setattr(common.Optimizer, "update",
                            lambda self: self.clip())
    elif fault == "half the batch":
        from stabstitch2_tpu_torch.train import spatial

        orig_loss = spatial.spatial_loss_fn

        def half_batch(net, img1, img2, factors, cfg, vgg=None):
            n = img1.shape[0] // 2
            return orig_loss(net, img1[:n], img2[:n], factors, cfg, vgg)

        monkeypatch.setattr(spatial, "spatial_loss_fn", half_batch)
    elif fault == "loss altered":
        from stabstitch2_tpu_torch.train import losses

        orig_l1 = losses.spatial_photometric_loss
        monkeypatch.setattr(losses, "spatial_photometric_loss",
                            lambda *a: 1.01 * orig_l1(*a))


@pytest.mark.parametrize("cell,fault", [
    ("ssd-2view.offline", None),
    ("ssd-2view.offline", "frame altered"),
    ("ssd-2view.offline", "half a chunk left out"),
    ("tra-3view.offline", None),
    ("tra-3view.offline", "frame altered"),
    ("tra-3view.offline", "half a chunk left out"),
    ("ssd-2view.online", None),
    ("ssd-2view.online", "frame altered"),
    ("ssd-2view.online", "state unchanged"),
    ("ssd-2view.train-spatial", None),
    ("ssd-2view.train-spatial", "step keeps its state"),
    ("ssd-2view.train-spatial", "half the batch"),
    ("ssd-2view.train-spatial", "loss altered"),
])
def test_broken_program_is_not_correct(tmp_path, monkeypatch, cell, fault):
    small.small_program(monkeypatch)
    root = small.small_root(str(tmp_path))
    if fault is not None:
        plant(monkeypatch, fault)
    res = run_cell(root, cell)
    assert res["correct"] is (fault is None), res["checks"]
