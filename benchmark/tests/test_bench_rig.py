"""``ssd-1080p``, the two-view triad on 1080x1920 rig frames, and its one
cell ``ssd-1080p.online``: the entries as declared; a small CPU run of
the cell with frames at three times the model's size (so that the
program's in-graph downscale runs) is correct, and comes out not correct
with the frames altered where they are produced or with a stream step
that leaves its state unchanged; the two new readers
(``upload_ms.online``, ``composite_ms.online``) per push from a planted
span table and a planted slice, and None without a slice or a span."""

from __future__ import annotations

import os
import types

import pytest

from benchmark import harness
from benchmark.tests import small
from benchmark.tests.test_bench_harness import plant, run_cell
from benchmark.tests.test_bench_spans import reader, slice_run

ROOT = small.ROOT
CELL = "ssd-1080p.online"
# the model at the small size, the frames at three times it
RIG = {"frame_h": 3 * small.SIZE["model_h"],
       "frame_w": 3 * small.SIZE["model_w"]}
MIX = {"path_frames": 20, "warm_pushes": 2, "check_pushes": 4,
       "slice_pushes": 3, "control_pushes": 30}


def spec():
    return harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))


def test_entries_as_declared():
    s = spec()
    config = next(c for c in s["configs"] if c["name"] == "ssd-1080p")
    assert config["reduced"] == []
    assert config["file"] == "benchmark/configs/ssd-1080p.json"
    cell = next(c for c in s["workloads"] if c["name"] == CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "ssd-1080p", "online-1080p", 1)
    cfg = harness.load_json(os.path.join(ROOT, config["file"]))
    base = harness.load_json(os.path.join(ROOT, "benchmark", "configs",
                                          "ssd-2view.json"))
    assert (cfg["frame_h"], cfg["frame_w"]) == (1080, 1920)
    assert cfg["reduced"] == [] and "resize" in cfg["assumed"]
    # every width, the model input, the mesh, the window, the precisions,
    # the fusion and the route as the two-view configuration has them
    for key, value in base.items():
        if key not in ("name", "source", "what", "frame_h", "frame_w",
                       "assumed"):
            assert cfg[key] == value, key
    mix = harness.load_json(os.path.join(ROOT, "benchmark", "mixes",
                                         "online-1080p.json"))
    assert (mix["path_frames"], mix["shake_px"], mix["overlap"]) == (
        120, 12.0, 0.5)
    assert 2 * mix["path_frames"] * 1080 * 1920 * 3 == 1492992000
    per_layer = {m["name"]: m for m in s["per_layer"]}
    for name in ("push_p50_ms.online", "push_p98_ms.online",
                 "push_mean_ms.online", "idle_share.online", "mfu.online",
                 "k2_roofline.online", "push_host_ms.online",
                 "upload_ms.online", "composite_ms.online"):
        assert CELL in per_layer[name]["workloads"], name
    assert "ssd-2view.online" in per_layer["upload_ms.online"]["workloads"]
    p95 = next(m for m in s["end_to_end"] if m["name"] == "push_p95_ms")
    assert CELL in p95["workloads"] and p95["bound"] == 0.19
    for name in ("upload_ms.online", "composite_ms.online"):
        assert per_layer[name]["moves"] == "push_p95_ms"
    assert per_layer["upload_ms.online"]["source"] == "host_clock"
    assert per_layer["composite_ms.online"]["source"] == "device_trace"


def rig_root(tmp):
    root = small.small_root(tmp)
    bench = os.path.join(root, "benchmark")
    small.rewrite(os.path.join(bench, "configs", "ssd-1080p.json"), **RIG)
    small.rewrite(os.path.join(bench, "mixes", "online-1080p.json"), **MIX)
    return root


@pytest.mark.parametrize("fault", [None, "frame altered",
                                   "state unchanged"])
def test_small_rig_run(tmp_path, monkeypatch, fault):
    small.small_program(monkeypatch)
    root = rig_root(str(tmp_path))
    if fault is not None:
        plant(monkeypatch, fault)
    # a window long enough for the quarters of its pushes under load
    # (``drivers/online.py:window`` splits them in four)
    res = run_cell(root, CELL, traced=fault is None, seconds=12.0)
    assert res["correct"] is (fault is None), res["checks"]
    if fault is None:       # the CPU shows no device work: no slice
        assert {"push_p50_ms.online", "push_p98_ms.online",
                "push_mean_ms.online", "mfu.online"} <= set(res["metrics"])


def test_upload_reader(monkeypatch):
    from stabstitch2_tpu_torch.utils import profiling

    read = reader("upload_ms.online").read
    table = profiling.Table(spans={"upload": profiling.SpanTotals(
        count=4, total_s=0.02, self_s=0.005)})
    monkeypatch.setattr(profiling, "table", lambda: table)
    assert read(slice_run(units=4)) == pytest.approx(5.0)
    assert read(types.SimpleNamespace(trace=None)) is None
    assert read(slice_run(units=0)) is None
    monkeypatch.setattr(profiling, "table", lambda: profiling.Table())
    assert read(slice_run()) is None
    monkeypatch.delattr(profiling, "table")        # a program without it
    assert read(slice_run()) is None


def test_composite_reader():
    read = reader("composite_ms.online").read

    def traced(span_s, units=4):
        return types.SimpleNamespace(trace=types.SimpleNamespace(
            units=units, span_s=span_s))

    assert read(traced({"composite": 0.006})) == pytest.approx(1.5)
    assert read(types.SimpleNamespace(trace=None)) is None
    assert read(traced({"composite": 0.006}, units=0)) is None
    assert read(traced({})) is None             # a program without it
    assert read(traced({"composite": 0.0})) is None
