"""The reader of the ``tps_solve`` spans (``benchmark/metrics/
tps_solve_ms.stitch.py``), held to the same checks as the other readers of
the program's span table (``test_bench_spans.py``): declared, its span's
seconds per unit of the slice from a planted table, and None without a
profiled slice, without its span, or where the program has no table."""

from __future__ import annotations

import os
import types

import pytest

from benchmark import harness
from benchmark.tests.test_bench_spans import (ROOT, SECONDS, UNITS, plant,
                                              reader, slice_run)

NAME = "tps_solve_ms.stitch"
TPS_SECONDS = {**SECONDS, "tps_solve": 0.0625}


def test_reader_is_declared():
    spec = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    declared = {m["name"]: m for m in spec["per_layer"]}[NAME]
    assert declared["source"] == "host_clock"
    assert declared["layer"] == "chain" and declared["moves"] == "stitch_fps"
    assert declared["workloads"] == ["ssd-2view.offline", "tra-3view.offline"]


def test_reads_the_planted_table_per_unit(monkeypatch):
    plant(monkeypatch, TPS_SECONDS)
    assert reader(NAME).read(slice_run()) == pytest.approx(
        1e3 * 0.0625 / UNITS)


def test_none_without_a_slice_or_a_span(monkeypatch):
    from stabstitch2_tpu_torch.utils import profiling

    read = reader(NAME).read
    plant(monkeypatch, TPS_SECONDS)
    assert read(types.SimpleNamespace(trace=None)) is None
    assert read(slice_run(units=0)) is None
    plant(monkeypatch, SECONDS)                    # the table, not the span
    assert read(slice_run()) is None
    monkeypatch.delattr(profiling, "table")        # a program without it
    assert read(slice_run()) is None
