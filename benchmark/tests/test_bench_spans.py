"""The readers of the program's span table (``benchmark/metrics/``): each
returns None without a profiled slice, without its span in the table, or
where the program has no table (a version before the spans), and its
span's seconds per unit of the slice from a planted table."""

from __future__ import annotations

import os
import types

import pytest

from benchmark import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# each reader and its ms per unit from SECONDS over UNITS
READERS = {
    "host_wait_ms.stitch": 1e3 * 0.5 / 4,
    "stage_ms.stitch": 1e3 * 0.25 / 4,
    "pack_ms.stitch": 1e3 * 0.125 / 4,
    "junction_ms.stitch": 1e3 * 1.5 / 4,
    "push_host_ms.online": 1e3 * (2.0 - 0.5) / 4,
    "loader_wait_ms.train": 1e3 * 0.75 / 4,
}
SECONDS = {"wait": 0.5, "stage": 0.25, "pack": 0.125, "junction": 1.5,
           "push": 2.0, "loader_wait": 0.75}
UNITS = 4


def reader(name):
    return harness.load_module(
        os.path.join(ROOT, "benchmark", "metrics", name + ".py"),
        "benchmark_metric_" + name.replace(".", "_"))


def slice_run(units=UNITS):
    return types.SimpleNamespace(trace=types.SimpleNamespace(units=units))


def plant(monkeypatch, seconds):
    from stabstitch2_tpu_torch.utils import profiling

    table = profiling.Table(spans={
        n: profiling.SpanTotals(count=3, total_s=s, self_s=s / 2)
        for n, s in seconds.items()})
    monkeypatch.setattr(profiling, "table", lambda: table)


def test_every_reader_is_declared():
    spec = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    declared = {m["name"]: m for m in spec["per_layer"]}
    for name in READERS:
        assert declared[name]["source"] == "host_clock"
        assert declared[name]["workloads"]


@pytest.mark.parametrize("name", sorted(READERS))
def test_reads_the_planted_table_per_unit(monkeypatch, name):
    plant(monkeypatch, SECONDS)
    assert reader(name).read(slice_run()) == pytest.approx(READERS[name])


@pytest.mark.parametrize("name", sorted(READERS))
def test_none_without_a_slice_or_a_span(monkeypatch, name):
    from stabstitch2_tpu_torch.utils import profiling

    read = reader(name).read
    plant(monkeypatch, SECONDS)
    assert read(types.SimpleNamespace(trace=None)) is None
    assert read(slice_run(units=0)) is None
    plant(monkeypatch, {})
    assert read(slice_run()) is None
    monkeypatch.delattr(profiling, "table")        # a program without it
    assert read(slice_run()) is None
