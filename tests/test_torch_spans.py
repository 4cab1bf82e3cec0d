"""The port's spans (``utils/profiling.py:annotate``) on the CPU.

With no profiler running a span records nothing and enters no
``record_function``. Under a CPU ``torch.profiler.profile`` the spans
count what the main paths do: per two-view video of the CLI's two-deep
loop three ``wait`` spans (the canvas fetch and the composite's two event
waits), one ``pack``, and ``stage`` spans whose ``stage_bytes`` are every
byte staged for the card, frames included, with frames bit-equal to the
same run unprofiled; in a steady online push one ``upload``, one
``composite`` (its ``emit_bytes`` the panorama's bytes) and one
``wait``, and none of them with no profiler running; one
``junction`` (and its one extent fetch) per junction of an N-view chain;
one ``tps_solve`` per TPS solve (one in a steady push), its systems
counted; one ``loader_wait`` per batch of ``batch_iterator``; and a
span's self seconds are its seconds less its children's.
"""

import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from stabstitch2_tpu_torch import cli
from stabstitch2_tpu_torch.config import StitchConfig
from stabstitch2_tpu_torch.data.datasets import batch_iterator
from stabstitch2_tpu_torch.data.video_io import bgr_to_i420
from stabstitch2_tpu_torch.ops import tps
from stabstitch2_tpu_torch.ops.mesh import (mesh_points, normalize_mesh,
                                            rigid_mesh)
from stabstitch2_tpu_torch.pipeline import stitcher as stitcher_mod
from stabstitch2_tpu_torch.pipeline import threeview
from stabstitch2_tpu_torch.pipeline.online import OnlineStitcher
from stabstitch2_tpu_torch.pipeline.stitcher import init_stitcher
from stabstitch2_tpu_torch.utils import profiling, transfer
from stabstitch2_tpu_torch.utils.profiling import annotate

from synthetic import make_two_view_clip

MH, MW, CHUNK, T = 128, 160, 4, 8


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads (tests/test_torch_entry.py: tier-1's workers
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def profiled():
    """A function that runs ``fn()`` under a CPU profiler on a cleared
    table and returns (its result, the table)."""
    def run(fn):
        profiling.clear_table()
        with profile(activities=[ProfilerActivity.CPU]):
            out = fn()
        return out, profiling.table()

    yield run
    profiling.clear_table()


@pytest.fixture(scope="module")
def st():
    return init_stitcher(0, StitchConfig(download_format="yuv420"),
                         model_h=MH, model_w=MW, chunk=CHUNK,
                         compute_dtype=torch.float32, device="cpu")


def spans(table, name):
    s = table.spans.get(name)
    return s.count if s else 0


def test_off_records_nothing_and_enters_no_range(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    profiling.clear_table()
    assert not torch.autograd._profiler_enabled()
    with annotate("wait"):
        with annotate("stage"):
            profiling.count("stage_bytes", 10)
    transfer.pinned(np.zeros(4, np.uint8), "cpu")
    table = profiling.table()
    assert table.spans == {} and table.counters == {}


def test_two_view_loop_profiled(st, profiled, monkeypatch):
    """Three videos through ``cli.stitch_stream``: 3 waits, 1 pack, one
    begin and one finish span each; ``stage_bytes`` is every byte handed
    to staging (recorded by a wrapper of ``transfer.pinned``), the frames'
    among them; the frames equal the unprofiled run's bit for bit."""
    clips = [tuple(bgr_to_i420(v) for v in make_two_view_clip(
        T, MH, MW, overlap=0.6, shake_px=2.0, seed=s)) for s in range(3)]

    def loop():
        got = {}
        done, failed = cli.stitch_stream(
            st, [(f"clip{k}", (a, None, b, None), None)
                 for k, (a, b) in enumerate(clips)],
            lambda name, r: got.setdefault(name, r))
        assert (done, failed) == (3, 0)
        return got

    plain = loop()
    staged = []
    orig = transfer.pinned

    def recorded(x, device):
        staged.append(torch.as_tensor(x).nbytes)
        return orig(x, device)

    monkeypatch.setattr(transfer, "pinned", recorded)
    monkeypatch.setattr(stitcher_mod, "pinned", recorded)
    got, table = profiled(loop)
    for name, n in (("wait", 9), ("pack", 3), ("stitch_begin", 3),
                    ("stitch_finish", 3), ("composite", 3)):
        assert spans(table, name) == n, (name, table.spans)
    frame_bytes = sum(a.nbytes + b.nbytes for a, b in clips)
    assert spans(table, "stage") == len(staged)
    assert table.counters["stage_bytes"] == sum(staged) >= frame_bytes
    assert sum(staged) - frame_bytes < 1024 * len(clips)    # constants
    for name, r in plain.items():
        np.testing.assert_array_equal(got[name].frames, r.frames)
        assert list(got[name].ms) == ["upload", "spatial", "temporal",
                                      "smooth", "warp_fuse", "download"]


def test_steady_push_waits_once(st, profiled):
    v1, v2 = make_two_view_clip(st.config.window + 2, MH, MW, overlap=0.6,
                                shake_px=2.0, seed=4)
    online = OnlineStitcher(st)
    for t in range(st.config.window):
        online.push(v1[t], v2[t])
    waits = online.waits
    out, table = profiled(lambda: online.push(v1[-1], v2[-1]))
    assert len(out) == 1 and not online.reanchor_frames
    assert online.waits == waits + 1
    assert spans(table, "push") == 1 and spans(table, "wait") == 1
    assert spans(table, "stage") >= 1 and spans(table, "pack") == 1
    assert spans(table, "tps_solve") == 1          # the B=1 composite's
    assert spans(table, "upload") == 1 and spans(table, "composite") == 1
    assert table.counters["emit_bytes"] == out[0].nbytes
    push = table.spans["push"]
    inner = sum(table.spans[n].total_s
                for n in ("upload", "composite", "wait", "pack"))
    assert push.self_s == pytest.approx(push.total_s - inner, abs=1e-9)
    # the frames' staging inside the upload, the solve inside the composite
    for name in ("upload", "composite"):
        assert table.spans[name].self_s < table.spans[name].total_s, name


def test_steady_push_off_records_nothing(st, monkeypatch):
    """With no profiler a steady push, its ``upload`` and ``composite``
    spans and ``emit_bytes`` included, enters no ``record_function`` and
    records nothing."""
    v1, v2 = make_two_view_clip(st.config.window + 1, MH, MW, overlap=0.6,
                                shake_px=2.0, seed=4)
    online = OnlineStitcher(st)
    for t in range(st.config.window):
        online.push(v1[t], v2[t])

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    profiling.clear_table()
    assert len(online.push(v1[-1], v2[-1])) == 1
    table = profiling.table()
    assert table.spans == {} and table.counters == {}


@pytest.mark.parametrize("views", [3, 4])
def test_chain_junction_spans(profiled, views):
    """``chain_meshes`` over ``views`` views: ``views - 2`` junctions, each
    one span with one wait (its extent fetch) inside."""
    gen = torch.Generator().manual_seed(views)
    rigid = rigid_mesh(MH, MW)
    pairs = [tuple(rigid + torch.randn((T, *rigid.shape), generator=gen)
                   + torch.tensor([60.0 * j, 0.0]) for j in (k, k + 1))
             for k in range(views - 1)]
    meshes, table = profiled(lambda: threeview.chain_meshes(pairs, MH, MW,
                                                            MH, MW))
    assert len(meshes) == views
    assert spans(table, "junction") == views - 2
    assert spans(table, "wait") == views - 2
    j = table.spans["junction"]
    assert 0 <= j.self_s <= j.total_s - table.spans["wait"].total_s + 1e-9


@pytest.mark.parametrize("B", [2, 24])
def test_tps_solve_span_and_counter(profiled, B):
    """One ``tps_solve`` span a ``tps_params`` call and its B systems in
    ``tps_systems``; nothing recorded with the profiler off."""
    gen = torch.Generator().manual_seed(2)
    target = mesh_points(normalize_mesh(rigid_mesh(MH, MW), MH, MW))
    target = target[None].expand(B, -1, -1)
    source = target + 0.02 * torch.randn(target.shape, generator=gen)
    T, table = profiled(lambda: tps.tps_params(source, target))
    assert T.shape == (B, 2, 66)
    assert spans(table, "tps_solve") == 1
    assert table.counters == {"tps_systems": B}
    profiling.clear_table()
    tps.tps_params(source, target)               # no profiler
    table = profiling.table()
    assert table.spans == {} and table.counters == {}


@pytest.mark.parametrize("limit,batches", [(None, 3), (2, 2)])
def test_loader_wait_per_batch(profiled, limit, batches):
    dataset = [np.full(4, i, np.float32) for i in range(10)]
    got, table = profiled(lambda: list(batch_iterator(dataset, 3, seed=1,
                                                      limit=limit)))
    assert len(got) == batches and all(b.shape == (3, 4) for b in got)
    assert spans(table, "loader_wait") == batches


def test_self_seconds_leave_children_out(profiled):
    def nest():
        with annotate("a"):
            time.sleep(0.002)
            for name in ("b", "c", "b"):
                with annotate(name):
                    time.sleep(0.001)
                    with annotate("d"):
                        time.sleep(0.001)

    _, table = profiled(nest)
    a, b, c, d = (table.spans[n] for n in "abcd")
    assert (a.count, b.count, c.count, d.count) == (1, 2, 1, 3)
    assert a.self_s == pytest.approx(a.total_s - b.total_s - c.total_s,
                                     abs=1e-9)
    assert b.self_s + c.self_s == pytest.approx(
        b.total_s + c.total_s - d.total_s, abs=1e-9)
    assert d.self_s == d.total_s and a.self_s >= 0.002


def test_trace_clears_the_table_on_entry(tmp_path, profiled):
    _, table = profiled(lambda: annotate("before").__enter__().__exit__(
        None, None, None))
    assert spans(table, "before") == 1
    with profiling.trace(str(tmp_path)):
        with annotate("inside"):
            pass
    table = profiling.table()
    assert list(table.spans) == ["inside"]


def test_threads_lose_no_update(monkeypatch):
    """Spans and counts from more threads than cores, with a short switch
    interval, each thread under its own stack: no update is lost."""
    import sys
    import threading

    monkeypatch.setattr(profiling, "_profiling", lambda: True)
    profiling.clear_table()
    threads, n = 16, 300

    def work():
        for _ in range(n):
            with annotate("outer"):
                with annotate("inner"):
                    profiling.count("n")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in pool)
    table = profiling.table()
    profiling.clear_table()
    assert table.counters == {"n": threads * n}
    assert {k: v.count for k, v in table.spans.items()} == {
        "outer": threads * n, "inner": threads * n}
    outer, inner = table.spans["outer"], table.spans["inner"]
    assert outer.self_s == pytest.approx(outer.total_s - inner.total_s,
                                         abs=1e-6)
