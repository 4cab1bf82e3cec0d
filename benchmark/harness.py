"""The benchmark of ``stabstitch2_tpu_torch``: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name that ``BENCHMARK.json`` gives it:

- ``benchmark/configs/<config>.json``: the configuration as it is run
  (sizes, precisions, the preset and its fusion, the CLI's defaults);
- ``benchmark/mixes/<traffic>.json``: the traffic's parameters and the
  name of the driver that generates and serves it,
  ``benchmark/drivers/<driver>.py`` (``offline``, ``multi``, ``online``,
  ``train``);
- ``benchmark/limits/<cell>.json``: the limit of each number that the
  comparison with the plain reference (``benchmark/reference/``) yields;
- ``benchmark/metrics/<metric>.py``: a reader, ``read(run)``, that takes
  one per-layer metric from what the run recorded (spans, counters, the
  profiled slice) and returns it, or None where it finds nothing to read.

A run: the process's CPU operators get one host thread, the card is
checked, the program is set up (weights made on the card from the seed,
traffic made from the seed, every shape the traffic uses warmed) and
``setup_s`` is read; then the window of ``--seconds``;
the peak of device memory is read and the program freed; then the
reference follows the window's sampled outputs, and each compared number
is printed beside its limit. ``--trace 1`` adds a profiled slice of
steady work after the window and reports the per-layer metrics in place
of the end-to-end ones.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import platform
import subprocess
import sys
import time
from typing import Any, Dict, List

# top-level modules that the run may not hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "stabstitch2_tpu")


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Run:
    """What one run knows and records: its cell, configuration, mix and
    seed; the driver's end-to-end values, spans and counters; the
    profiled slice (``trace``); the readings of the comparison."""

    root: str
    spec: dict
    cell: dict
    cfg: dict
    mix: dict
    limits: dict
    seed: int
    seconds: float
    traced: bool
    device: Any
    end_to_end: Dict[str, float] = dataclasses.field(default_factory=dict)
    layer: Dict[str, Any] = dataclasses.field(default_factory=dict)
    trace: Any = None
    attempted: int = 0
    failed: int = 0
    readings: Dict[str, float] = dataclasses.field(default_factory=dict)

    def path(self, *parts: str) -> str:
        return os.path.join(self.root, "benchmark", *parts)


def applies(metric: dict, cell: dict, spec: dict) -> bool:
    """Whether ``metric`` is reported in ``cell``: the cells its
    ``workloads`` lists, else every cell (a per-layer metric without the
    key: every cell that reports the end-to-end metric it moves)."""
    if "workloads" in metric:
        return cell["name"] in metric["workloads"]
    if "moves" in metric:
        moved = next(m for m in spec["end_to_end"]
                     if m["name"] == metric["moves"])
        return applies(moved, cell, spec)
    return True


def make_run(root: str, workload: str, seed: int, seconds: float,
             traced: bool, device) -> Run:
    spec = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {c["name"]: c for c in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}: {sorted(cells)}")
    cell = cells[workload]
    bench = os.path.join(root, "benchmark")
    return Run(root=root, spec=spec, cell=cell,
               cfg=load_json(os.path.join(bench, "configs",
                                          cell["config"] + ".json")),
               mix=load_json(os.path.join(bench, "mixes",
                                          cell["traffic"] + ".json")),
               limits=load_json(os.path.join(bench, "limits",
                                             workload + ".json")),
               seed=seed, seconds=seconds, traced=traced, device=device)


def driver_of(run: Run):
    kind = run.mix["driver"]
    return load_module(run.path("drivers", kind + ".py"),
                       f"benchmark_driver_{kind}")


def execute(run: Run, t_start: float) -> dict:
    """One run of ``run``'s cell: set-up, window, optional slice, the
    comparison and the metrics; returns the result object (without the
    host line)."""
    import torch

    cuda = torch.device(run.device).type == "cuda"
    drv = driver_of(run).Driver(run)
    drv.setup()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    drv.window(run.seconds)
    if run.traced:
        run.trace = drv.traced_slice()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    drv.release()
    if cuda:
        torch.cuda.empty_cache()
    run.readings = drv.check()

    metrics = {}
    if run.traced:
        for m in run.spec["per_layer"]:
            if not applies(m, run.cell, run.spec):
                continue
            reader = load_module(run.path("metrics", m["name"] + ".py"),
                                 "benchmark_metric_" + m["name"]
                                 .replace(".", "_").replace("-", "_"))
            value = reader.read(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        values = dict(run.end_to_end, setup_s=setup_s)
        for m in run.spec["end_to_end"]:
            if applies(m, run.cell, run.spec):
                metrics[m["name"]] = {"value": float(values[m["name"]]),
                                      "unit": m["unit"]}

    checks = {k: {"value": float(v), "limit": float(run.limits[k])}
              for k, v in run.readings.items()}
    correct = (run.failed == 0 and run.attempted > 0 and bool(checks)
               and all(c["value"] <= c["limit"] for c in checks.values()))
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": (torch.cuda.get_device_name(run.device) if cuda
                       else platform.processor() or "cpu"),
              "count": run.cell["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": run.attempted,
              "failed": run.failed, "metrics": metrics, "device": device}
    if run.traced and run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in run.trace.device_ops[:10]],
            "idle_gaps": [[n, s] for n, s in run.trace.idle_gaps[:10]]}
    result["checks"] = checks
    return result


def forbidden_modules(names) -> List[str]:
    """The top-level names among ``names`` (module names) that are JAX's
    or the JAX package's, compared whole: ``stabstitch2_tpu_torch`` is not
    ``stabstitch2_tpu``."""
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def host_line(device) -> dict:
    """The host and the card: CPU model and cores, the card's name and
    power limit, torch and CUDA."""
    import torch

    cpu = platform.processor()
    try:
        with open("/proc/cpuinfo") as f:
            cpu = next((ln.split(":", 1)[1].strip() for ln in f
                        if ln.startswith("model name")), cpu)
    except OSError:
        pass
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        smi = f"nvidia-smi not read: {e}"
    return {"host": {"cpu": cpu, "cores": os.cpu_count(),
                     "card": torch.cuda.get_device_name(device),
                     "nvidia_smi": smi, "torch": torch.__version__,
                     "cuda": torch.version.cuda,
                     "python": platform.python_version()}}


def parse(argv):
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = load_json(os.path.join(root, "BENCHMARK.json"))
    cell = next((c for c in spec["workloads"] if c["name"] == args.workload),
                None)
    if cell is None:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    # one host thread for the process's CPU operators: with one per core,
    # their threads crowd out the thread that drives the card (one online
    # push in ~20 took 7-15 ms against ~4.5)
    os.environ["OMP_NUM_THREADS"] = "1"
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 1
    # the program's own build directory is inside the checkout
    # (stabstitch2_tpu_torch/_build); anything else that caches kernels
    # goes beside it, at fixed paths
    build = os.path.join(root, "stabstitch2_tpu_torch", "_build")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(build, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(build, "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    if root not in sys.path:
        sys.path.insert(0, root)
    try:
        import stabstitch2_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the program is missing: {e}", file=sys.stderr)
        return 1
    run = make_run(root, args.workload, args.seed, args.seconds,
                   bool(args.trace), torch.device("cuda", 0))
    result = execute(run, t_start)
    bad = forbidden_modules(sys.modules)
    if bad:
        print(f"the run loaded {bad}: the benchmark runs the port alone",
              file=sys.stderr)
        return 3
    print(json.dumps(host_line(run.device)), flush=True)
    print(f"correct: {result['correct']} ({result['attempted']} attempted, "
          f"{result['failed']} failed)", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
