"""The control of a cell: the plain reference put in the program's place
in the precision below the one the configuration states (each driver's
``CONTROL``: a stitching cell's nets in float8 e4m3 and its composite in
bfloat16, below bfloat16 and float32; the training cell's products and
convolutions in TF32, below float32 with TF32 off), on the cell's own
traffic and sizes, judged by the same comparison as a run. Its readings
are the upper ends the limits in ``limits/<cell>.json`` are set below.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...]

prints one JSON line per seed: the readings, the limits, and whether the
control comes out correct (it must not). The benchmark's own runs never
run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness  # noqa: E402


def control_readings(root: str, workload: str, seed: int, device) -> dict:
    from benchmark.lib.weights import for_run

    run = harness.make_run(root, workload, seed, 0.0, False, device)
    mod = harness.driver_of(run)
    weights = for_run(run)
    inputs, kept = mod.control(run, weights)
    readings = mod.check(run, inputs, kept, weights)
    return {"workload": workload, "seed": seed, "control": mod.CONTROL,
            "readings": readings, "limits": run.limits,
            "correct": all(v <= run.limits[k] for k, v in readings.items())}


def main(argv=None) -> int:
    import torch

    p = argparse.ArgumentParser(prog="benchmark/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for seed in args.seeds:
        print(json.dumps(control_readings(root, args.workload, seed,
                                          torch.device("cuda", 0))),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
