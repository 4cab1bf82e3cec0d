#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``stabstitch2_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases, each printing one JSON line with its seconds:

1. ``device``: the card's name and count, and its name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives.
2. ``build``: the ``nvcc`` calls that build ``csrc/*.cu`` into a plain-C
   library (bound with ``ctypes``; one compile per source, all started
   together, then the link), their wall seconds and ptxas's registers /
   shared memory / spills per kernel; the two kernels that evaluate the
   spline (``fused_warp_kernel``, ``tps_coords_kernel``) must spill
   nothing. Then the float32 operations of the
   accurate ``logf`` and of K2's bit-equal core path of it
   (``warp_common.cuh:log_core``), counted in the SASS (``cuobjdump
   -sass``) of probe kernels that do nothing else: the bounds of K2 and
   K3 count the latter.
3. ``stitch``: the stitcher with float32 trunks,
   ``init_stitcher(rng_seed=0, compute_dtype=torch.float32,
   device="cuda")`` (random weights from the seed), and ``stitch_arrays``
   on a synthetic two-view clip of 16 frames at 360x480 made from a numpy
   seed (``tests/synthetic.py``), at the full width of the model
   (ResNet-18 trunks, 360x480 input, 7x9 mesh, 7-frame window). The
   kernels' launch counts are set to 0 just before the run and read just
   after; each must be > 0. This phase, ``routes``, ``resize`` and
   ``cpu_compare`` run float32 trunks, so that the float32 comparisons
   hold.
4. ``routes``: the composite's gather route (route B: K3 coordinates, K4
   sample) at full width, ``init_stitcher(rng_seed=0,
   config=StitchConfig(fused_warp=False, download_format="yuv420"))`` and
   ``stitch_arrays`` on the same clip, one warm-up and one timed run with
   the launch counts set to 0 just before it and read just after (K3 and
   K4 > 0, K2 0). Then, on the stitch phase's smooth meshes: route B's bgr
   frames against route A's (AVERAGE and LINEAR, exactly equal); route
   B's yuv420 against the conversion of its bgr frames and route A's
   yuv420 against the conversion of the plain path's float fusion (both
   exact); FAST mode and ``coord_stride=4`` on the card against the CPU.
5. ``resize``: the main path at a frame size other than the model's, 16
   frames of 480x640 through ``stitch_arrays(lo=None)``, so the model
   input is resized on the card (``pipeline/stitcher.py:model_input``),
   with the launch counts set to 0 just before and read just after (K1
   and K2 > 0); the card's model input against the CPU port's
   (<= RESIZE_ATOL).
6. ``loader``: the native frame loader (``native/frameloader.cpp``,
   built with g++ and libjpeg at first use): the build's seconds, the
   decoder, and the decode of the cli phase's 4 x 2 x 48 jpgs natively
   and by cv2 (with and without the model-size resize), in turns; native
   frames against cv2's within the bounds of tests/test_torch_native.py.
   A build that fails only for want of libjpeg is reported and the run
   goes on with cv2; any other build failure fails the script.
7. ``cli``: the main path, ``cli stitch`` at its defaults (bf16 trunks,
   native decode, I420 upload, yuv420 download, K2, the loader thread and
   the two-deep begin/finish loop), driven through the CLI's own
   functions over 4 synthetic clips of 48 frames at 360x480 written as
   jpgs, with the launch counts set to 0 just before and read just after
   (K1 and K2 > 0); then the same videos one at a time (``stitch_arrays``
   and the encode), and the pipelined loop with ``upload_mode="stream"``
   (counted the same way), in turns, the first two also with
   ``--eager_motion`` (the defaults replay phases 1-4 from CUDA graphs,
   ``utils/graphs.py``; their replays and replayed launches per video are
   printed, and peak memory of both). Gates: each mp4 holds 48 frames, the
   pipelined frames equal ``stitch_arrays``' bit for bit and the stream
   frames and meshes the bulk ones, the eager frames and meshes the fused
   ones and the eager launches of K1 and K2 the fused ones, the view loads went through the
   loader phase's decoder, the bf16 smooth meshes lie within
   BF16_MESH_BOUND_PX of a float32 stitcher's, and one ``stitch_begin``
   waits for the card once in either upload mode (the canvas fetch: one
   ``wait`` span, no synchronizing call that
   ``torch.cuda.set_sync_debug_mode`` reports).
8. ``trace``: one of those videos through ``--trace_dir``
   (``torch.profiler``), in bulk (fused and eager) and in stream mode;
   each Chrome trace
   must name the cost_volume and fused_warp kernels. Prints the card's
   idle share of the traced window, the 5 device operations that took
   the most time, and the ms of host-to-device copy that overlap kernels.
9. ``kernels``: each kernel against its plain PyTorch version on the card,
   at the shapes the main path gives it, with CUDA-event times, the bound
   (bytes over 3.35 TB/s or float32 operations over 67 TFLOP/s, the H100
   SXM's published peaks; an FMA counts two operations) and the share of
   it reached. ``cost_volume``
   runs at both search ranges the path gives it (r=5 and r=3); its entry
   carries each as a case and, at the top, their launch-weighted mean.
   The warp kernels run on the first chunk of the stitch phase (16 images
   onto the padded canvas); K1 and K2 carry the cli phase's launches, K3
   and K4 the routes phase's.
   K2 must equal its plain version bit for bit (planes and mask), and
   its log (``log_core``) must equal ``logf`` on every float32 from 1e-6
   to FLT_MAX.
10. ``cpu_compare``: the same port on the CPU over the first 8 frames,
   against the card: smooth meshes, and composited frames on the same
   meshes with AVERAGE and with LINEAR fusion (LINEAR reads K2's coverage
   masks).

11. ``online``: ``OnlineStitcher.push`` over 48 frames at 360x480 at the
    defaults (bf16, route A), one pair at a time, counted; per-push host
    ms, waits and launches; gates on the emissions, one wait per steady
    push, the i420 emission against the converted bgr one, and float32
    online against batch and route A against route B (``phase_online``).
12. ``multi``: ``stitch_multi_begin``/``finish`` on a 3-view clip of 16
    frames at 360x480 at the CLI's defaults, counted, then ``cli
    stitch-multi``; gates on the frames, the mp4, float32 route A against
    route B and the chain's junctions on the card against the CPU, which
    must also see a planted fault (bfloat16 pair meshes)
    (``phase_multi``).
13. ``metric``: ``evaluate_video`` on 16 frames at 360x480 with the
    ``metric`` command's stitcher, its one captured program per 16-frame
    bucket against ``--eager_motion``, in turns, counted (K3 warps the
    float views): ms per video, replays, peak memory, capture seconds
    per bucket, a trace of each; gates on one replay per video, the
    launches, the gap to eager, a 13-frame video replaying the 16-frame
    graph bit-equal to the program uncaptured (which a count baked in at
    capture must fail), a 20-frame video capturing once, with float32
    trunks the 13-frame program against ``--eager_motion`` (within
    METRIC_RTOL) and the card's metrics against the CPU, then ``cli
    metric --out_json`` and its report (``phase_metric``).

14. ``train``: the training path through ``cli.main`` at full width and
    batch 8, float32: ``train spatial`` (ssd), ``train temporal``,
    ``export-motions --which both`` with the two trained nets, ``train
    smooth``, each TRAIN_STEPS steps in TRAIN_EPOCHS epochs (the rate's
    staircase moves) on TRAIN_VIDEOS jpg clips of TRAIN_FRAMES frames at
    360x480, then ``cli stitch`` of one clip with the trained triad
    through ``--reference_pth_dir``. Each stage runs with its step
    captured as one CUDA graph (the default) and, in turns, through the
    same command with ``capture_step=False`` (the eager step): twice each
    at the default algorithms (times, traces), then with PyTorch's and
    cuDNN's deterministic ones twice captured and five times eager, then twice
    more captured with a planted fault each (a replay that skips the
    copy of the new batch, a rate baked in at capture). Per stage,
    captured against eager: the step ms, the capture seconds, replays
    and replayed launches per step, peak memory allocated and reserved,
    K1/K3 launches per step and a trace of the last step (a replay where
    captured: the card's idle share, the top device operations); gates
    on one capture and TRAIN_STEPS - 1 replays, those launches, the last
    update's rate, finite losses, moved parameters and BatchNorm
    statistics, and the deterministic captured runs' losses, parameters,
    statistics and last rate against the eager runs' (bit for bit where
    the eager runs are, else within CAPTURE_SPREAD_FACTOR times their
    spread), which each planted fault must fail (``captured_gate``).
    Before it, the gradient gate: one spatial step at B=2, 128x160 on
    the card against the CPU (loss, every gradient, the TPS term reaching
    the mesh head), which a planted fault (K3's coordinates detached)
    must fail. After it, ``TpsCoords``' gradients against autograd
    through the plain version on the recorded inputs (``phase_train``).

15. ``devices``: multi-device (``stabstitch2_tpu_torch/parallel/``).
    ``cli stitch`` at its defaults through ``cli.build_stitcher`` and
    ``stitch_stream`` over DEVICE_VIDEOS clips of DEVICE_FRAMES frames at
    360x480, the stitcher dealt over two replicas on the card (a device
    list; the CLI takes only ``--n_devices``), in bulk and stream upload,
    counted; gates: frames and meshes equal one replica's bit for bit,
    one wait per ``stitch_begin``, K1 and K2 launched. Then the trainer
    loops as a user calls them (``loop.train_temporal`` two steps,
    ``loop.train_spatial`` one, at batch 8 on DEVICE_TRAIN_FRAMES frames
    at 360x480) on two gloo ranks on the card (a device list) against
    the same loops in one process: gates on each step's loss, the last
    step's gradients and the update, the parameters, the checkpoint that
    rank 0 alone writes, and K1 (and in the spatial loop K3) launched on
    every rank (:func:`devices_train`). Where two
    or more cards are visible, the same over two cards (``--n_devices
    2``, NCCL) and each kernel with its inputs on the last card against
    its plain version; else it prints ``{"devices": {"multi_card":
    "skipped: 1 card"}}``, a statement, not a pass (``phase_devices``).

Phases 11-14 also hold every kernel that their path runs against its
plain version on the card, on the inputs that path gave it (the latest
call at each of up to HELD_PER_KERNEL shapes, ``PathInputs``): K2, K3
and K4 exactly, K1 within the kernels phase's tolerance. The
``max_abs_err`` of the kernels line is the largest over the kernels phase
and these paths. The kernels phase also times K4 and ``F.grid_sample`` in
turns, with the host's issue time and the L2 flushed
(``k4_in_turns``), and holds K4 bit for bit on the edges the main path
never reaches (``k4_edges``: N % 4 of 1 to 3, B of 1 and 17, coordinates
and source off their alignment, corners clamped at the right and bottom
edges, NaN coordinates).

Then one line ``{"kernels": [...]}``, the nvidia-smi line, and as the last
line ``{"ok": true, "device": {...}}``. Any failed check raises, so the
script exits nonzero without that last line. It exits nonzero before
printing anything where no CUDA device is present or the package is
missing.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import glob
import json
import os
import re
import subprocess
import sys
import tempfile
import time

T_FRAMES = 16        # clip length of the float32 stitch, routes and resize runs
CPU_FRAMES = 8       # frames the CPU comparison runs
CLI_VIDEOS = 4       # the cli phase's dataset: videos of CLI_FRAMES frames
CLI_FRAMES = 48
CLI_ROUNDS = 2       # pipelined (bulk, stream) and sequential runs, in turns
LOADER_ROUNDS = 3    # native and cv2 decodes of the cli dataset, in turns
QUEUED_SLEEP_MS = 20  # card work queued ahead of a traced stitch_begin
# native decode against cv2 (tests/test_torch_native.py, the JAX package's
# tests/test_pipeline.py::TestNativeLoader): their IDCTs may round apart
LOADER_MEAN_LEVELS = 1.5
LOADER_MAX_LEVELS = 24
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
L2_BYTES = 50 * 2 ** 20        # H100 SXM L2 cache
K4_ROUNDS = 20       # rounds of K4 and F.grid_sample timed in turns
F32_FLOP_PER_S = 67e12         # H100 SXM float32 outside the tensor cores

# tolerances (see the docstrings of the checks below)
CV_ATOL = 1e-5
# K2's coverage mask against its plain version: a float32 ulp of a
# sample coordinate near 500 px is 6e-5, so 1e-4 allows one rounding step
# of a coordinate and fails any value wrong by a real amount (0 is
# expected: the same float32 operations in the same order). K4's samples
# are held bit for bit.
MASK_ATOL = 1e-4
MESH_ATOL_PX = 0.05
# the model input resized on the card against the CPU: the same filter,
# summed in another order (values in [-1, 1])
RESIZE_ATOL = 1e-4
# kernels that do nothing but a log, for counting its float32 operations
# in SASS: the accurate logf and K2's bit-equal core path of it
LOG_PROBES = """
#include "warp_common.cuh"
extern "C" __global__ void logf_probe(const float* x, float* y) {
  y[threadIdx.x] = logf(x[threadIdx.x]);
}
extern "C" __global__ void log_core_probe(const float* x, float* y) {
  y[threadIdx.x] = stabstitch::log_core(x[threadIdx.x]);
}
"""
# SASS opcodes that run on the float32 units; FFMA counts two operations
FP32_OPCODES = ("FADD", "FMUL", "FFMA", "FMNMX", "FSEL", "FSETP", "FSET",
                "MUFU", "I2F", "I2FP", "FCHK", "FRND")
# the online, multi and metric phases: frames of the model's size
FRAME_HW = (360, 480)
ONLINE_FRAMES = 48
TRACE_PUSHES = 8     # steady pushes in the online phase's trace
MULTI_FRAMES = 16
METRIC_FRAMES = 16
METRIC_SHORT = 13    # a second length in METRIC_FRAMES' bucket
METRIC_NEXT = 20     # a length in the next bucket (32)
METRIC_ROUNDS = 3    # timed videos per mode, captured and eager in turns
# float32 online against batch smooth meshes: the JAX package's
# tests/test_online_mode.py bound (atol 5e-3 px)
ONLINE_MESH_ATOL_PX = 5e-3
# the chain's junction algebra on the card against the CPU on the same
# pair meshes at 360x480: 2.4x the sound gap (8.3e-4 px in every run, the
# same seeded inputs), far below the gap of a planted fault (the pair
# meshes rounded through bfloat16), which phase_multi also reads
CHAIN_ATOL_PX = 2e-3
# the path phases hold each kernel against its plain version on the inputs
# of its calls on that path, at most this many distinct shapes
HELD_PER_KERNEL = 3
# float32 metrics on the card against the CPU: the bound of
# tests/test_torch_metrics.py for the bgr upload against JAX
METRIC_RTOL = 1e-4
# the train phase: TRAIN_VIDEOS jpg clips of TRAIN_FRAMES frames at
# 360x480 (12-frame smooth windows: 11 per clip, 4 batches), each stage
# TRAIN_STEPS steps in TRAIN_EPOCHS epochs at the presets' batch of 8
TRAIN_VIDEOS = 3
TRAIN_FRAMES = 22
TRAIN_STEPS = 4
TRAIN_EPOCHS = 2
# the captured step against the eager one: where two eager runs differ
# (atomics in the backwards), a captured run lies within this many times
# the eager runs' spread of the nearest eager run (captured_gate)
CAPTURE_SPREAD_FACTOR = 2
# the gradient gate, one spatial step at B=2, 128x160, card against CPU:
# the loss, and every parameter's gradient in relative L2. The second is
# float32-conditioned: on the CPU the JAX package's and the port's trunk
# gradients sit 1.7e-3 and 1.2e-2 from the port's float64 one
# (tests/test_torch_train_steps.py), and a coordinate kernel without a
# backward leaves the mesh heads' gradients O(1) off
GATE_HW = (128, 160)
GATE_LOSS_RTOL = 1e-4
GATE_GRAD_RTOL_L2 = 1e-2
FRAC_DIFF = 1e-2
FRAC_DIFF_GT1 = 1e-4
# bf16 against float32 trunks, smooth meshes of the seed-0 random model at
# full width: twice the gap of the JAX package's own bf16 and float32
# stitchers on the CPU (tests/test_torch_entry.py: JAX_BF16_GAP_PX 0.0702)
BF16_MESH_BOUND_PX = 2 * 0.0702
# the devices phase: cli stitch of DEVICE_VIDEOS clips of DEVICE_FRAMES
# frames, and the trainer loops at batch DEVICE_BATCH on one clip of
# DEVICE_TRAIN_FRAMES frames (17 temporal and 18 spatial pairs)
DEVICE_VIDEOS = 2
DEVICE_FRAMES = 48
DEVICE_BATCH = 8
DEVICE_TRAIN_FRAMES = 20
# N training ranks against one process: each step's loss (tests/test_
# torch_train_steps.py's LOSS_RTOL) and the parameters after the steps
# (the JAX package's mesh-against-single bound, tests/test_entry_and_
# multiview.py)
RANKS_LOSS_RTOL = 1e-4
RANKS_PARAM_RTOL, RANKS_PARAM_ATOL = 2e-3, 5e-4
# the first step's gradients (relative L2): the gradient gate's bound,
# the trunks (feature_extractor*) at tests/test_torch_train_steps.py's
# trunk bound; ranks computing in TF32 (a fresh process's default) read
# 1.5e-2-0.12
RANKS_GRAD_RTOL_L2 = 1e-2
RANKS_TRUNK_GRAD_RTOL_L2 = 3e-2
# after an Adam step, per tensor in relative L2, the next step's
# gradients and the update theta_after - theta_init (tests/test_torch_
# parallel.py's bounds: Adam's first step moves every weight by +-lr, so
# rounding in a near-zero gradient moves that weight by 2 lr)
RANKS_LOOP_GRAD_RTOL_L2 = 0.3
RANKS_UPDATE_RTOL_L2 = 0.4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call by CUDA events around ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def frame_diff(a, b) -> dict:
    import numpy as np

    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    return {"max": int(d.max()), "frac_diff": float((d > 0).mean()),
            "frac_diff_gt1": float((d > 1).mean())}


def log_sass_ops():
    """Each probe's float32 operations as its SASS shows them:
    {probe: (operations, {opcode: count})}, an FFMA counting two. A
    probe's only other instructions load, index and store."""
    from stabstitch2_tpu_torch.utils import cuda_build

    nvcc = cuda_build.nvcc_path()
    d = os.path.join(cuda_build.BUILD_DIR, "log_probes")
    os.makedirs(d, exist_ok=True)
    src, cubin = os.path.join(d, "probes.cu"), os.path.join(d, "probes.cubin")
    with open(src, "w") as f:
        f.write(LOG_PROBES)
    subprocess.run([nvcc, "-cubin", "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-I", cuda_build.CSRC, "-o", cubin, src],
                   check=True, capture_output=True)
    sass = subprocess.run([os.path.join(os.path.dirname(nvcc), "cuobjdump"),
                           "-sass", cubin], check=True, capture_output=True,
                          text=True).stdout
    out = {}
    for body in sass.split("Function : ")[1:]:
        name = body.split()[0]
        hist = collections.Counter(
            m.group(1) for m in re.finditer(
                r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9]*)",
                body))
        fp32 = {k: v for k, v in hist.items() if k in FP32_OPCODES}
        require(fp32.get("FFMA", 0) > 0, f"{name} SASS has no FFMA: {hist}")
        out[name] = (sum(fp32.values()) + fp32.get("FFMA", 0), fp32)
    require(set(out) == {"logf_probe", "log_core_probe"},
            f"log probes in the SASS: {sorted(out)}")
    return out


def phase_stitch(device, clip):
    """The float32 stitch, counted: returns the stitcher and its result."""
    import numpy as np
    import torch

    from stabstitch2_tpu_torch.ops import corr_cuda, fused_warp_cuda
    from stabstitch2_tpu_torch.pipeline.stitcher import init_stitcher

    v1, v2 = clip
    st = init_stitcher(rng_seed=0, compute_dtype=torch.float32, device=device)
    st.stitch_arrays(v1, None, v2, None)          # warm-up: cuDNN, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    corr_cuda.LAUNCHES.clear()
    fused_warp_cuda.LAUNCHES.clear()
    t0 = time.perf_counter()
    res = st.stitch_arrays(v1, None, v2, None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"cost_volume_r5": corr_cuda.LAUNCHES[5],
                "cost_volume_r3": corr_cuda.LAUNCHES[3],
                "fused_warp": fused_warp_cuda.LAUNCHES["fused_warp"]}
    require(all(n > 0 for n in launches.values()),
            f"every kernel launched on the main path: {launches}")
    f = res.frames
    require(f.shape[0] == T_FRAMES and f.dtype == np.uint8, "frame shape")
    require(f.shape[1] >= v1.shape[1] // 2 and f.shape[2] >= v1.shape[2] // 2,
            "canvas covers the views")
    require(f.max() > 0 and np.isfinite(f).all(), "frames finite, not all 0")
    for k in ("smooth_mesh1", "smooth_mesh2"):
        require(bool(torch.isfinite(getattr(res, k)).all()), f"{k} finite")
    info = {"phase": "stitch", "frames": int(f.shape[0]),
            "frame_hw": [int(v1.shape[1]), int(v1.shape[2])],
            "canvas_hw": [res.canvas.out_h, res.canvas.out_w],
            "padded_canvas_hw": [res.canvas.pad_h, res.canvas.pad_w],
            "wall_s": wall, "fps": T_FRAMES / wall,
            "phase_ms": res.ms, "launches": launches,
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "frames_mean": float(f.mean())}
    return st, res, info


def k1_case(r, shape, launches, device):
    """K1 against its plain version at one main-path shape."""
    import numpy as np
    import torch

    from stabstitch2_tpu_torch.ops import corr_cuda

    rng = np.random.default_rng(r)
    x1, x2 = (torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))
              .to(device) for _ in range(2))
    got = corr_cuda.cost_volume_cuda(x1, x2, r)
    ref = corr_cuda.cost_volume_plain(x1, x2, r)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    require(err <= CV_ATOL + 1e-5 * float(ref.abs().max()),
            f"cost_volume r={r}: max|d| {err} vs plain")
    B, H, W, C = shape
    k2 = (2 * r + 1) ** 2
    nbytes = 2 * B * H * W * C * 4 + B * H * W * k2 * 4
    ops = B * H * W * k2 * (2 * C + 2)
    bms, by = bound(nbytes, ops)
    ms = time_ms(lambda: corr_cuda.cost_volume_cuda(x1, x2, r), 50)
    plain_ms = time_ms(lambda: corr_cuda.cost_volume_plain(x1, x2, r), 5, 1)
    return {"search_range": r, "shape": list(shape), "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "bytes": nbytes, "ops": ops,
            "roofline_share": bms / ms}


def k1_entry(cases):
    """K1's entry: per-launch numbers weighted by the main path's launches
    of each case; the bound is that of the cases' summed bytes and
    operations, per launch."""
    n = sum(c["launches"] for c in cases)

    def mean(k):
        return sum(c["launches"] * c[k] for c in cases) / n

    bms, by = bound(sum(c["launches"] * c["bytes"] for c in cases) / n,
                    sum(c["launches"] * c["ops"] for c in cases) / n)
    ms = mean("ms")
    return {"name": "cost_volume", "route": "cuda",
            "source": "stabstitch2_tpu_torch/csrc/cost_volume.cu",
            "replaces": "stabstitch2_tpu/ops/pallas_corr.py:37",
            "launches": n, "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": ms, "plain_ms": mean("plain_ms"), "bound_ms": bms,
            "bound_by": by, "library_ms": None,
            "library_note": "no single PyTorch call computes a local "
                            "correlation volume",
            "roofline_share": bms / ms, "cases": cases}


def first_chunk(st, res, clip):
    """The warp kernels' inputs on the main path's first chunk: the two
    views stacked [2n, H, W, 3], T, source, the padded canvas and the
    true extent."""
    import numpy as np
    import torch

    from stabstitch2_tpu_torch.pipeline.compositor import (scale_meshes,
                                                           warp_inputs)

    v1, v2 = clip
    dev = st.device
    c, n = res.canvas, st.chunk
    H, W = v1.shape[1:3]
    m1 = scale_meshes(res.smooth_mesh1, H, W, st.model_h, st.model_w)[:n]
    m2 = scale_meshes(res.smooth_mesh2, H, W, st.model_h, st.model_w)[:n]
    offset = torch.tensor([c.x_min, c.y_min], dtype=torch.float32, device=dev)
    span = (np.float32(c.out_h), np.float32(c.out_w))
    im, T, src = warp_inputs(torch.from_numpy(v1[:n]).to(dev),
                             torch.from_numpy(v2[:n]).to(dev), m1, m2,
                             offset, span)
    return im, T, src, (c.pad_h, c.pad_w), span


def spline_ops(images, size, P, log_ops):
    """Float32 operations of the TPS spline at every pixel of `images`
    canvases of `size`: (X - sx_p)^2 once per column and point and
    (Y - sy_p)^2 once per row and point (2 each; X depends only on the
    column, Y only on the row), then per pixel the affine part (4 per
    coordinate) and per pixel and point the sum of the squares, +1e-6,
    the log (log_ops), a product and a multiply and an add per
    coordinate (7 + log_ops)."""
    oh, ow = size
    return images * (2 * P * (oh + ow)
                     + oh * ow * (8 + P * (7 + log_ops)))


def k2_entry(st, res, clip, launches, log_ops):
    """K2 against its plain version on the first chunk of the main path."""
    import torch

    from stabstitch2_tpu_torch.ops import fused_warp_cuda
    from stabstitch2_tpu_torch.ops.interp import support_mask
    from stabstitch2_tpu_torch.ops.tps import tps_coords_plain

    t0 = time.perf_counter()
    log_bad, log_first = fused_warp_cuda.log_core_check(st.device)
    log_s = time.perf_counter() - t0
    require(log_bad == 0, f"log_core differs from logf on {log_bad} float32s "
                          f"from 1e-6 to FLT_MAX, first bits {log_first}")
    im, T, src, size, span = first_chunk(st, res, clip)
    H, W = im.shape[1:3]
    got = fused_warp_cuda.fused_warp_planes(im, T, src, size, grid_span=span)
    ref = fused_warp_cuda.fused_warp_planes_plain(im, T, src, size,
                                                  grid_span=span)
    torch.cuda.synchronize()
    g = torch.stack(got[:3], -1)
    r = torch.stack(ref[:3], -1)
    mask_err = float((got[3] - ref[3]).abs().max())
    err = max(float((g - r).abs().max()), mask_err)
    lsb = int((g.round().clamp(0, 255) != r.round().clamp(0, 255)).sum())
    lsb_max = float((g.round().clamp(0, 255) - r.round().clamp(0, 255))
                    .abs().max())
    x_s, y_s = tps_coords_plain(T, src, size, grid_span=span)
    live = support_mask(x_s, y_s, H, W).reshape(im.shape[0], *size)
    dead_nonzero = int((g[~live] != 0).any(-1).sum())
    require(lsb_max <= 1, f"fused_warp: {lsb_max} uint8 levels vs plain")
    require(dead_nonzero == 0, f"fused_warp: {dead_nonzero} nonzero dead px")
    require(mask_err <= MASK_ATOL, f"fused_warp: mask max|d| {mask_err}")
    require(err == 0, f"fused_warp: max|d| {err} vs plain (bit-equal "
                      "expected: the same float32 operations in the same "
                      "order)")
    require(not bool(got[4]), "fused_warp: viol is False")
    B2, P = im.shape[0], src.shape[1]
    npix = B2 * size[0] * size[1]
    n_live = int(live.sum())
    nbytes = (im.numel() + (T.numel() + src.numel() + size[0] + size[1]) * 4
              + B2 * 4 * size[0] * size[1] * 4)
    # the spline (spline_ops), corners/weights/mask/support 30 per pixel;
    # per live pixel: 3 channels x (4 multiplies + 3 adds)
    ops = spline_ops(B2, size, P, log_ops) + npix * 30 + n_live * 21
    bms, by = bound(nbytes, ops)
    ms = time_ms(lambda: fused_warp_cuda.fused_warp_planes(
        im, T, src, size, grid_span=span), 20)
    plain_ms = time_ms(lambda: fused_warp_cuda.fused_warp_planes_plain(
        im, T, src, size, grid_span=span), 3, 1)
    return {"name": "fused_warp", "route": "cuda",
            "source": "stabstitch2_tpu_torch/csrc/fused_warp.cu",
            "replaces": "stabstitch2_tpu/ops/pallas_fused.py:94",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": None,
            "library_note": "no single PyTorch call evaluates a TPS spline "
                            "and samples with it (grid_sample takes "
                            "coordinates)",
            "images": B2, "source_hw": [int(H), int(W)],
            "canvas_hw": list(size), "control_points": P,
            "u8_lsb_diff_count": lsb, "dead_nonzero": dead_nonzero,
            "mask_max_abs_err": mask_err, "mask_atol": MASK_ATOL,
            "live_frac": n_live / npix, "log_ops": log_ops,
            "log_core_check": {
                "float32s": fused_warp_cuda.LOG_CHECK_HI
                - fused_warp_cuda.LOG_CHECK_LO + 1,
                "from_bits": hex(fused_warp_cuda.LOG_CHECK_LO),
                "to_bits": hex(fused_warp_cuda.LOG_CHECK_HI),
                "mismatches": log_bad, "seconds": log_s},
            "bytes": nbytes, "ops": ops,
            "roofline_share": bms / ms}


def k3_entry(st, res, clip, launches, log_ops):
    """K3 against its plain version on the first chunk of the main path:
    exactly equal (the same float32 operations in the same order)."""
    import torch

    from stabstitch2_tpu_torch.ops import tps_coords_cuda

    im, T, src, size, span = first_chunk(st, res, clip)
    got = tps_coords_cuda.tps_coords(T, src, size, grid_span=span)
    ref = tps_coords_cuda.tps_coords_plain(T, src, size, grid_span=span)
    torch.cuda.synchronize()
    err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    require(err == 0, f"tps_coords: max|d| {err} vs plain (0 expected)")
    B2, P = im.shape[0], src.shape[1]
    npix = B2 * size[0] * size[1]
    nbytes = (T.numel() + src.numel() + size[0] + size[1]) * 4 + 2 * npix * 4
    ops = spline_ops(B2, size, P, log_ops)
    bms, by = bound(nbytes, ops)
    ms = time_ms(lambda: tps_coords_cuda.tps_coords(T, src, size,
                                                    grid_span=span), 20)
    plain_ms = time_ms(lambda: tps_coords_cuda.tps_coords_plain(
        T, src, size, grid_span=span), 3, 1)
    return {"name": "tps_coords", "route": "cuda",
            "source": "stabstitch2_tpu_torch/csrc/tps_coords.cu",
            "replaces": "stabstitch2_tpu/ops/pallas_warp.py:31",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": None,
            "library_note": "no single PyTorch call evaluates a TPS spline",
            "images": B2, "canvas_hw": list(size), "control_points": P,
            "log_ops": log_ops, "bytes": nbytes, "ops": ops,
            "roofline_share": bms / ms}


def k4_entry(st, res, clip, launches):
    """K4 against its plain version in both layouts, at the coordinates K3
    gives the main path's first chunk; F.grid_sample is the yardstick."""
    import torch
    import torch.nn.functional as F

    from stabstitch2_tpu_torch.ops import patch_gather_cuda, tps_coords_cuda
    from stabstitch2_tpu_torch.ops.interp import support_mask

    im, T, src, size, span = first_chunk(st, res, clip)
    B2, H, W, _ = im.shape
    x, y = tps_coords_cuda.tps_coords_plain(T, src, size, grid_span=span)
    x, y = x.contiguous(), y.contiguous()
    live = support_mask(x, y, H, W).reshape(B2, *size)
    errs, dead = {}, {}
    for planes in (False, True):
        got = patch_gather_cuda.bilinear_sample_patch_u8_cuda(
            im, x, y, size, planes=planes)
        ref = patch_gather_cuda.patch_gather_plain(im, x, y, size, planes)
        torch.cuda.synchronize()
        require(not bool(got[-1]), "patch_gather: viol is False")
        g = torch.stack(got[:3], -1) if planes else got[0]
        r = torch.stack(ref[:3], -1) if planes else ref[0]
        key = "planes" if planes else "interleaved"
        errs[key] = float((g - r).abs().max())
        dead[key] = int((g[~live] != 0).any(-1).sum())
        require(torch.equal(g, r),
                f"patch_gather {key}: max|d| {errs[key]} vs plain (0 "
                "expected)")
        require(dead[key] == 0, f"patch_gather {key}: {dead[key]} nonzero "
                                "dead px")
    npix = B2 * size[0] * size[1]
    n_live = int(live.sum())
    nbytes = im.numel() + 2 * npix * 4 + 3 * npix * 4
    # per pixel: corners, weights and support 27; per live pixel:
    # 3 channels x (4 multiplies + 3 adds)
    ops = npix * 27 + n_live * 21
    bms, by = bound(nbytes, ops)
    ms = time_ms(lambda: patch_gather_cuda.bilinear_sample_patch_u8_cuda(
        im, x, y, size), 50)
    plain_ms = time_ms(lambda: patch_gather_cuda.patch_gather_plain(
        im, x, y, size), 5, 1)
    img = im.permute(0, 3, 1, 2).to(torch.float32).contiguous()
    grid = torch.stack([x, y], -1).reshape(B2, *size, 2)
    library_ms = time_ms(lambda: F.grid_sample(
        img, grid, mode="bilinear", padding_mode="zeros",
        align_corners=False), 50)
    turns = k4_in_turns(
        lambda: patch_gather_cuda.bilinear_sample_patch_u8_cuda(
            im, x, y, size),
        lambda: F.grid_sample(img, grid, mode="bilinear",
                              padding_mode="zeros", align_corners=False))
    edges = k4_edges(im.device, H, W)
    return {"name": "patch_gather", "route": "cuda",
            "source": "stabstitch2_tpu_torch/csrc/patch_gather.cu",
            "replaces": "stabstitch2_tpu/ops/pallas_gather.py:72",
            "launches": launches,
            "max_abs_err": max(*errs.values(),
                               *(r["max_abs_err"] for r in edges)),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": library_ms,
            "library_note": "F.grid_sample(bilinear, zeros, "
                            "align_corners=False) on the float32 NCHW image "
                            "at the same coordinates: the same four-corner "
                            "gather and combine per pixel, with another "
                            "border rule and float input",
            "max_abs_err_by_layout": errs, "dead_nonzero": dead,
            "atol": 0.0, "edge_cases": edges,
            "images": B2, "source_hw": [int(H), int(W)],
            "canvas_hw": list(size), "live_frac": n_live / npix,
            "bytes": nbytes, "ops": ops, "roofline_share": bms / ms,
            "in_turns_with_grid_sample": turns}


# K4's edges that the main path's canvas (N % 4 == 0, fresh tensors)
# never reaches: B, the raster (N % 4 of 1, 2, 3), the coordinates one
# float into their buffers (4-byte but not 16-byte aligned) and the source
# one byte into its (first and last bytes not word-aligned)
K4_EDGE_CASES = ((1, (97, 131), True, False),
                 (17, (98, 131), True, True),
                 (2, (101, 133), False, False),
                 (3, (97, 129), False, True))


def offset_copy(a):
    """A contiguous copy of ``a`` one element into a larger buffer."""
    import torch

    buf = torch.empty(a.numel() + 1, dtype=a.dtype, device=a.device)
    view = buf[1:].view(a.shape)
    view.copy_(a)
    return view


def k4_edges(device, H, W):
    """K4 against its plain version bit for bit, in both layouts, on
    K4_EDGE_CASES: random H x W sources sampled on a raster spread 10%
    past every side (corners clamped at the right and bottom edges, pixels
    dead beyond them), with NaN coordinates (exact 0). Quads of B = 17
    straddle two images. One row per case; raises on any difference."""
    import numpy as np
    import torch

    from stabstitch2_tpu_torch.ops import patch_gather_cuda
    from stabstitch2_tpu_torch.ops.interp import support_mask

    rng = np.random.default_rng(16)
    rows = []
    for B, (oh, ow), off_xy, off_im in K4_EDGE_CASES:
        N = oh * ow
        im = torch.from_numpy(rng.integers(0, 256, (B, H, W, 3),
                                           dtype=np.uint8)).to(device)
        x = (np.tile(np.linspace(-1.1, 1.1, ow), oh)
             + rng.normal(0, 0.004, (B, N))).astype(np.float32)
        y = (np.repeat(np.linspace(-1.1, 1.1, oh), ow)
             + rng.normal(0, 0.004, (B, N))).astype(np.float32)
        x[:, ::97] = np.nan
        x, y = torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)
        if off_xy:
            x, y = offset_copy(x), offset_copy(y)
        if off_im:
            im = offset_copy(im)
        live = support_mask(x, y, H, W)
        errs = {}
        for planes in (False, True):
            got = patch_gather_cuda.bilinear_sample_patch_u8_cuda(
                im, x, y, (oh, ow), planes=planes)
            ref = patch_gather_cuda.patch_gather_plain(im, x, y, (oh, ow),
                                                       planes)
            torch.cuda.synchronize()
            g = torch.stack(got[:3], -1) if planes else got[0]
            r = torch.stack(ref[:3], -1) if planes else ref[0]
            key = "planes" if planes else "interleaved"
            errs[key] = float((g - r).abs().max())
            require(torch.equal(g, r) and not bool(got[-1]),
                    f"patch_gather {key} at B={B}, {oh}x{ow}, offset "
                    f"coordinates {off_xy}, offset source {off_im}: max|d| "
                    f"{errs[key]} vs plain (0 expected)")
        rows.append({"B": B, "raster": [oh, ow], "n_mod_4": N % 4,
                     "xy_ptr_mod_16": x.data_ptr() % 16,
                     "source_ptr_mod_4": im.data_ptr() % 4,
                     "live_frac": float(live.float().mean()),
                     "max_abs_err": max(errs.values()),
                     "max_abs_err_by_layout": errs})
    return rows


def k4_in_turns(k4, library, rounds: int = K4_ROUNDS, iters: int = 50):
    """K4 and F.grid_sample timed in turns, ``rounds`` times, three ways:
    ``as_timed`` as ``time_ms`` times them (CUDA events around ``iters``
    calls issued from the host, so a host slower than the kernel shows in
    the time); ``queued``, the same calls issued while the card sleeps
    first, so the events see the device time alone; ``l2_flushed``, one
    queued call after writing a buffer twice the L2's size. Also the
    host's milliseconds to issue one call. Each as median, min and max
    over the rounds."""
    import numpy as np
    import torch

    flush = torch.empty(2 * L2_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    # a sleep longer than issuing `iters` calls takes the host (~0.1 ms each)
    sleep_cycles = int(2e9 * iters * 1e-4 * 4)

    def events(fn, n, sleep, flush_first):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if flush_first:
            flush.zero_()
        if sleep:
            torch.cuda._sleep(sleep_cycles)
        a.record()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        host = (time.perf_counter() - t0) * 1e3 / n
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / n, host

    fns = {"patch_gather": k4, "grid_sample": library}
    runs = {(k, m): [] for k in fns
            for m in ("as_timed", "queued", "l2_flushed", "host_issue")}
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    for _ in range(rounds):
        for k, fn in fns.items():
            ms, host = events(fn, iters, False, False)
            runs[k, "as_timed"].append(ms)
            runs[k, "host_issue"].append(host)
            runs[k, "queued"].append(events(fn, iters, True, False)[0])
            runs[k, "l2_flushed"].append(events(fn, 1, True, True)[0])

    def stat(v):
        return {"median": float(np.median(v)), "min": float(min(v)),
                "max": float(max(v))}

    return {"rounds": rounds, "iters": iters,
            **{f"{k}_{m}_ms": stat(v) for (k, m), v in runs.items()}}


def plain_fused_yuv420(st, res, clip):
    """Route A's yuv420 frames from the plain path on the card: the plain
    K2 version, AVERAGE fusion, clip, ``bgr_to_yuv420``, packed I420."""
    import numpy as np
    import torch

    from stabstitch2_tpu_torch.ops.blend import average_fusion
    from stabstitch2_tpu_torch.ops.fused_warp_cuda import fused_warp_planes_plain
    from stabstitch2_tpu_torch.ops.yuv import bgr_to_yuv420, pack_i420
    from stabstitch2_tpu_torch.pipeline.compositor import (compute_canvas,
                                                           scale_meshes,
                                                           warp_inputs)

    v1, v2 = clip
    dev, n = st.device, st.chunk
    H, W = v1.shape[1:3]
    m1 = scale_meshes(res.smooth_mesh1, H, W, st.model_h, st.model_w)
    m2 = scale_meshes(res.smooth_mesh2, H, W, st.model_h, st.model_w)
    c = compute_canvas(m1, m2, st.config.canvas_bucket)
    span = (np.float32(c.out_h), np.float32(c.out_w))
    oh, ow = c.out_h // 2 * 2, c.out_w // 2 * 2
    offset = torch.tensor([c.x_min, c.y_min], dtype=torch.float32, device=dev)
    out = []
    for s in range(0, v1.shape[0], n):
        im, T, src = warp_inputs(torch.from_numpy(v1[s:s + n]).to(dev),
                                 torch.from_numpy(v2[s:s + n]).to(dev),
                                 m1[s:s + n], m2[s:s + n], offset, span)
        pb, pg, pr, _, _ = fused_warp_planes_plain(im, T, src,
                                                   (c.pad_h, c.pad_w), span)
        w = torch.stack([pb, pg, pr], -1)
        b = w.shape[0] // 2
        fused = torch.clamp(average_fusion(w[:b], w[b:]), 0.0, 255.0)
        y, u, v = bgr_to_yuv420(fused)
        out.append(pack_i420(y[:, :oh, :ow], u[:, :oh // 2, :ow // 2],
                             v[:, :oh // 2, :ow // 2]).cpu().numpy())
    return np.concatenate(out, 0)


def phase_routes(device, clip, st, res):
    """Route B at full width, counted, then the routes on the stitch
    phase's smooth meshes (see the module docstring)."""
    import numpy as np
    import torch

    from stabstitch2_tpu_torch.config import StitchConfig
    from stabstitch2_tpu_torch.ops import (corr_cuda, fused_warp_cuda,
                                           patch_gather_cuda, tps_coords_cuda)
    from stabstitch2_tpu_torch.ops.yuv import bgr_u8_to_yuv420, pack_i420
    from stabstitch2_tpu_torch.pipeline.compositor import composite_video
    from stabstitch2_tpu_torch.pipeline.stitcher import init_stitcher

    v1, v2 = clip
    cfg_b = StitchConfig(fused_warp=False, download_format="yuv420")
    sb = init_stitcher(rng_seed=0, config=cfg_b, compute_dtype=torch.float32,
                       device=device)
    sb.stitch_arrays(v1, None, v2, None)          # warm-up
    torch.cuda.synchronize()
    counters = (corr_cuda, fused_warp_cuda, tps_coords_cuda,
                patch_gather_cuda)
    for c in counters:
        c.LAUNCHES.clear()
    t0 = time.perf_counter()
    rb = sb.stitch_arrays(v1, None, v2, None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"cost_volume_r5": corr_cuda.LAUNCHES[5],
                "cost_volume_r3": corr_cuda.LAUNCHES[3],
                "fused_warp": fused_warp_cuda.LAUNCHES["fused_warp"],
                "tps_coords": tps_coords_cuda.LAUNCHES["tps_coords"],
                "patch_gather": patch_gather_cuda.LAUNCHES["patch_gather"]}
    require(launches["tps_coords"] > 0 and launches["patch_gather"] > 0
            and launches["fused_warp"] == 0,
            f"route B launched K3 and K4 and not K2: {launches}")
    f, cb = rb.frames, rb.canvas
    require(rb.frame_format == "i420" and f.dtype == np.uint8
            and f.shape == (T_FRAMES, cb.out_h * 3 // 2, cb.out_w)
            and cb.out_h % 2 == 0 and cb.out_w % 2 == 0,
            f"route B yuv420 frames {f.shape} {f.dtype} {rb.frame_format}")
    require(f.max() > 0, "route B frames not all 0")
    mesh_err = max(float((getattr(rb, k) - getattr(res, k)).abs().max())
                   for k in ("smooth_mesh1", "smooth_mesh2"))
    require(mesh_err <= MESH_ATOL_PX, f"route B run's meshes {mesh_err} px")

    size = (st.model_h, st.model_w)

    def comp(v1_, v2_, m1, m2, **cfg):
        return composite_video(v1_, v2_, m1, m2, config=StitchConfig(**cfg),
                               chunk=st.chunk, model_size=size)[0]

    m1, m2 = res.smooth_mesh1, res.smooth_mesh2
    b_vs_a, bgr_b = {}, {}
    for mode in ("AVERAGE", "LINEAR"):
        a = (res.frames if mode == st.config.fusion_mode
             else comp(v1, v2, m1, m2, fusion_mode=mode))
        bgr_b[mode] = comp(v1, v2, m1, m2, fusion_mode=mode, fused_warp=False)
        d = b_vs_a[mode] = frame_diff(bgr_b[mode], a)
        require(d["max"] == 0, f"route B vs route A {mode} bgr: {d}")
    yuv_b = comp(v1, v2, m1, m2, fused_warp=False, download_format="yuv420")
    oh, ow = yuv_b.shape[1] * 2 // 3, yuv_b.shape[2]
    conv = bgr_u8_to_yuv420(torch.from_numpy(
        np.ascontiguousarray(bgr_b["AVERAGE"][:, :oh, :ow])).to(device))
    want_b = pack_i420(*conv).cpu().numpy()
    yuv_b_diff = frame_diff(yuv_b, want_b)
    require(yuv_b_diff["max"] == 0,
            f"route B yuv420 vs bgr_u8_to_yuv420(route B bgr): {yuv_b_diff}")
    yuv_a = comp(v1, v2, m1, m2, download_format="yuv420")
    want_a = plain_fused_yuv420(st, res, clip)
    require(yuv_a.shape == want_a.shape, f"route A yuv420 {yuv_a.shape}")
    yuv_a_diff = frame_diff(yuv_a, want_a)
    require(yuv_a_diff["max"] == 0,
            f"route A yuv420 vs bgr_to_yuv420(plain fusion): {yuv_a_diff}")

    n = CPU_FRAMES
    card_vs_cpu = {}
    for name, cfg in (("FAST", dict(warp_mode="FAST")),
                      ("coord_stride_4", dict(coord_stride=4))):
        card = comp(v1[:n], v2[:n], m1[:n], m2[:n], **cfg)
        cpu = comp(v1[:n], v2[:n], m1[:n].cpu(), m2[:n].cpu(), **cfg)
        d = card_vs_cpu[name] = frame_diff(card, cpu)
        require(d["frac_diff"] <= FRAC_DIFF
                and d["frac_diff_gt1"] <= FRAC_DIFF_GT1,
                f"{name} composite, card vs cpu on the same meshes: {d}")
    return {"phase": "routes", "route": "B (fused_warp=False), yuv420",
            "frames": int(f.shape[0]),
            "canvas_hw": [cb.out_h, cb.out_w],
            "padded_canvas_hw": [cb.pad_h, cb.pad_w],
            "wall_s": wall, "fps": T_FRAMES / wall, "phase_ms": rb.ms,
            "launches": launches, "smooth_mesh_max_abs_px_vs_stitch": mesh_err,
            "route_b_vs_a_bgr": b_vs_a, "route_b_yuv420_vs_chain": yuv_b_diff,
            "route_a_yuv420_vs_plain": yuv_a_diff,
            "card_vs_cpu_frames": card_vs_cpu, "cpu_frames": n,
            "frac_diff_max": FRAC_DIFF, "frac_diff_gt1_max": FRAC_DIFF_GT1}


def phase_resize(device, st):
    """lo=None at 480x640 for the 360x480 model: the main path with the
    model input resized on the card, counted, and that input against the
    CPU port's."""
    import numpy as np
    import torch

    from stabstitch2_tpu_torch.ops import corr_cuda, fused_warp_cuda
    from stabstitch2_tpu_torch.pipeline.stitcher import model_input
    from synthetic import make_two_view_clip

    v1, v2 = make_two_view_clip(num_frames=T_FRAMES, height=480, width=640,
                                overlap=0.5, shake_px=4.0, seed=1)
    torch.cuda.synchronize()
    corr_cuda.LAUNCHES.clear()
    fused_warp_cuda.LAUNCHES.clear()
    t0 = time.perf_counter()
    res = st.stitch_arrays(v1, None, v2, None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"cost_volume_r5": corr_cuda.LAUNCHES[5],
                "cost_volume_r3": corr_cuda.LAUNCHES[3],
                "fused_warp": fused_warp_cuda.LAUNCHES["fused_warp"]}
    require(all(n > 0 for n in launches.values()),
            f"every kernel launched on the lo=None path: {launches}")
    f = res.frames
    require(f.shape[0] == T_FRAMES and f.dtype == np.uint8 and f.max() > 0,
            f"lo=None frames {f.shape} {f.dtype}")
    for k in ("smooth_mesh1", "smooth_mesh2"):
        require(bool(torch.isfinite(getattr(res, k)).all()), f"{k} finite")
    size = (st.model_h, st.model_w)
    card = model_input(torch.from_numpy(v1).to(device), *size).cpu()
    cpu = model_input(torch.from_numpy(v1), *size)
    err = float((card - cpu).abs().max())
    require(card.shape == (T_FRAMES, *size, 3) and err <= RESIZE_ATOL,
            f"model input on the card vs the CPU: {tuple(card.shape)}, "
            f"max|d| {err}")
    return {"phase": "resize", "frames": T_FRAMES, "frame_hw": [480, 640],
            "model_hw": list(size), "canvas_hw": [res.canvas.out_h,
                                                  res.canvas.out_w],
            "wall_s": wall, "fps": T_FRAMES / wall, "phase_ms": res.ms,
            "launches": launches, "model_input_max_abs_err_vs_cpu": err,
            "atol": RESIZE_ATOL}


def phase_cpu_compare(st_cuda, clip):
    """The port on the CPU over the first frames against the card.

    Smooth meshes agree within MESH_ATOL_PX (float32 convolutions and
    solves round differently on the two devices). Frames are compared on
    the same meshes, with AVERAGE fusion (the stitcher's) and LINEAR
    fusion (which weighs the views by blurred coverage masks, so a wrong
    K2 mask shows): <= FRAC_DIFF of the values differ at all and
    <= FRAC_DIFF_GT1 by more than one level (view-border pixels whose
    sample point lies within rounding of the image edge are live on one
    device and dead on the other).
    """
    import torch

    from stabstitch2_tpu_torch.config import StitchConfig
    from stabstitch2_tpu_torch.pipeline.compositor import composite_video
    from stabstitch2_tpu_torch.pipeline.stitcher import init_stitcher

    v1, v2 = (v[:CPU_FRAMES] for v in clip)
    st_cpu = init_stitcher(rng_seed=0, compute_dtype=torch.float32,
                           device="cpu")
    a = st_cpu.stitch_arrays(v1, None, v2, None)
    b = st_cuda.stitch_arrays(v1, None, v2, None)
    mesh_err = max(float((getattr(a, k) - getattr(b, k).cpu()).abs().max())
                   for k in ("smooth_mesh1", "smooth_mesh2"))
    require(mesh_err <= MESH_ATOL_PX, f"cpu vs cuda smooth meshes {mesh_err} px")
    same = {}
    size = (st_cpu.model_h, st_cpu.model_w)
    for mode in ("AVERAGE", "LINEAR"):
        cfg = StitchConfig(fusion_mode=mode)
        card = (b.frames if mode == st_cuda.config.fusion_mode else
                composite_video(v1, v2, b.smooth_mesh1, b.smooth_mesh2,
                                config=cfg, chunk=st_cuda.chunk,
                                model_size=size)[0])
        cpu, _ = composite_video(v1, v2, b.smooth_mesh1.cpu(),
                                 b.smooth_mesh2.cpu(), config=cfg,
                                 chunk=st_cpu.chunk, model_size=size)
        d = same[mode] = frame_diff(cpu, card)
        require(d["frac_diff"] <= FRAC_DIFF
                and d["frac_diff_gt1"] <= FRAC_DIFF_GT1,
                f"cpu vs cuda {mode} composite on the same meshes: {d}")
    out = {"phase": "cpu_compare", "frames": CPU_FRAMES,
           "smooth_mesh_max_abs_px": mesh_err, "mesh_atol_px": MESH_ATOL_PX,
           "same_mesh_frames": same, "frac_diff_max": FRAC_DIFF,
           "frac_diff_gt1_max": FRAC_DIFF_GT1,
           "canvas_equal": (a.canvas.out_h, a.canvas.out_w)
           == (b.canvas.out_h, b.canvas.out_w)}
    if out["canvas_equal"]:
        out["full_run_frames"] = frame_diff(a.frames, b.frames)
    return out


def mp4_frames(path: str) -> int:
    """Frames cv2 decodes from an mp4."""
    import cv2

    cap = cv2.VideoCapture(path)
    n = 0
    try:
        while cap.read()[0]:
            n += 1
    finally:
        cap.release()
    return n


def mesh_gap(a, b) -> float:
    return max(float((getattr(a, k) - getattr(b, k)).abs().max())
               for k in ("smooth_mesh1", "smooth_mesh2"))


def begin_waits(st, arrays):
    """The host waits for the card inside one ``stitch_begin`` at the
    stitcher's settings: the ``wait`` spans (``compositor.wait``, on
    events) under a host-only profiler, and the synchronizing calls that
    ``torch.cuda.set_sync_debug_mode("warn")`` reports. Only the canvas
    fetch should remain: one ``wait`` and no synchronizing call."""
    import warnings

    import torch
    from torch.profiler import ProfilerActivity, profile

    from stabstitch2_tpu_torch.utils import profiling

    profiling.clear_table()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with profile(activities=[ProfilerActivity.CPU]):
                pending = st.stitch_begin(*arrays)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    waits = profiling.table().spans.get("wait")
    st.stitch_finish(pending)
    return {"waits": waits.count if waits else 0,
            "synchronizing": [str(w.message).splitlines()[0] for w in caught
                              if "called a synchronizing" in str(w.message)]}


def one_wait(waits) -> bool:
    return waits["waits"] == 1 and not waits["synchronizing"]


def write_cli_data(tmp) -> str:
    """The cli phase's dataset: CLI_VIDEOS synthetic clips of CLI_FRAMES
    jpg frames per view at 360x480, under ``tmp``/data."""
    from synthetic import write_clip_dirs

    data = os.path.join(tmp, "data")
    for seed in range(CLI_VIDEOS):
        write_clip_dirs(data, num_frames=CLI_FRAMES, height=360, width=480,
                        seed=seed, video_name=f"clip{seed}")
    return data


def libjpeg_presence() -> dict:
    """Whether the host compiler finds libjpeg's header and links its
    library, and the libjpeg shared objects in the system library
    directories."""
    from stabstitch2_tpu_torch.utils import native_build

    cxx = native_build.compiler()
    with tempfile.TemporaryDirectory() as d:
        src, main = os.path.join(d, "h.cpp"), os.path.join(d, "m.cpp")
        with open(src, "w") as f:
            f.write("#include <cstdio>\n#include <jpeglib.h>\n")
        with open(main, "w") as f:
            f.write("int main() { return 0; }\n")
        header = subprocess.run([cxx, "-fsyntax-only", src],
                                capture_output=True).returncode == 0
        library = subprocess.run([cxx, main, "-o", os.path.join(d, "m"),
                                  "-ljpeg"], capture_output=True
                                 ).returncode == 0
    found = sorted({os.path.basename(p) for d in (
        "/usr/lib/x86_64-linux-gnu", "/lib/x86_64-linux-gnu", "/usr/lib64",
        "/usr/local/lib") for p in glob.glob(os.path.join(d, "libjpeg*.so*"))})
    return {"header_found": header, "library_links": library,
            "shared_objects": found}


def phase_loader(data):
    """The native frame loader (``data/native.py``): the g++ build's
    seconds, then the cli dataset's CLI_VIDEOS x 2 x CLI_FRAMES jpgs
    decoded by ``load_video_pair`` natively, by cv2, and by cv2 with the
    model-size resize that ``cli stitch`` made and dropped before this
    slice, LOADER_ROUNDS times in turns. Gate: the native frames against
    cv2's within LOADER_MEAN_LEVELS (mean) and LOADER_MAX_LEVELS (max).
    Where the build fails only because libjpeg's header or library is
    missing, the line says so with the compiler's message and what the
    compiler finds of libjpeg, times cv2 alone, and the run goes on with
    cv2; any other build failure fails the script."""
    import numpy as np

    from stabstitch2_tpu_torch.data import native
    from stabstitch2_tpu_torch.data.video_io import (list_videos,
                                                     load_video_pair)
    from stabstitch2_tpu_torch.utils import native_build

    t = time.perf_counter()
    ok = native.available()
    info = {"phase": "loader", "available": ok,
            "first_use_s": time.perf_counter() - t}
    if ok:
        info.update(build_s=native.BUILD.seconds, built=native.BUILD.built,
                    command=" ".join(native.BUILD.command), decoder="native")
    else:
        err = native.build_error()
        require(native_build.libjpeg_missing(err),
                f"the native frame loader builds: {err}")
        info.update(decoder="cv2", libjpeg_missing=[
            line.strip() for line in err.splitlines()
            if "jpeg" in line and ("No such file" in line
                                   or "cannot find" in line)],
            libjpeg=libjpeg_presence())
    videos = list_videos(data)

    def load(native_, size):
        t0 = time.perf_counter()
        got = [load_video_pair(vd, model_size=size, use_native=native_)
               for vd in videos]
        return got, time.perf_counter() - t0

    walls = {"native_s": [], "cv2_s": [], "cv2_with_resize_s": []}
    for _ in range(LOADER_ROUNDS):
        if ok:
            nat, s_nat = load(True, None)
            walls["native_s"].append(s_nat)
        ref, s_cv2 = load(False, None)
        _, s_old = load(False, (360, 480))
        walls["cv2_s"].append(s_cv2)
        walls["cv2_with_resize_s"].append(s_old)
    frames = sum(len(p[0]) + len(p[2]) for p in ref)
    info.update(jpgs=frames, frame_hw=[360, 480], wall_s=walls,
                fps={k: [frames / w for w in v] for k, v in walls.items()})
    if not ok:
        return info
    diffs = [np.abs(a.astype(np.int16) - b.astype(np.int16))
             for pn, pr in zip(nat, ref) for a, b in ((pn[0], pr[0]),
                                                      (pn[2], pr[2]))]
    mean = float(np.mean([d.mean() for d in diffs]))
    worst = int(max(d.max() for d in diffs))
    require(mean < LOADER_MEAN_LEVELS and worst <= LOADER_MAX_LEVELS,
            f"native frames against cv2: mean {mean}, max {worst}")
    return {**info, "native_vs_cv2_levels": {
        "mean": mean, "max": worst, "bound_mean": LOADER_MEAN_LEVELS,
        "bound_max": LOADER_MAX_LEVELS}}


def phase_cli(device, tmp, data):
    """``cli stitch`` at its defaults, through the functions the CLI runs
    (``build_stitcher`` of the default flags, the loader thread with the
    native decoder, the two-deep ``stitch_stream``, the mp4 sink) over
    the CLI_VIDEOS clips of CLI_FRAMES frames at 360x480 in ``data``; in
    turns: the pipelined loop, the same videos one at a time (load,
    ``stitch_arrays``, encode), and the pipelined loop with
    ``upload_mode="stream"``, each in bulk at the defaults (``fused_motion``:
    phases 1-4 replayed from CUDA graphs) and with ``--eager_motion``.
    ``load_s`` times the decode and I420 packing
    of all videos on one thread. The launch counts are set to 0 just
    before the first pipelined run and read just after, and again around
    the first stream run and the first eager pipelined run; the graphs'
    replays and the launches they made are read around the first
    pipelined run, per video. Gates: every mp4 holds CLI_FRAMES frames; the
    pipelined frames equal ``stitch_arrays``' bit for bit, the stream
    frames the bulk ones and the eager frames and meshes the fused ones;
    the fused run replayed graphs, and launched K1 and K2 as often as the
    eager run; the view loads of the pipelined run went
    through the decoder the loader phase built; the bf16 smooth meshes lie
    within BF16_MESH_BOUND_PX of a float32 stitcher's on each clip; one
    ``stitch_begin`` waits for the card once (the canvas fetch), in bulk
    and in stream mode."""
    import torch

    from stabstitch2_tpu_torch import cli
    from stabstitch2_tpu_torch.data import native
    from stabstitch2_tpu_torch.data.video_io import DECODED, list_videos
    from stabstitch2_tpu_torch.ops import corr_cuda, fused_warp_cuda
    from stabstitch2_tpu_torch.pipeline.stitcher import init_stitcher

    out = os.path.join(tmp, "out")
    args = cli.make_parser().parse_args(["stitch", "--test_path", data,
                                         "--output_path", out])
    st = cli.build_stitcher(args)
    videos = list_videos(data)
    t0 = time.perf_counter()
    loaded = {os.path.basename(vd): arrays
              for vd, arrays, _ in cli.load_videos(videos)}
    load_s = time.perf_counter() - t0
    require(all(a[0].ndim == 3 for a in loaded.values()),
            "default upload is packed I420")
    st.stitch_arrays(*loaded["clip0"])            # warm-up: cuDNN, allocator
    mp4 = cli.mp4_sink(out)

    def pipelined():
        got = {}

        def sink(name, result):
            mp4(name, result)
            got[name] = result

        t0 = time.perf_counter()
        done, failed = cli.stitch_stream(
            st, cli.threaded(cli.load_videos(videos)), sink)
        torch.cuda.synchronize()
        require((done, failed) == (CLI_VIDEOS, 0),
                f"pipelined run stitched {done}, failed {failed}")
        return got, time.perf_counter() - t0

    def streamed():
        st.upload_mode = "stream"
        try:
            return pipelined()
        finally:
            st.upload_mode = "bulk"

    def eager(run):
        def go():
            st.fused_motion = False
            try:
                return run()
            finally:
                st.fused_motion = True
        return go

    def sequential():
        got = {}
        t0 = time.perf_counter()
        for vd, arrays, _ in cli.load_videos(videos):
            name = os.path.basename(vd)
            got[name] = st.stitch_arrays(*arrays)
            mp4(name, got[name])
        torch.cuda.synchronize()
        return got, time.perf_counter() - t0

    def counted(run):
        torch.cuda.synchronize()
        corr_cuda.LAUNCHES.clear()
        fused_warp_cuda.LAUNCHES.clear()
        DECODED.clear()
        got = run()
        n = {"cost_volume_r5": corr_cuda.LAUNCHES[5],
             "cost_volume_r3": corr_cuda.LAUNCHES[3],
             "fused_warp": fused_warp_cuda.LAUNCHES["fused_warp"]}
        require(all(v > 0 for v in n.values()),
                f"K1 and K2 launched on the default path: {n}")
        return got, n, dict(DECODED)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    replays, replayed = st.graphs.replays, collections.Counter(
        st.graphs.replayed)
    (pipe, pipe_s), launches, decoded = counted(pipelined)
    peak = torch.cuda.max_memory_allocated()
    # the graphs' pools are reserved by the allocator; a replay allocates
    # nothing, so the reserved peak is the one that shows them
    peak_reserved = torch.cuda.max_memory_reserved()
    graphs = {"graphs": len(st.graphs), "captures": st.graphs.captures,
              "replays_per_video": (st.graphs.replays - replays) / CLI_VIDEOS,
              "replayed_launches_per_video": {
                  k: v / CLI_VIDEOS for k, v in
                  (st.graphs.replayed - replayed).items()}}
    require(graphs["replays_per_video"] > 0
            and graphs["replayed_launches_per_video"].get("cost_volume_r5"),
            f"the default path replayed K1 from graphs: {graphs}")
    torch.cuda.reset_peak_memory_stats()
    (pipe_e, pipe_e_s), launches_eager, _ = counted(eager(pipelined))
    peak_eager = torch.cuda.max_memory_allocated()
    peak_reserved_eager = torch.cuda.max_memory_reserved()
    require(launches_eager == launches,
            f"fused launches {launches} equal eager {launches_eager}")
    decoder = "native" if native.available() else "cv2"
    require(decoded == {decoder: 2 * CLI_VIDEOS},
            f"the pipelined run's view loads went through {decoder}: "
            f"{decoded}")
    out_frames = {n: mp4_frames(os.path.join(out, n + ".mp4"))
                  for n in loaded}
    require(all(n == CLI_FRAMES for n in out_frames.values()),
            f"mp4 frame counts {out_frames}")
    seq, seq_s = sequential()
    seq_e, seq_e_s = eager(sequential)()
    (strm, strm_s), launches_stream, _ = counted(streamed)
    walls = {"pipelined_s": [pipe_s], "pipelined_eager_s": [pipe_e_s],
             "sequential_s": [seq_s], "sequential_eager_s": [seq_e_s],
             "pipelined_stream_s": [strm_s]}
    for _ in range(CLI_ROUNDS - 1):
        walls["pipelined_s"].append(pipelined()[1])
        walls["pipelined_eager_s"].append(eager(pipelined)()[1])
        walls["sequential_s"].append(sequential()[1])
        walls["sequential_eager_s"].append(eager(sequential)()[1])
        walls["pipelined_stream_s"].append(streamed()[1])
    for name, r in pipe.items():
        for e, how in ((pipe_e[name], "pipelined"), (seq_e[name],
                                                     "sequential")):
            same = (r.frames.shape == e.frames.shape
                    and bool((r.frames == e.frames).all())
                    and mesh_gap(r, e) == 0.0)
            require(same, f"{name}: fused {how} frames and meshes equal "
                          "--eager_motion's")
        same = (r.frames.shape == seq[name].frames.shape
                and bool((r.frames == seq[name].frames).all()))
        require(same, f"{name}: pipelined frames equal stitch_arrays'")
        require(r.frame_format == "i420", f"{name}: yuv420 download")
        same = (r.frames.shape == strm[name].frames.shape
                and bool((r.frames == strm[name].frames).all())
                and mesh_gap(r, strm[name]) == 0.0)
        require(same, f"{name}: stream frames and meshes equal bulk's")

    f32 = init_stitcher(rng_seed=0, config=st.config,
                        compute_dtype=torch.float32, device=device)
    f32.stitch_arrays(*loaded["clip0"])           # warm-up
    gaps, f32_ms = {}, {}
    for name, arrays in loaded.items():
        r = f32.stitch_arrays(*arrays)
        gaps[name] = mesh_gap(seq[name], r)
        f32_ms[name] = r.ms
    require(max(gaps.values()) <= BF16_MESH_BOUND_PX,
            f"bf16 vs float32 smooth meshes {gaps} px > {BF16_MESH_BOUND_PX}")
    syncs = begin_waits(st, loaded["clip0"])
    require(one_wait(syncs), f"one wait in stitch_begin (the canvas fetch): "
                             f"{syncs}")
    st.upload_mode = "stream"
    try:
        syncs_stream = begin_waits(st, loaded["clip0"])
    finally:
        st.upload_mode = "bulk"
    require(one_wait(syncs_stream), f"one wait in a stream stitch_begin: "
                                    f"{syncs_stream}")
    frames = CLI_VIDEOS * CLI_FRAMES

    def up_spatial(results):
        keys = ("upload", "spatial", "temporal")
        return {n: {**{k: r.ms[k] for k in keys},
                    "sum": sum(r.ms[k] for k in keys)}
                for n, r in results.items()}
    return st, videos, {
        "phase": "cli", "videos": CLI_VIDEOS, "frames_per_video": CLI_FRAMES,
        "frame_hw": [360, 480], "flags": "defaults",
        "compute_dtype": str(st.spatial_net.feature_extractor_stage1
                             .compute_dtype),
        "upload": "i420", "download": st.config.download_format,
        "decoder": decoder, "view_loads": decoded,
        "load_s": load_s, "wall_s": walls, "fps_pipelined": [frames / w for w in
                                           walls["pipelined_s"]],
        "fps_pipelined_eager": [frames / w for w in
                                walls["pipelined_eager_s"]],
        "fps_sequential": [frames / w for w in walls["sequential_s"]],
        "fps_sequential_eager": [frames / w for w in
                                 walls["sequential_eager_s"]],
        "fps_pipelined_stream": [frames / w for w in
                                 walls["pipelined_stream_s"]],
        "stream_equals_bulk": True, "fused_equals_eager": True,
        "fused_motion_graphs": graphs, "launches_eager": launches_eager,
        "max_memory_allocated_bytes_eager": peak_eager,
        "max_memory_reserved_bytes": peak_reserved,
        "max_memory_reserved_bytes_eager": peak_reserved_eager,
        "phase_ms_eager": {n: r.ms for n, r in seq_e.items()},
        "ms_bulk": up_spatial(pipe), "ms_stream": up_spatial(strm),
        "launches_stream": launches_stream,
        "stitch_begin_syncs_stream": syncs_stream,
        "phase_ms_pipelined": {n: r.ms for n, r in pipe.items()},
        "encode_fps": {n: r.fps["encode"] for n, r in seq.items()},
        "phase_ms_bf16": {n: r.ms for n, r in seq.items()},
        "phase_ms_f32": f32_ms, "launches": launches,
        "max_memory_allocated_bytes": peak, "mp4_frames": out_frames,
        "bf16_vs_f32_mesh_px": gaps, "bf16_mesh_bound_px": BF16_MESH_BOUND_PX,
        "stitch_begin_syncs": syncs}


def phase_trace(st, videos, tmp):
    """One video through ``--trace_dir``: ``stitch_stream(...,
    trace_dir=...)`` as ``cmd_stitch`` calls it, in bulk (the motion's
    graphs replayed), in bulk with ``--eager_motion`` and in stream upload
    mode; then bulk and stream again with QUEUED_SLEEP_MS of
    ``torch.cuda._sleep`` enqueued on the card just before
    ``stitch_begin`` (inside the trace), the case of a card with work
    queued ahead, where copies on the copy stream can run beside
    it and copies on the compute stream cannot. Gate: each Chrome trace
    exists and names the cost_volume and fused_warp kernels. Reports, per
    run, the card's idle share of the traced window (1 - the union of
    kernel and copy intervals over the window), the 5 device operations
    that took the most time, the most launched device operations, the
    most frequent host-side ATen operations (count, inclusive ms), and
    the ms of host-to-device copy and how many of them overlap a kernel
    (:func:`h2d_overlap`)."""
    import torch

    from stabstitch2_tpu_torch import cli

    out = {"phase": "trace", "queued_sleep_ms": QUEUED_SLEEP_MS}
    begin = st.stitch_begin
    cycles = int(QUEUED_SLEEP_MS * 1e-3
                 * torch.cuda.get_device_properties(0).clock_rate * 1e3)

    def queued_begin(*arrays):
        torch.cuda._sleep(cycles)
        return begin(*arrays)

    for mode, queued, fused in (("bulk", False, True), ("bulk", False, False),
                                ("stream", False, True), ("bulk", True, True),
                                ("stream", True, True)):
        name = (mode + ("" if fused else "_eager")
                + ("_queued" if queued else ""))
        d = os.path.join(tmp, f"trace_{name}")
        st.upload_mode = mode
        st.fused_motion = fused
        if queued:
            st.stitch_begin = queued_begin
        try:
            done, _ = cli.stitch_stream(
                st, cli.load_videos(videos[:1]),
                cli.mp4_sink(os.path.join(tmp, "trace_out")), trace_dir=d)
        finally:
            st.upload_mode = "bulk"
            st.fused_motion = True
            if queued:
                del st.stitch_begin
        files = sorted(glob.glob(os.path.join(d, "*.json")))
        require(done == 1 and len(files) == 1, f"one trace file: {files}")
        stats, names = trace_stats(files[0])
        for k in ("cost_volume", "fused_warp"):
            require(any(k in n for n in names),
                    f"{name} trace names a {k} kernel")
        stats.update(h2d_overlap(files[0]))
        out.update(stats if name == "bulk" else {name: stats})
    return out


def h2d_overlap(path) -> dict:
    """Host-to-device copies in a Chrome trace: their ms, the ms of them
    during which a kernel ran (their intervals intersected with the union
    of the kernel intervals), and the streams they ran on."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    copies = [e for e in events if e.get("cat") == "gpu_memcpy"
              and "HtoD" in e["name"]]
    busy = []
    for e in sorted((e for e in events if e.get("cat") == "kernel"),
                    key=lambda e: e["ts"]):
        a, b = e["ts"], e["ts"] + e["dur"]
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    overlap = 0.0
    for c in copies:
        a, b = c["ts"], c["ts"] + c["dur"]
        overlap += sum(max(0.0, min(b, y) - max(a, x)) for x, y in busy)
    return {"h2d_copies": len(copies),
            "h2d_ms": sum(c["dur"] for c in copies) / 1e3,
            "h2d_overlapping_kernels_ms": overlap / 1e3,
            "h2d_streams": sorted({str(c.get("args", {}).get("stream"))
                                   for c in copies})}


def trace_stats(path):
    """A Chrome trace's window, the card's busy time and idle share in it
    (1 - the union of kernel and copy intervals over the window), the 5
    device operations that took the most time and the most launched, and
    the most frequent host-side ATen operations (count, inclusive ms);
    and the set of kernel names."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    dev = [e for e in events
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    names = {e["name"] for e in dev if e["cat"] == "kernel"}
    t0 = min(e["ts"] for e in events)
    t1 = max(e["ts"] + e["dur"] for e in events)
    busy, end = 0.0, t0
    for e in sorted(dev, key=lambda e: e["ts"]):
        a, b = max(e["ts"], end), e["ts"] + e["dur"]
        if b > a:
            busy += b - a
            end = b
    by_name, launches = collections.Counter(), collections.Counter()
    for e in dev:
        by_name[e["name"][:120]] += e["dur"]
        launches[e["name"][:120]] += 1
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    op_n, op_us = collections.Counter(), collections.Counter()
    for e in ops:
        op_n[e["name"]] += 1
        op_us[e["name"]] += e["dur"]
    window_ms = (t1 - t0) / 1e3
    return {"file_bytes": os.path.getsize(path),
            "window_ms": window_ms, "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / (t1 - t0),
            "kernels": len([e for e in dev if e["cat"] == "kernel"]),
            "copies": len([e for e in dev if e["cat"] != "kernel"]),
            "device_ms_by_category": {
                c: sum(e["dur"] for e in dev if e["cat"] == c) / 1e3
                for c in ("kernel", "gpu_memcpy", "gpu_memset")},
            "top5_device_ms": [[n, us / 1e3]
                               for n, us in by_name.most_common(5)],
            "top5_device_launches": launches.most_common(5),
            "cpu_ops": len(ops),
            "top8_cpu_ops_by_count": [[n, c, op_us[n] / 1e3]
                                      for n, c in op_n.most_common(8)]}, names


def stream(online, v1, v2):
    """Push a clip pair by pair: (per-push counts, emitted frames)."""
    counts, frames = [], []
    for a, b in zip(v1, v2):
        out = online.push(a, b)
        counts.append(len(out))
        frames += out
    return counts, frames


def yuv_of_bgr_on_canvas(st, v1, v2):
    """An i420 stream, and the conversion on the card of a bgr stream
    composited on the i420 stream's first canvas: (i420 frames, packed
    conversion, both streams' re-anchor pushes)."""
    import numpy as np
    import torch

    from stabstitch2_tpu_torch.data.video_io import pack_i420_host
    from stabstitch2_tpu_torch.ops.yuv import bgr_u8_to_yuv420
    from stabstitch2_tpu_torch.pipeline.online import OnlineStitcher

    oy = OnlineStitcher(st, emit_format="i420")
    yuv, first = [], None
    for a, b in zip(v1, v2):
        yuv += oy.push(a, b)
        if first is None and oy.canvas is not None:
            first = oy.canvas
    ob = OnlineStitcher(st)
    ob._set_canvas(first)
    _, bgr = stream(ob, v1, v2)
    conv = bgr_u8_to_yuv420(torch.from_numpy(np.stack(bgr)).to(st.device))
    want = pack_i420_host(*(p.cpu().numpy() for p in conv))
    return np.stack(yuv), want, (oy.reanchor_frames, ob.reanchor_frames)


def kernel_wrappers():
    """Per kernel: the module that defines its wrapper, the wrapper's name,
    the modules that bound the wrapper by name at import, its plain
    version, and the tolerance of the wrapper against the plain version
    as a function of the plain result's largest magnitude (that of the
    kernels phase: 0 for K2, K3 and K4, which round as their plain
    versions do)."""
    from stabstitch2_tpu_torch.models import spatial, temporal
    from stabstitch2_tpu_torch.ops import (corr_cuda, fused_warp_cuda,
                                           patch_gather_cuda, tps_coords_cuda)
    from stabstitch2_tpu_torch.pipeline import compositor

    return {
        "cost_volume": (corr_cuda, "cost_volume_cuda", (spatial, temporal),
                        corr_cuda.cost_volume_plain,
                        lambda amax: CV_ATOL + 1e-5 * amax),
        "fused_warp": (fused_warp_cuda, "fused_warp_planes", (),
                       fused_warp_cuda.fused_warp_planes_plain,
                       lambda amax: 0.0),
        "tps_coords": (tps_coords_cuda, "tps_coords", (),
                       tps_coords_cuda.tps_coords_plain, lambda amax: 0.0),
        "patch_gather": (patch_gather_cuda, "bilinear_sample_patch_u8_cuda",
                         (compositor,), patch_gather_cuda.patch_gather_plain,
                         lambda amax: 0.0),
    }


class PathInputs:
    """The inputs of a path's kernel calls, so that each kernel can be held
    against its plain version at the shapes that path gives it.

    Inside :meth:`recording` every kernel wrapper is replaced by one that
    keeps a copy (on the card) of the arguments of its latest call at each
    distinct signature (tensor shapes and dtypes and the other arguments,
    the spline's normalization span aside), for at most HELD_PER_KERNEL
    signatures, and then calls the wrapper. The latest, not the first: a
    stream's first temporal cost volume reads all-zero features. A call
    made while a CUDA graph is being captured (``utils/graphs.py``) is not
    kept: its arguments hold no values yet. A program's first call runs
    eagerly before its capture, so the path's inputs are kept all the
    same. :meth:`hold` runs each kept call through the
    wrapper and the plain version on the same card tensors; the launches
    it makes are taken off the wrapper's count again."""

    def __init__(self):
        self.calls = collections.defaultdict(dict)

    @staticmethod
    def _key(args, kwargs):
        import torch

        def k(x):
            return ((tuple(x.shape), str(x.dtype)) if torch.is_tensor(x)
                    else repr(x))

        return (tuple(k(x) for x in args)
                + tuple((n, k(v)) for n, v in sorted(kwargs.items())
                        if n != "grid_span"))

    @contextlib.contextmanager
    def recording(self):
        import torch

        def copy(x):    # the values only: a trainer's inputs carry a graph
            return x.detach().clone() if torch.is_tensor(x) else x

        saved = []
        for name, (mod, attr, users, _, _) in kernel_wrappers().items():
            def tapped(*args, _name=name, _wrapper=getattr(mod, attr),
                       **kwargs):
                seen = self.calls[_name]
                key = self._key(args, kwargs)
                if (torch.cuda.is_available()
                        and torch.cuda.is_current_stream_capturing()):
                    pass
                elif key in seen or len(seen) < HELD_PER_KERNEL:
                    seen[key] = ([copy(x) for x in args],
                                 {n: copy(v) for n, v in kwargs.items()})
                return _wrapper(*args, **kwargs)

            for m in (mod, *users):
                saved.append((m, attr, getattr(m, attr)))
                setattr(m, attr, tapped)
        try:
            yield self
        finally:
            for m, attr, f in reversed(saved):
                setattr(m, attr, f)

    def hold(self, names, path: str) -> dict:
        """Per kernel in ``names``: one row per kept call, its input shapes,
        max|wrapper - plain| and the tolerance; raises past it, or if the
        path made no call of the kernel."""
        import torch

        wrappers = kernel_wrappers()
        out = {}
        for name in names:
            mod, attr, _, plain, tol = wrappers[name]
            kept = self.calls.get(name)
            require(bool(kept), f"{path}: a call of {name} was recorded")
            launches = collections.Counter(mod.LAUNCHES)
            rows = []
            for args, kwargs in kept.values():
                got = getattr(mod, attr)(*args, **kwargs)
                ref = plain(*args, **kwargs)
                torch.cuda.synchronize()
                got = got if isinstance(got, tuple) else (got,)
                ref = ref if isinstance(ref, tuple) else (ref,)
                err, amax = 0.0, 0.0
                for g, r in zip(got, ref):
                    if g.dtype == torch.bool:
                        require(torch.equal(g, r), f"{path}: {name} flags")
                    elif g.numel():
                        err = max(err, float((g - r).abs().max()))
                        amax = max(amax, float(r.abs().max()))
                shapes = [list(x.shape) for x in args if torch.is_tensor(x)]
                rows.append({"shapes": shapes, "max_abs_err": err,
                             "atol": tol(amax)})
                require(err <= tol(amax),
                        f"{path}: {name} at {shapes}: max|d| {err} vs plain "
                        f"on the path's inputs (atol {tol(amax)})")
            mod.LAUNCHES.clear()
            mod.LAUNCHES.update(launches)
            out[name] = rows
        return out


def phase_online(device, tmp):
    """``OnlineStitcher.push`` over a 48-frame clip at 360x480, one pair at
    a time, at the defaults (bf16 trunks, route A, bgr), after a warm-up
    stream; the launch counts are set to 0 just before and read just
    after. Per push: host ms around ``push``, emitted frames, the
    stitcher's waits for the card (each on an event after page-locked
    copies) and the waits ``set_sync_debug_mode("warn")`` reports (a wait
    the design does not make). Gates: emissions [0]*6 + [7] + [1]*41; one
    wait per steady push and none reported by the debug mode; the i420
    emission equals the conversion on the card of the bgr emission on the
    same canvas (route B, which chains the conversion: exactly; route A,
    which converts the float fusion: within one level); a trace of
    TRACE_PUSHES steady pushes names K1 and K2 (the card's idle share of
    its window is reported); with float32
    trunks the last window's smooth meshes lie within ONLINE_MESH_ATOL_PX
    of ``stitch_arrays``' and route A's frames equal route B's. K1 and K2
    (the burst's and a steady push's shapes, from the warm-up) and K3 and
    K4 (route B's stream) are held against their plain versions on those
    inputs. The pushes replay the captured step (``fused_motion``, the
    default); the same clip through the uncaptured step
    (``fused_motion=False``) must give the same frames and window meshes
    bit for bit, and its push ms and trace are printed beside them."""
    import dataclasses
    import warnings

    import numpy as np
    import torch

    from stabstitch2_tpu_torch.config import StitchConfig
    from stabstitch2_tpu_torch.ops import (corr_cuda, fused_warp_cuda,
                                           patch_gather_cuda, tps_coords_cuda)
    from stabstitch2_tpu_torch.pipeline.online import OnlineStitcher
    from stabstitch2_tpu_torch.pipeline.stitcher import init_stitcher
    from stabstitch2_tpu_torch.utils.profiling import trace
    from synthetic import make_two_view_clip

    n = ONLINE_FRAMES
    v1, v2 = make_two_view_clip(num_frames=n, height=FRAME_HW[0],
                                width=FRAME_HW[1], overlap=0.5, shake_px=4.0,
                                seed=2)
    st = init_stitcher(rng_seed=0, device=device)      # bf16, route A
    held = PathInputs()
    with held.recording():      # the burst's and a steady push's inputs
        stream(OnlineStitcher(st), v1[:9], v2[:9])      # warm-up
    torch.cuda.synchronize()
    o = OnlineStitcher(st)
    corr_cuda.LAUNCHES.clear()
    fused_warp_cuda.LAUNCHES.clear()

    def counts():
        return np.array([corr_cuda.LAUNCHES[5], corr_cuda.LAUNCHES[3],
                         fused_warp_cuda.LAUNCHES["fused_warp"]])

    ms, emitted, waits, hidden, per_push = [], [], [], [], []
    torch.cuda.set_sync_debug_mode("warn")
    try:
        for a, b in zip(v1, v2):
            c0, w0 = counts(), o.waits
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                t0 = time.perf_counter()
                out = o.push(a, b)
                ms.append((time.perf_counter() - t0) * 1e3)
            hidden.append(sum("called a synchronizing" in str(w.message)
                              for w in caught))
            waits.append(o.waits - w0)
            emitted.append(len(out))
            per_push.append((counts() - c0).tolist())
    finally:
        torch.cuda.set_sync_debug_mode("default")
    total = counts()
    require(o.graphs.captures == 1 and o.graphs.replays == n - 1,
            f"one captured step, replayed by every later push: "
            f"{o.graphs.captures}, {o.graphs.replays}")
    # the uncaptured step on the same clip: the same bits
    oe = OnlineStitcher(dataclasses.replace(st, fused_motion=False))
    require(oe.graphs is None, "fused_motion=False steps eagerly")
    ms_eager, frames_f, frames_e = [], [], []
    for a, b in zip(v1, v2):
        t0 = time.perf_counter()
        frames_e += oe.push(a, b)
        ms_eager.append((time.perf_counter() - t0) * 1e3)
    o2 = OnlineStitcher(st)
    for a, b in zip(v1, v2):
        frames_f += o2.push(a, b)
    same = (len(frames_f) == len(frames_e) == n
            and all(np.array_equal(f, e) for f, e in zip(frames_f, frames_e))
            and all(torch.equal(f, e) for f, e in zip(o2.window_smooth,
                                                      oe.window_smooth)))
    require(same, "captured online step: frames and window meshes equal "
                  "the uncaptured step's")
    launches = {"cost_volume_r5": int(total[0]),
                "cost_volume_r3": int(total[1]),
                "fused_warp": int(total[2])}
    require(all(v > 0 for v in launches.values()),
            f"K1 and K2 launched on the online path: {launches}")
    want = [0] * 6 + [7] + [1] * (n - 7)
    require(emitted == want, f"emissions per push {emitted}")
    steady = range(7, n)
    require(all(waits[i] == 1 and hidden[i] == 0 for i in steady),
            f"one wait per steady push: waits {waits}, reported {hidden}")
    require(sum(hidden) == 0, f"waits the debug mode reports: {hidden}")
    # a Chrome trace of TRACE_PUSHES steady pushes of a fresh stream
    d = os.path.join(tmp, "online_trace")
    o_tr = OnlineStitcher(st)
    stream(o_tr, v1[:8], v2[:8])
    with trace(d):
        stream(o_tr, v1[8:8 + TRACE_PUSHES], v2[8:8 + TRACE_PUSHES])
    files = sorted(glob.glob(os.path.join(d, "*.json")))
    require(len(files) == 1, f"one online trace file: {files}")
    traced, names = trace_stats(files[0])
    for k in ("cost_volume", "fused_warp"):
        require(any(k in x for x in names), f"online trace names a {k} kernel")
    d = os.path.join(tmp, "online_trace_eager")
    o_tr = OnlineStitcher(dataclasses.replace(st, fused_motion=False))
    stream(o_tr, v1[:8], v2[:8])
    with trace(d):
        stream(o_tr, v1[8:8 + TRACE_PUSHES], v2[8:8 + TRACE_PUSHES])
    traced_eager, _ = trace_stats(glob.glob(os.path.join(d, "*.json"))[0])

    yuv_a, conv_a, re_a = yuv_of_bgr_on_canvas(st, v1, v2)
    st_b = dataclasses.replace(st, config=StitchConfig(fused_warp=False))
    yuv_b, conv_b, re_b = yuv_of_bgr_on_canvas(st_b, v1, v2)
    for re in (re_a, re_b):
        require(re[0] == re[1], f"i420 and bgr streams re-anchor alike: {re}")
    d_a, d_b = frame_diff(yuv_a, conv_a), frame_diff(yuv_b, conv_b)
    require(d_b["max"] == 0, f"route B i420 vs converted bgr: {d_b}")
    require(d_a["max"] <= 1, f"route A i420 vs converted bgr: {d_a}")

    st32 = init_stitcher(rng_seed=0, compute_dtype=torch.float32,
                         device=device)
    o32 = OnlineStitcher(st32)
    _, f_a = stream(o32, v1, v2)
    batch = st32.stitch_arrays(v1, None, v2, None)
    gap = max(float((o32.window_smooth[k][-1] - m[-1]).abs().max())
              for k, m in enumerate((batch.smooth_mesh1, batch.smooth_mesh2)))
    require(gap <= ONLINE_MESH_ATOL_PX,
            f"online vs batch float32 smooth meshes {gap} px")
    tps_coords_cuda.LAUNCHES.clear()
    patch_gather_cuda.LAUNCHES.clear()
    with held.recording():
        _, f_b = stream(OnlineStitcher(dataclasses.replace(
            st32, config=StitchConfig(fused_warp=False))), v1, v2)
    gather = {"tps_coords": tps_coords_cuda.LAUNCHES["tps_coords"],
              "patch_gather": patch_gather_cuda.LAUNCHES["patch_gather"]}
    require(all(v > 0 for v in gather.values()),
            f"route B launched K3 and K4: {gather}")
    ab = frame_diff(np.stack(f_a), np.stack(f_b))
    require(ab["max"] == 0, f"online route A vs route B float32: {ab}")
    plain = held.hold(("cost_volume", "fused_warp", "tps_coords",
                       "patch_gather"), "online")
    steady_ms = [ms[i] for i in steady]
    return {"phase": "online", "frames": n, "frame_hw": list(FRAME_HW),
            "compute_dtype": "bfloat16", "route": "A (K2)",
            "canvas_hw": [o.canvas.out_h, o.canvas.out_w],
            "reanchor_frames": o.reanchor_frames,
            "first_window_burst_ms": ms[6],
            "steady_push_ms_median": float(np.median(steady_ms)),
            "steady_push_ms_p90": float(np.percentile(steady_ms, 90)),
            "eager_steady_push_ms_median": float(np.median(
                [ms_eager[i] for i in steady])),
            "eager_steady_push_ms_p90": float(np.percentile(
                [ms_eager[i] for i in steady], 90)),
            "captured_equals_uncaptured": True,
            "graph_replays_per_push": o.graphs.replays / (n - 1),
            "graph_replayed_launches": dict(o.graphs.replayed),
            "first_pushes_ms": ms[:6], "push_ms": ms,
            "emitted_per_push": emitted, "waits_per_push": waits,
            "debug_mode_waits_per_push": hidden,
            "launches": launches,
            "launches_per_steady_push": {
                k: sorted({per_push[i][j] for i in steady})
                for j, k in enumerate(launches)},
            "launches_burst_push": per_push[6],
            "i420_vs_converted_bgr": {"route_a": d_a, "route_b": d_b},
            "f32_online_vs_batch_mesh_px": gap,
            "mesh_atol_px": ONLINE_MESH_ATOL_PX,
            "f32_route_a_vs_b": ab, "route_b_launches": gather,
            "trace_pushes": TRACE_PUSHES, "trace": traced,
            "trace_eager": traced_eager,
            "held_against_plain": plain}


def multi_views(T, seed=0):
    """Three views of T frames: crops of one texture panorama half a view
    apart, jittered per frame (tests/test_entry_and_multiview.py's
    three-view clip, at FRAME_HW)."""
    import numpy as np

    from synthetic import _texture

    h, w = FRAME_HW
    rng = np.random.default_rng(seed)
    pano = _texture(h + 16, w * 2 + 32, seed=9)
    views = []
    for k in range(3):
        x0 = k * (w // 2)
        frames = []
        for _ in range(T):
            j = rng.integers(0, 8, 2)
            frames.append(pano[j[0]:j[0] + h, x0 + j[1]:x0 + j[1] + w])
        views.append(np.stack(frames).astype(np.uint8))
    return views


def phase_multi(device, tmp):
    """The N-view chain: ``stitch_multi_begin``/``finish`` at the CLI's
    defaults (bf16, I420 uploads, yuv420 download, route A: one K2 launch
    for the 3 x chunk images of a chunk) on a 3-view clip of MULTI_FRAMES
    frames at 360x480, after a warm-up, counted; then ``cli stitch-multi``
    on a jpg copy. Gates: T frames, a panorama at least one view wide,
    the mp4 holds T frames; with float32 trunks route A's frames equal
    route B's, and the chained meshes equal the chain run on the CPU on
    the same pair meshes within CHAIN_ATOL_PX, while the chain run on pair
    meshes rounded through bfloat16 (a planted fault) lies outside it. K1 and K2
    (the warm-up's V x chunk images per launch) and K3 and K4 (route B)
    are held against their plain versions on the path's inputs."""
    import dataclasses

    import cv2
    import numpy as np
    import torch

    from stabstitch2_tpu_torch import cli
    from stabstitch2_tpu_torch.config import StitchConfig
    from stabstitch2_tpu_torch.data.video_io import bgr_to_i420
    from stabstitch2_tpu_torch.ops import (corr_cuda, fused_warp_cuda,
                                           patch_gather_cuda, tps_coords_cuda)
    from stabstitch2_tpu_torch.pipeline import threeview as tv
    from stabstitch2_tpu_torch.pipeline.stitcher import (init_stitcher,
                                                         model_input)

    T = MULTI_FRAMES
    views = multi_views(T)
    clip, out = os.path.join(tmp, "multi"), os.path.join(tmp, "multi.mp4")
    for k, v in enumerate(views):
        d = os.path.join(clip, f"video{k + 1}")
        os.makedirs(d)
        for t, f in enumerate(v):
            cv2.imwrite(os.path.join(d, f"{t:04d}.jpg"), f)
    args = cli.make_parser().parse_args(["stitch-multi", "--video_dir", clip,
                                         "--output", out])
    st = cli.build_stitcher(args)
    packed = [bgr_to_i420(v) for v in views]
    held = PathInputs()
    with held.recording():      # a chunk's V x chunk images in one K2 call
        tv.stitch_multi_finish(tv.stitch_multi_begin(st, packed))  # warm-up
    torch.cuda.synchronize()
    corr_cuda.LAUNCHES.clear()
    fused_warp_cuda.LAUNCHES.clear()
    replays = st.graphs.replays
    t0 = time.perf_counter()
    pending = tv.stitch_multi_begin(st, packed)
    frames, fmt = tv.stitch_multi_finish(pending)
    wall = time.perf_counter() - t0
    replays = st.graphs.replays - replays
    require(st.fused_motion and replays > 0,
            f"the chain's motion replayed from graphs: {replays}")
    launches = {"cost_volume_r5": corr_cuda.LAUNCHES[5],
                "cost_volume_r3": corr_cuda.LAUNCHES[3],
                "fused_warp": fused_warp_cuda.LAUNCHES["fused_warp"]}
    require(all(v > 0 for v in launches.values()),
            f"K1 and K2 launched on the chain: {launches}")
    c = pending.composite.canvas
    require(fmt == "i420" and frames.shape == (T, c.out_h * 3 // 2, c.out_w),
            f"chain frames {frames.shape} {fmt}")
    require(c.out_w >= FRAME_HW[1], f"panorama {c.out_w} px wide")
    require(frames.max() > 0, "chain frames not all 0")
    t1 = time.perf_counter()
    rc = cli.main(["stitch-multi", "--video_dir", clip, "--output", out])
    cli_s = time.perf_counter() - t1
    n_mp4 = mp4_frames(out) if os.path.exists(out) else 0
    require(rc == 0 and n_mp4 == T, f"cli stitch-multi rc {rc}, {n_mp4} "
                                    f"frames in the mp4")

    st32 = init_stitcher(rng_seed=0, compute_dtype=torch.float32,
                         device=device)
    f_a = tv.stitch_multi_finish(tv.stitch_multi_begin(st32, views))[0]
    tps_coords_cuda.LAUNCHES.clear()
    patch_gather_cuda.LAUNCHES.clear()
    with held.recording():
        f_b = tv.stitch_multi_finish(tv.stitch_multi_begin(
            dataclasses.replace(st32, config=StitchConfig(fused_warp=False)),
            views))[0]
    gather = {"tps_coords": tps_coords_cuda.LAUNCHES["tps_coords"],
              "patch_gather": patch_gather_cuda.LAUNCHES["patch_gather"]}
    require(all(v > 0 for v in gather.values()),
            f"route B launched K3 and K4: {gather}")
    ab = frame_diff(f_a, f_b)
    require(ab["max"] == 0, f"chain route A vs route B float32: {ab}")
    plain = held.hold(("cost_volume", "fused_warp", "tps_coords",
                       "patch_gather"), "multi")
    los = [model_input(st32.upload_frames(v, []), st32.model_h, st32.model_w)
           for v in views]
    pairs = [tv.pair_smooth_meshes(st32, los[j], los[j + 1])
             for j in range(len(views) - 1)]
    H, W = FRAME_HW
    card = tv.chain_meshes(pairs, H, W, st32.model_h, st32.model_w)
    cpu = tv.chain_meshes([(a.cpu(), b.cpu()) for a, b in pairs], H, W,
                          st32.model_h, st32.model_w)
    chain_gap = max(float((a.cpu() - b).abs().max())
                    for a, b in zip(card, cpu))
    require(chain_gap <= CHAIN_ATOL_PX,
            f"chained meshes, card vs CPU on the same pair meshes: "
            f"{chain_gap} px")
    # a planted fault the gate must see: the pair meshes rounded through
    # bfloat16 (the precision SmoothNet is kept out of) before the chain
    planted = tv.chain_meshes(
        [(a.to(torch.bfloat16).float(), b.to(torch.bfloat16).float())
         for a, b in pairs], H, W, st32.model_h, st32.model_w)
    planted_gap = max(float((a.cpu() - b).abs().max())
                      for a, b in zip(planted, cpu))
    require(planted_gap > CHAIN_ATOL_PX,
            f"the chain gate sees bf16 pair meshes: {planted_gap} px")
    return {"phase": "multi", "views": len(views), "frames": T,
            "frame_hw": list(FRAME_HW), "compute_dtype": "bfloat16",
            "upload": "i420", "download": fmt,
            "canvas_hw": [c.out_h, c.out_w],
            "padded_canvas_hw": [c.pad_h, c.pad_w], "wall_s": wall,
            "fps": T / wall, "launches": launches, "cli_s": cli_s,
            "graph_replays": replays,
            "mp4_frames": n_mp4, "f32_route_a_vs_b": ab,
            "route_b_launches": gather, "chain_card_vs_cpu_px": chain_gap,
            "chain_atol_px": CHAIN_ATOL_PX,
            "chain_bf16_fault_vs_cpu_px": planted_gap,
            "held_against_plain": plain}


def phase_metric(device, tmp):
    """The metric harness with the ``metric`` command's stitcher (bf16,
    bgr upload, chunk 8) at 360x480: its one captured program per
    16-frame bucket (``metrics/harness.py:_fused_eval``) against
    ``--eager_motion``'s eager path.

    A warm-up of each (the program's first call runs eagerly, then is
    captured; K1 and K3 recorded there), then METRIC_ROUNDS videos of
    METRIC_FRAMES frames each way in turns: ms per video (host clock to
    the fetched scores), graph replays, K1 r=5 / r=3 and K3 launches, peak
    memory allocated and reserved (after ``empty_cache``, so the reserved
    bytes at the start are the graphs' pools and live tensors), and the
    reserved bytes each bucket's capture adds. Gates: one replay per captured video,
    the launches equal the eager path's, the scores within METRIC_RTOL of
    the eager path's and finite. Then the bucket: a replay at
    METRIC_FRAMES and at METRIC_SHORT frames (same bucket) adds no capture
    and equals the program called uncaptured on the same inputs bit for
    bit; a METRIC_NEXT-frame video adds exactly one capture (bucket 32),
    whose seconds are printed. A planted fault, a program that bakes the
    frame count in at capture (captured at METRIC_FRAMES, replayed on the
    METRIC_SHORT-frame video), must fail that bit-for-bit gate. A trace of
    one video each way gives the card's idle share. K1 and K3 are held
    against their plain versions on the warm-up's inputs. With float32
    trunks the program at METRIC_SHORT frames lies within METRIC_RTOL of
    ``--eager_motion`` (whose tail chunk runs at its true batch; the
    largest gap per score is printed), and the card's metrics within
    METRIC_RTOL of the port's on the CPU over CPU_FRAMES frames; ``cli
    metric --out_json`` writes its report."""
    import dataclasses

    import numpy as np
    import torch

    from stabstitch2_tpu_torch import cli
    from stabstitch2_tpu_torch.metrics import harness
    from stabstitch2_tpu_torch.metrics.harness import evaluate_video
    from stabstitch2_tpu_torch.ops import corr_cuda, tps_coords_cuda
    from stabstitch2_tpu_torch.pipeline.stitcher import init_stitcher
    from stabstitch2_tpu_torch.utils.graphs import GraphCache
    from stabstitch2_tpu_torch.utils.profiling import trace
    from synthetic import make_two_view_clip, write_clip_dirs

    def clip(T, seed):
        return make_two_view_clip(num_frames=T, height=FRAME_HW[0],
                                  width=FRAME_HW[1], overlap=0.5,
                                  shake_px=4.0, seed=seed)

    def rel_gaps(got, ref):
        return {k: abs(got[k] - ref[k]) / max(abs(ref[k]), 1e-12)
                for k in ref}

    v1, v2 = clip(METRIC_FRAMES, 3)
    data, out = os.path.join(tmp, "metric"), os.path.join(tmp, "metric.json")
    args = cli.make_parser().parse_args(["metric", "--test_path", data,
                                         "--out_json", out])
    st = cli.build_stitcher(args)
    up = args.upload_format
    eager = dataclasses.replace(st, fused_motion=False)
    require(st.fused_motion and not eager.fused_motion and st.chunk == 8,
            "the metric command's stitcher: fused, chunk 8")
    held = PathInputs()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = {"before": torch.cuda.memory_reserved()}
    with held.recording():      # the motion's K1 and the float warp's K3
        evaluate_video(st, v1, v2, upload=up)   # eager, then captured
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved[f"bucket {METRIC_FRAMES} captured"] = torch.cuda.memory_reserved()
    evaluate_video(eager, v1, v2, upload=up)
    torch.cuda.synchronize()
    require(st.graphs.captures == 1 and len(st.graphs) == 1,
            f"one capture after the warm-up: {st.graphs.captures}")
    capture_s = {METRIC_FRAMES: st.graphs.capture_seconds}

    def counted(s, a, b):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()    # reserved: the graphs' pools and live
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        start_reserved = torch.cuda.memory_reserved()
        corr_cuda.LAUNCHES.clear()
        tps_coords_cuda.LAUNCHES.clear()
        replays = s.graphs.replays
        t0 = time.perf_counter()
        got = evaluate_video(s, a, b, upload=up)
        return got, {
            "ms": (time.perf_counter() - t0) * 1e3,
            "replays": s.graphs.replays - replays,
            "launches": {"cost_volume_r5": corr_cuda.LAUNCHES[5],
                         "cost_volume_r3": corr_cuda.LAUNCHES[3],
                         "tps_coords": tps_coords_cuda.LAUNCHES[
                             "tps_coords"]},
            "allocated_at_start_bytes": start,
            "reserved_at_start_bytes": start_reserved,
            "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
            "peak_reserved_bytes": torch.cuda.max_memory_reserved()}

    runs = {"captured": [], "eager": []}
    got = {}
    for r in range(METRIC_ROUNDS):
        turns = (("captured", st), ("eager", eager))
        for name, s in (turns if r % 2 == 0 else turns[::-1]):
            got[name], row = counted(s, v1, v2)
            runs[name].append(row)
    launches = runs["eager"][0]["launches"]
    require(all(row["replays"] == 1 for row in runs["captured"]),
            f"one replay per captured video: {runs['captured']}")
    require(all(row["launches"] == launches and v > 0
                for row in runs["captured"] + runs["eager"]
                for v in row["launches"].values()),
            f"K1 and K3 launched, captured as eager: {runs}")
    require(all(np.isfinite(v) for v in got["captured"].values()),
            f"metrics {got['captured']}")
    rel_eager = rel_gaps(got["captured"], got["eager"])
    require(max(rel_eager.values()) <= METRIC_RTOL,
            f"captured vs --eager_motion: relative gaps {rel_eager}")

    # the bucket: replays against the program called uncaptured
    def uncaptured(a, b):
        with torch.no_grad():
            x1, x2, n, _ = harness.metric_inputs(st, a, b, up, [])
            ps, ss, *scores = harness._fused_eval(st)(x1, x2, n)
        return ps, ss, torch.stack(scores)

    def bit_equal(xs, ys):
        return all(torch.equal(x, y) for x, y in zip(xs, ys))

    bucket, want = {}, {}
    for T in (METRIC_FRAMES, METRIC_SHORT):
        captures, replays = st.graphs.captures, st.graphs.replays
        h = harness._submit_video(st, v1[:T], v2[:T], up)
        want[T] = uncaptured(v1[:T], v2[:T])
        same = bit_equal((h.psnr, h.ssim, h.scores), want[T])
        bucket[T] = {"new_captures": st.graphs.captures - captures,
                     "replays": st.graphs.replays - replays,
                     "equal_to_uncaptured": same}
        require(bucket[T] == {"new_captures": 0, "replays": 1,
                              "equal_to_uncaptured": True},
                f"{T} frames in the 16-frame bucket: {bucket[T]}")
    short_vs_eager = rel_gaps(
        evaluate_video(st, v1[:METRIC_SHORT], v2[:METRIC_SHORT], up),
        evaluate_video(eager, v1[:METRIC_SHORT], v2[:METRIC_SHORT], up))
    w1, w2 = clip(METRIC_NEXT, 4)
    captures, seconds = st.graphs.captures, st.graphs.capture_seconds
    harness._submit_video(st, w1, w2, up)
    torch.cuda.synchronize()
    next_bucket = harness.metric_bucket(METRIC_NEXT, st.chunk)
    capture_s[next_bucket] = st.graphs.capture_seconds - seconds
    torch.cuda.empty_cache()
    reserved[f"bucket {next_bucket} captured"] = torch.cuda.memory_reserved()
    h = harness._submit_video(st, w1, w2, up)
    bucket[METRIC_NEXT] = {
        "new_captures": st.graphs.captures - captures,
        "equal_to_uncaptured": bit_equal((h.psnr, h.ssim, h.scores),
                                         uncaptured(w1, w2))}
    require(bucket[METRIC_NEXT] == {"new_captures": 1,
                                    "equal_to_uncaptured": True},
            f"{METRIC_NEXT} frames: the next bucket {bucket[METRIC_NEXT]}")

    # planted fault: the frame count baked in at capture
    program, baked = harness._fused_eval(st), {}

    def baked_count(a, b, n):
        if "n" not in baked:     # read by the eager first call only
            baked["n"] = int(n)
        return program(a, b, baked["n"])

    cache = GraphCache()
    with torch.no_grad():
        for T in (METRIC_FRAMES, METRIC_SHORT):
            x1, x2, n, _ = harness.metric_inputs(st, v1[:T], v2[:T], up, [])
            ps, ss, *scores = cache.run("metric", baked_count, x1, x2, n,
                                        modules=(st.spatial_net,
                                                 st.temporal_net,
                                                 st.smooth_net))
    require(cache.replays == 1, f"the fault replayed: {cache.replays}")
    fault_caught = not bit_equal((ps, ss, torch.stack(scores)),
                                 want[METRIC_SHORT])
    fault_gap = (torch.stack(scores) - want[METRIC_SHORT][2]).abs() / \
        want[METRIC_SHORT][2].abs()
    require(fault_caught, "the baked-count fault fails the bit-for-bit gate")
    del cache

    traces = {}
    for name, s in (("captured", st), ("eager", eager)):
        d = os.path.join(tmp, f"trace_metric_{name}")
        with trace(d):
            evaluate_video(s, v1, v2, upload=up)
        files = sorted(glob.glob(os.path.join(d, "*.json")))
        require(len(files) == 1, f"one metric trace: {files}")
        stats, names = trace_stats(files[0])
        for k in ("cost_volume", "tps_coords"):
            require(any(k in n for n in names),
                    f"the {name} metric trace names a {k} kernel")
        traces[name] = {k: stats[k] for k in (
            "window_ms", "device_busy_ms", "device_idle_share", "kernels",
            "cpu_ops", "top5_device_ms")}
    plain = held.hold(("cost_volume", "tps_coords"), "metric")

    # float32 trunks: the program at METRIC_SHORT frames (padded to the
    # bucket) against --eager_motion (the tail chunk at its true batch)
    f32 = init_stitcher(rng_seed=0, compute_dtype=torch.float32,
                        chunk=st.chunk, device=device)
    f32_eager = dataclasses.replace(f32, fused_motion=False)
    short = (v1[:METRIC_SHORT], v2[:METRIC_SHORT])
    evaluate_video(f32, *short, upload=up)     # eager first call, capture
    f32_short = {"program": evaluate_video(f32, *short, upload=up),
                 "eager": evaluate_video(f32_eager, *short, upload=up)}
    f32_short["rel_gap"] = rel_gaps(f32_short["program"], f32_short["eager"])
    f32_short["abs_gap"] = {k: abs(f32_short["program"][k]
                                   - f32_short["eager"][k])
                            for k in f32_short["eager"]}
    require(max(f32_short["rel_gap"].values()) <= METRIC_RTOL,
            f"float32, {METRIC_SHORT} frames, program vs --eager_motion: "
            f"relative gaps {f32_short['rel_gap']}")

    n = CPU_FRAMES
    card = evaluate_video(f32, v1[:n], v2[:n])
    cpu = evaluate_video(init_stitcher(rng_seed=0,
                                       compute_dtype=torch.float32,
                                       device="cpu"), v1[:n], v2[:n])
    rel = rel_gaps(card, cpu)
    require(max(rel.values()) <= METRIC_RTOL,
            f"float32 metrics, card vs CPU: relative gaps {rel}")
    write_clip_dirs(data, num_frames=METRIC_FRAMES, height=FRAME_HW[0],
                    width=FRAME_HW[1], seed=3)
    rc = cli.main(["metric", "--test_path", data, "--out_json", out])
    report = {}
    if os.path.exists(out):
        with open(out) as f:
            report = json.load(f)
    require(rc == 0 and set(report.get("average") or {}) == set(got["eager"]),
            f"cli metric rc {rc}, report {report}")
    return {"phase": "metric", "frames": METRIC_FRAMES,
            "frame_hw": list(FRAME_HW), "compute_dtype": "bfloat16",
            "upload": up, "chunk": st.chunk, "metrics": got["captured"],
            "ms_per_video": {k: [r["ms"] for r in v] for k, v in runs.items()},
            "launches": launches, "runs": runs,
            "captured_vs_eager_rel_gap": rel_eager,
            "short_vs_eager_rel_gap": short_vs_eager,
            "f32_short_vs_eager": f32_short,
            "short_frames": METRIC_SHORT, "bucket": bucket,
            "capture_seconds_by_bucket": capture_s,
            "reserved_bytes_after_empty_cache": reserved,
            "graph_captures": st.graphs.captures,
            "graph_replayed_launches": dict(st.graphs.replayed),
            "baked_count_fault": {"caught": fault_caught,
                                  "scores_rel_gap": fault_gap.tolist()},
            "traced": traces,
            "f32_card": card, "f32_cpu": cpu, "f32_rel_gap": rel,
            "rtol": METRIC_RTOL, "cpu_frames": n,
            "cli_report_average": report["average"],
            "held_against_plain": plain}


def grad_gate_step(net, device, pair, factors):
    """One spatial loss and backward of ``net`` (train mode) on ``device``:
    (loss, {name: grad}, the TPS photometric term's gradient on the last
    layer of the ref mesh head)."""
    import torch

    from stabstitch2_tpu_torch.config import SpatialTrainConfig
    from stabstitch2_tpu_torch.train import losses
    from stabstitch2_tpu_torch.train.spatial import (spatial_loss_fn,
                                                     spatial_train_outputs)

    a, b = (torch.from_numpy(x).to(device) for x in pair)
    net.to(device).train()
    net.zero_grad(set_to_none=True)
    total, _ = spatial_loss_fn(net, a, b, factors,
                               SpatialTrainConfig(batch_size=2))
    total.backward()
    grads = {k: p.grad.detach().double().cpu()
             for k, p in net.named_parameters()}
    out = spatial_train_outputs(net, a, b, factors)
    term = losses.tps_photometric_loss(out["output_tps_ref"],
                                       out["output_tps_tgt"])
    w = net.regressNet2_part2_ref[4].weight
    g = (torch.autograd.grad(term, [w], allow_unused=True)[0]
         if term.requires_grad else None)
    tps_grad = 0.0 if g is None else float(g.abs().sum())
    return float(total.detach()), grads, tps_grad


def grad_gap(grads, ref):
    """Per parameter, |g - ref| / |ref| in L2."""
    return {k: float((grads[k] - ref[k]).norm() / ref[k].norm())
            for k in ref}


def train_grad_gate(device) -> dict:
    """One spatial step at B=2, GATE_HW, from the same weights and
    augmentation factors on the card and on the CPU. Gates: the loss
    within GATE_LOSS_RTOL, every gradient within GATE_GRAD_RTOL_L2, the
    TPS photometric term alone reaching the ref mesh head's last layer;
    and the planted fault, K3's coordinates detached (a coordinate kernel
    without a backward), must break the bound."""
    import copy

    import numpy as np
    import torch

    from stabstitch2_tpu_torch.models import SpatialNet
    from stabstitch2_tpu_torch.models.backbone import init_weights
    from stabstitch2_tpu_torch.ops import tps_coords_cuda
    from stabstitch2_tpu_torch.train.common import draw_aug
    from synthetic import make_two_view_clip

    h, w = GATE_HW
    v1, v2 = make_two_view_clip(num_frames=2, height=h, width=w, overlap=0.6,
                                shake_px=2.0, seed=0)
    pair = (v1.astype(np.float32) / 127.5 - 1.0,
            v2.astype(np.float32) / 127.5 - 1.0)
    net = SpatialNet(h, w)
    init_weights(net, torch.Generator().manual_seed(0))
    factors = draw_aug(torch.Generator().manual_seed(0))
    # the CPU reference on one thread: with two, a CPU-only PyTorch build
    # read the trunk's backward ~1e-3 off its one- and four-thread result
    # (tests/test_torch_train_steps.py)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        loss_cpu, g_cpu, tps_cpu = grad_gate_step(copy.deepcopy(net), "cpu",
                                                  pair, factors)
    finally:
        torch.set_num_threads(threads)
    loss_card, g_card, tps_card = grad_gate_step(copy.deepcopy(net), device,
                                                 pair, factors)
    real = tps_coords_cuda.tps_coords
    tps_coords_cuda.tps_coords = (
        lambda T, s, size, grid_span=None: real(T.detach(), s.detach(),
                                                size, grid_span))
    try:
        loss_f, g_fault, tps_fault = grad_gate_step(copy.deepcopy(net),
                                                    device, pair, factors)
    finally:
        tps_coords_cuda.tps_coords = real
    gap, gap_f = grad_gap(g_card, g_cpu), grad_gap(g_fault, g_cpu)
    loss_rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
    worst = max(gap, key=gap.get)
    worst_f = max(gap_f, key=gap_f.get)
    require(loss_rel <= GATE_LOSS_RTOL,
            f"train gate: loss card {loss_card} vs CPU {loss_cpu}")
    require(gap[worst] <= GATE_GRAD_RTOL_L2,
            f"train gate: gradient of {worst} {gap[worst]} off the CPU's")
    require(tps_card > 0 and tps_cpu > 0,
            f"train gate: the TPS term reaches the mesh head (card "
            f"{tps_card}, CPU {tps_cpu})")
    require(gap_f[worst_f] > GATE_GRAD_RTOL_L2 and tps_fault == 0.0,
            f"train gate: the planted fault (K3 detached) passes: "
            f"{worst_f} {gap_f[worst_f]}, TPS-term grad {tps_fault}")
    return {"shape": [2, h, w], "loss_card": loss_card, "loss_cpu": loss_cpu,
            "loss_rel_gap": loss_rel, "loss_rtol": GATE_LOSS_RTOL,
            "grad_worst": [worst, gap[worst]],
            "grad_rtol_l2": GATE_GRAD_RTOL_L2,
            "grad_median": float(np.median(list(gap.values()))),
            "tps_term_head_grad_card": tps_card,
            "tps_term_head_grad_cpu": tps_cpu,
            "fault_k3_detached": {"grad_worst": [worst_f, gap_f[worst_f]],
                                  "tps_term_head_grad": tps_fault,
                                  "loss": loss_f}}


def graphed_ms(fn, iters: int = 5) -> list:
    """Device ms of ``fn`` captured as one CUDA graph, per replay (CUDA
    events around each): what its kernels cost the card without the
    host's dispatch."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    out = []
    for _ in range(iters):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return out


def tps_grads_held(held) -> list:
    """K3's ``TpsCoords`` gradients against autograd through
    ``tps_coords_plain`` on the recorded train inputs, with seeded
    cotangents: equal, since the backward is that autograd. Also the
    host-clock ms of that backward (3 runs, each between two waits) and
    its device ms, the same autograd captured as one graph
    (:func:`graphed_ms`). Its own launches are taken off the count
    again."""
    import torch

    from stabstitch2_tpu_torch.ops import tps_coords_cuda

    launches = collections.Counter(tps_coords_cuda.LAUNCHES)
    rows = []
    for args, kwargs in held.calls["tps_coords"].values():
        B, n = args[0].shape[0], args[2][0] * args[2][1]
        gen = torch.Generator(device=args[0].device).manual_seed(0)
        cot = [torch.randn(B, n, generator=gen, device=args[0].device)
               for _ in range(2)]
        grads, fns = [], []
        for fn in (tps_coords_cuda.tps_coords,
                   tps_coords_cuda.tps_coords_plain):
            T, src = (a.clone().requires_grad_(True) for a in args[:2])
            xs, ys = fn(T, src, *args[2:], **kwargs)
            fns.append(type(xs.grad_fn).__name__)
            torch.autograd.backward((xs, ys), cot)
            grads.append((T.grad, src.grad))
        require(fns[0].startswith("TpsCoords"),
                f"K3 with grad goes through TpsCoords, not {fns[0]}")
        backward_ms = []        # K3's plain backward, host clock
        for _ in range(3):
            T, src = (a.clone().requires_grad_(True) for a in args[:2])
            xs, ys = tps_coords_cuda.tps_coords(T, src, *args[2:], **kwargs)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            torch.autograd.backward((xs, ys), cot)
            torch.cuda.synchronize()
            backward_ms.append(1e3 * (time.perf_counter() - t0))
        T, src = (a.clone().requires_grad_(True) for a in args[:2])

        def plain_backward():
            xs, ys = tps_coords_cuda.tps_coords_plain(T, src, *args[2:],
                                                      **kwargs)
            return torch.autograd.grad((xs, ys), (T, src), cot)

        equal = all(torch.equal(a, b) for a, b in zip(*grads))
        err = max(float((a - b).abs().max()) for a, b in zip(*grads))
        rows.append({"shapes": [list(args[0].shape), list(args[1].shape)],
                     "out_size": list(args[2]), "grad_fn": fns[0],
                     "grads_equal": equal, "max_abs_err": err,
                     "backward_ms": backward_ms,
                     "plain_forward_and_backward_device_ms":
                         graphed_ms(plain_backward)})
        require(equal, f"TpsCoords gradients vs plain autograd: {err}")
    tps_coords_cuda.LAUNCHES.clear()
    tps_coords_cuda.LAUNCHES.update(launches)
    return rows


def stage_recorder(net_steps: dict):
    """An ``on_step`` hook that waits for the card after each step and
    records the host time, the loss terms and the kernels' counts."""
    import torch

    from stabstitch2_tpu_torch.ops import corr_cuda, tps_coords_cuda

    def on_step(step, metrics):
        torch.cuda.synchronize()
        net_steps.setdefault("t", []).append(time.perf_counter())
        terms = {k: float(v) for k, v in metrics.items()}
        net_steps.setdefault("terms", []).append(terms)
        net_steps.setdefault("loss", []).append(terms["total"])
        net_steps.setdefault("k1_r5", []).append(corr_cuda.LAUNCHES[5])
        net_steps.setdefault("k1_r3", []).append(corr_cuda.LAUNCHES[3])
        net_steps.setdefault("k3", []).append(
            tps_coords_cuda.LAUNCHES["tps_coords"])

    return on_step


def traced_step(fn, trace_dir: str, which: int):
    """``fn`` with its ``which``-th call (from 1) traced into
    ``trace_dir`` (``utils/profiling.py:trace``)."""
    from stabstitch2_tpu_torch.utils.profiling import trace

    calls = [0]

    def step(*args, **kwargs):
        calls[0] += 1
        if calls[0] != which:
            return fn(*args, **kwargs)
        with trace(trace_dir):
            return fn(*args, **kwargs)

    return step


def stage_report(rec: dict, t0: float, start_launches,
                 steps_per_epoch: int, traced: bool) -> dict:
    """Step ms, the steady ones (neither an epoch's first step, which
    waits for the loader's first batch and, in the run's first epoch,
    the capture, nor a traced step), launches per step, the losses and
    the peak memory allocated and reserved."""
    import torch

    times = [t0] + rec["t"]
    ms = [1e3 * (b - a) for a, b in zip(times, times[1:])]
    per_step = {}
    for k in ("k1_r5", "k1_r3", "k3"):
        counts = [start_launches[k]] + rec[k]
        per_step[k] = [b - a for a, b in zip(counts, counts[1:])]
    steady = [m for i, m in enumerate(ms) if i % steps_per_epoch
              and not (traced and i == len(ms) - 1)]
    return {"steps": len(ms), "step_ms": ms, "steady_step_ms": steady,
            "launches_per_step": per_step, "loss": rec["loss"],
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "peak_reserved_bytes": torch.cuda.max_memory_reserved()}


def moved(net_cls, seed, sd) -> dict:
    """Whether the trained state_dict ``sd`` left the initial weights of
    ``seed`` (parameters) and the identity BatchNorm statistics."""
    import torch

    from stabstitch2_tpu_torch.models.backbone import init_weights

    init = net_cls()
    init_weights(init, torch.Generator().manual_seed(seed))
    ref = init.state_dict()
    params = dict(init.named_parameters())
    changed = {k for k, v in sd.items()
               if v.dtype.is_floating_point and not torch.equal(v.cpu(),
                                                                ref[k])}
    stats = [k for k in ref if k.endswith(("running_mean", "running_var"))]
    return {"params_moved": sum(k in changed for k in params),
            "params": len(params),
            "bn_stats_moved": sum(k in changed for k in stats),
            "bn_stats": len(stats)}


STATS = ("running_mean", "running_var")


@contextlib.contextmanager
def deterministic_algorithms(on: bool):
    """PyTorch's and cuDNN's deterministic algorithms inside, where ``on``
    (an op without one warns once and runs as it is)."""
    import warnings

    import torch

    if not on:
        yield
        return
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", ".*deterministic implementation")
            yield
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False


GAPS = ("loss", "param", "bn_stats", "rate")


def run_gaps(a: dict, b: dict) -> dict:
    """Between two runs of a stage (each ``{"terms": [per-step loss
    terms], "state": state_dict, "rate": the last update's rate as Adam
    read it}``): the largest relative gap of a step's loss term, the
    largest |d| of a parameter and of a BatchNorm statistic after the
    run, and |d| of the last rate."""
    loss = max(abs(x[k] - y[k]) / max(abs(y[k]), 1e-30)
               for x, y in zip(a["terms"], b["terms"]) for k in y)
    sa, sb = a["state"], b["state"]

    def largest(keys):
        return max((float((sa[k].double() - sb[k].double()).abs().max())
                    for k in keys), default=0.0)

    floats = [k for k in sb if sb[k].dtype.is_floating_point]
    return {"loss": loss,
            "param": largest([k for k in floats if not k.endswith(STATS)]),
            "bn_stats": largest([k for k in floats if k.endswith(STATS)]),
            "rate": abs(a["rate"] - b["rate"])}


def captured_gate(captured: list, eager: list, faults: dict) -> dict:
    """The captured step against the eager one, per gap of
    :func:`run_gaps`: the eager spread is the largest gap between two
    eager runs; a captured run's gap is its gap to the nearest eager run.
    Where the eager runs are bit-equal (spread 0) the captured ones must
    be; elsewhere (atomic sums in the backwards) a captured run's gap must
    be at most CAPTURE_SPREAD_FACTOR times the spread. Each planted fault
    must break that."""
    import itertools

    spread = {c: max(run_gaps(a, b)[c]
                     for a, b in itertools.combinations(eager, 2))
              for c in GAPS}

    def gap(run):
        each = [run_gaps(run, e) for e in eager]
        return {c: min(g[c] for g in each) for c in spread}

    def holds(g):
        return all(g[c] <= CAPTURE_SPREAD_FACTOR * spread[c] for c in spread)

    gaps = [gap(r) for r in captured]
    worst = {c: max(g[c] for g in gaps) for c in spread}
    require(holds(worst), f"captured step: gaps {worst} against the eager "
                          f"spread {spread}")
    fault_gaps = {name: gap(r) for name, r in faults.items()}
    for name, g in fault_gaps.items():
        require(not holds(g), f"the planted fault {name} passes the "
                              f"captured-step gate: {g}, spread {spread}")
    return {"case": {c: ("bit-equal" if v == 0 else
                         f"eager runs differ: within {CAPTURE_SPREAD_FACTOR}"
                         f"x their spread") for c, v in spread.items()},
            "eager_spread": spread, "captured_gap": worst,
            "captured_gaps": gaps, "faults": fault_gaps}


def phase_train(device, tmp):
    """The training path through ``cli.main``: ``train spatial`` (ssd),
    ``train temporal``, ``export-motions --which both`` (the two trained
    nets) and ``train smooth``, each TRAIN_STEPS steps (two epochs of
    two, so the rate's staircase moves) at full width and batch 8 on
    TRAIN_VIDEOS synthetic jpg clips of TRAIN_FRAMES frames at 360x480;
    then ``cli stitch`` of one clip with the trained triad through
    ``--reference_pth_dir``.

    Each stage runs captured (the default: the step as one CUDA graph)
    and, through the same ``cli.main`` call, with ``loop.train_*`` given
    ``capture_step=False`` (the eager step), in turns: at cuDNN's default
    algorithms captured (the run whose checkpoint goes on, its last step
    traced), eager (last step traced), captured, eager, which give the
    times and traces; then with PyTorch's and cuDNN's deterministic
    algorithms (:func:`deterministic_algorithms`) captured, eager,
    captured and three more eager, and the two planted faults,
    captured: a replay that skips the copy of the new batch into the
    static inputs, and the rate baked in as a Python number at capture.
    Per run the counts are set to 0 just before and read just after; a
    hook waits for the card after each step and records the time, the
    loss terms and the counts; the cache's captures, replays, capture
    seconds and replayed launches, the last update's rate and the peak
    memory allocated and reserved are read after it. Gates: one capture
    and TRAIN_STEPS - 1 replays, K1 and K3 launched per step as the
    recipe says (captured and eager), the last rate on the staircase,
    finite losses, parameters and BatchNorm statistics moved,
    :func:`captured_gate` on the deterministic runs, the export's files,
    the stitched mp4's frames; the gradient gate (:func:`train_grad_gate`);
    K1 and K3 held against their plain versions on the first captured
    run's inputs (its eager first step) and ``TpsCoords``' gradients
    against autograd through the plain version (:func:`tps_grads_held`)."""
    import importlib
    import shutil

    import numpy as np
    import torch

    from stabstitch2_tpu_torch import cli
    from stabstitch2_tpu_torch.models import SmoothNet, SpatialNet, TemporalNet
    from stabstitch2_tpu_torch.ops import corr_cuda, tps_coords_cuda
    from stabstitch2_tpu_torch.train import loop
    from stabstitch2_tpu_torch.train.common import Optimizer
    from stabstitch2_tpu_torch.utils.checkpoint import TrainCheckpointer
    from stabstitch2_tpu_torch.utils.graphs import GraphCache
    from synthetic import write_clip_dirs

    t_gate = time.perf_counter()
    gate = train_grad_gate(device)
    gate["seconds"] = time.perf_counter() - t_gate

    data = os.path.join(tmp, "train")
    for i in range(TRAIN_VIDEOS):
        write_clip_dirs(data, num_frames=TRAIN_FRAMES, height=FRAME_HW[0],
                        width=FRAME_HW[1], seed=30 + i, video_name=f"v{i}")
    triad = os.path.join(tmp, "triad")
    os.makedirs(triad)
    held = PathInputs()
    stages = {}
    # per step: K1 r=5, K1 r=3, K3 launches the recipe makes
    want = {"spatial": (2, 0, 2), "temporal": (0, 1, 1), "smooth": (0, 0, 8)}
    nets = {"spatial": SpatialNet, "temporal": TemporalNet,
            "smooth": SmoothNet}
    files = {"spatial": "spatial_warp.pth", "temporal": "temporal_warp.pth",
             "smooth": "smooth_warp.pth"}
    real = {k: getattr(loop, f"train_{k}") for k in nets}
    real_replay, real_rate = GraphCache._replay, Optimizer.rate

    def stale_batch(self, captured, inputs):
        # the planted fault: the batch (4-D and up) is not copied in
        return real_replay(self, captured, [
            s if x.dim() >= 4 else x
            for s, x in zip(captured.inputs, inputs)])

    def baked_rate(self):
        # the planted fault: the host's rate, a constant of the capture
        return torch.full((), self.lr(self.step_count), dtype=torch.float32,
                          device=self.count.device)

    def run(stage, tag, capture=True, trace=False, record=False, fault=None,
            deterministic=False):
        """One ``cli train`` run of ``stage`` (with the deterministic
        algorithms where asked): its report and its ``{"terms", "state",
        "rate"}``."""
        rec, out = {}, {}

        def wrapped(*args, **kwargs):
            out["run"] = real[stage](*args, on_step=stage_recorder(rec),
                                     capture_step=capture, **kwargs)
            return out["run"]

        setattr(loop, f"train_{stage}", wrapped)
        step_mod = importlib.import_module(
            f"stabstitch2_tpu_torch.train.{stage}")
        step_name = f"{stage}_train_step"
        step_fn = getattr(step_mod, step_name)
        trace_dir = os.path.join(tmp, f"trace_{stage}_{tag}")
        if trace:
            setattr(step_mod, step_name,
                    traced_step(step_fn, trace_dir, TRAIN_STEPS))
        if fault == "stale_batch":
            GraphCache._replay = stale_batch
        elif fault == "baked_rate":
            Optimizer.rate = baked_rate
        model_dir = os.path.join(tmp, f"model_{stage}_{tag}")
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        start_bytes = (torch.cuda.memory_allocated(),
                       torch.cuda.memory_reserved())
        corr_cuda.LAUNCHES.clear()
        tps_coords_cuda.LAUNCHES.clear()
        t0 = time.perf_counter()
        try:
            with (held.recording() if record else contextlib.nullcontext()), \
                    deterministic_algorithms(deterministic):
                rc = cli.main(["train", stage, "--train_path", data,
                               "--model_dir", model_dir,
                               "--max_epoch", str(TRAIN_EPOCHS),
                               "--max_steps_per_epoch",
                               str(TRAIN_STEPS // TRAIN_EPOCHS)])
        finally:
            setattr(loop, f"train_{stage}", real[stage])
            setattr(step_mod, step_name, step_fn)
            GraphCache._replay, Optimizer.rate = real_replay, real_rate
        wall = time.perf_counter() - t0
        require(rc == 0 and len(rec.get("t", ())) == TRAIN_STEPS,
                f"train {stage} {tag}: rc {rc}, steps {len(rec.get('t', ()))}")
        info = stage_report(rec, t0, {"k1_r5": 0, "k1_r3": 0, "k3": 0},
                            TRAIN_STEPS // TRAIN_EPOCHS, trace)
        info.update(wall_s=wall,
                    peak_above_start_bytes=info["peak_memory_bytes"]
                    - start_bytes[0],
                    reserved_above_start_bytes=info["peak_reserved_bytes"]
                    - start_bytes[1])
        tr = out["run"]
        g = tr.graphs
        require((g is not None) == capture, f"train {stage} {tag}: graphs")
        if capture:
            info.update(captures=g.captures, replays=g.replays,
                        capture_s=g.capture_seconds,
                        replayed_per_replay={
                            k: n / max(g.replays, 1)
                            for k, n in g.replayed.items()})
            require(fault is not None or (g.captures, g.replays) == (
                1, TRAIN_STEPS - 1), f"train {stage} {tag}: captures "
                f"{g.captures}, replays {g.replays}")
        if trace:
            traces = sorted(glob.glob(os.path.join(trace_dir, "*.json")))
            require(len(traces) == 1,
                    f"train {stage} {tag}: one traced step {traces}")
            info["traced_step"] = trace_stats(traces[0])[0] if traces \
                else None
        per = info["launches_per_step"]
        got = tuple(per[k] for k in ("k1_r5", "k1_r3", "k3"))
        require(fault is not None or all(
            list(n) == [w] * TRAIN_STEPS for n, w in zip(got, want[stage])),
            f"train {stage} {tag}: launches per step {per}, want "
            f"{want[stage]}")
        require(all(np.isfinite(info["loss"])),
                f"train {stage} {tag}: losses {info['loss']}")
        state = {k: v.detach().cpu().clone()
                 for k, v in tr.net.state_dict().items()}
        rate = float(tr.opt.adam.param_groups[0]["lr"])
        info["last_rate"] = rate
        require(fault is not None or rate == np.float32(
            tr.opt.lr(TRAIN_STEPS - 1)), f"train {stage} {tag}: the last "
            f"update's rate {rate}, want {tr.opt.lr(TRAIN_STEPS - 1)}")
        return info, {"terms": rec["terms"], "state": state,
                      "rate": rate}, model_dir

    def train(stage):
        info, first, model_dir = run(stage, "captured_1", trace=True,
                                     record=True)
        ck = TrainCheckpointer(model_dir)
        payload = ck.restore()
        require(payload is not None and payload["step"] == TRAIN_STEPS,
                f"train {stage}: checkpoints {ck.steps()}")
        info.update(moved(nets[stage], 0, payload["model"]))
        require(info["params_moved"] > 0
                and info["bn_stats_moved"] == info["bn_stats"],
                f"train {stage}: moved {info}")
        shutil.copy(ck.path(ck.latest_step()),
                    os.path.join(triad, files[stage]))
        runs = {"captured_1": info}
        default = {"captured": [first], "eager": []}
        for tag, capture in (("eager_1", False), ("captured_2", True),
                             ("eager_2", False)):
            runs[tag], r, _ = run(stage, tag, capture=capture,
                                  trace=tag == "eager_1")
            default["captured" if capture else "eager"].append(r)
        # the gate's runs, with PyTorch's and cuDNN's deterministic
        # algorithms: the default ones sum in a varying order, so that two
        # eager runs differ (loss 2e-4-1.3e-3 relative after 4 steps) and
        # a gap of 2x the spread of a few of them is a draw; here they are
        # bit-equal where every op has a deterministic version
        captured, eager = [], []
        for tag, capture in (("det_captured_1", True), ("det_eager_1", False),
                             ("det_captured_2", True), ("det_eager_2", False),
                             ("det_eager_3", False), ("det_eager_4", False),
                             ("det_eager_5", False)):
            runs[tag], r, _ = run(stage, tag, capture=capture,
                                  deterministic=True)
            (captured if capture else eager).append(r)
        faults = {}
        for fault in ("stale_batch", "baked_rate"):
            runs[fault], faults[fault], _ = run(stage, fault, fault=fault,
                                                deterministic=True)
        ms = {mode: [m for tag, r in runs.items() if tag.startswith(mode)
                     for m in r["steady_step_ms"]]
              for mode in ("captured", "eager")}
        stages[stage] = {
            "step_ms_median": {m: float(np.median(v)) for m, v in ms.items()},
            "default_cudnn_gaps": {
                "eager_spread": run_gaps(*default["eager"]),
                "captured_to_nearest_eager": [
                    {c: min(run_gaps(r, e)[c] for e in default["eager"])
                     for c in GAPS}
                    for r in default["captured"]]},
            "gate": captured_gate(captured, eager, faults), "runs": runs}

    train("spatial")
    train("temporal")
    t0 = time.perf_counter()
    rc = cli.main(["export-motions", "--train_path", data, "--which", "both",
                   "--reference_pth_dir", triad])
    export_s = time.perf_counter() - t0
    counts = {d: len(os.listdir(os.path.join(data, "v0", d)))
              for d in ("SpatialMotion1", "SpatialMotion2",
                        "TemporalMotion1", "TemporalMotion2")}
    require(rc == 0 and set(counts.values()) == {TRAIN_FRAMES},
            f"export-motions rc {rc}, files {counts}")
    train("smooth")

    one = os.path.join(tmp, "one")
    shutil.copytree(os.path.join(data, "v0"), os.path.join(one, "v0"))
    out = os.path.join(tmp, "stitched")
    t0 = time.perf_counter()
    rc = cli.main(["stitch", "--test_path", one, "--output_path", out,
                   "--reference_pth_dir", triad])
    stitch_s = time.perf_counter() - t0
    n_mp4 = mp4_frames(os.path.join(out, "v0.mp4"))
    require(rc == 0 and n_mp4 == TRAIN_FRAMES,
            f"stitch with the trained triad: rc {rc}, {n_mp4} frames")

    plain = held.hold(("cost_volume", "tps_coords"), "train")
    tps_grads = tps_grads_held(held)
    return {"phase": "train", "videos": TRAIN_VIDEOS,
            "frames": TRAIN_FRAMES, "frame_hw": list(FRAME_HW),
            "batch": 8, "steps": TRAIN_STEPS, "epochs": TRAIN_EPOCHS,
            "dtype": "float32", "stages": stages, "export_s": export_s,
            "export_files_per_stream": counts, "stitch_s": stitch_s,
            "stitched_mp4_frames": n_mp4, "grad_gate": gate,
            "held_against_plain": plain, "tps_coords_grads": tps_grads}


def rel_l2(a, b) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).norm() / b.norm())


def devices_train(devices, data, tmp, tag):
    """The trainer loops on two ranks on ``devices`` (gloo on one card,
    NCCL on two) against the same loops in one process on the first,
    from the same init on the same batches: ``train_temporal`` two steps
    (two epochs of one), ``train_spatial`` one, at batch DEVICE_BATCH and
    full width. Gates: each step's loss within RANKS_LOSS_RTOL; the
    spatial step's gradients within RANKS_GRAD_RTOL_L2 (trunks
    RANKS_TRUNK_GRAD_RTOL_L2); the temporal second step's gradients and
    update within RANKS_LOOP_GRAD_RTOL_L2 and RANKS_UPDATE_RTOL_L2; the
    parameters within RANKS_PARAM_RTOL / RANKS_PARAM_ATOL; one
    checkpoint, written by rank 0 alone, holding the returned weights;
    K1 (and in the spatial loop K3) launched on every rank."""
    import torch

    from stabstitch2_tpu_torch.config import (SpatialTrainConfig,
                                              TemporalTrainConfig)
    from stabstitch2_tpu_torch.models import SpatialNet, TemporalNet
    from stabstitch2_tpu_torch.models.backbone import init_weights
    from stabstitch2_tpu_torch.parallel import backend_for
    from stabstitch2_tpu_torch.train import loop

    out = {"devices": [str(d) for d in devices],
           "backend": backend_for(devices)}
    for stage, make, cfg, steps in (
            ("temporal", TemporalNet, TemporalTrainConfig(
                batch_size=DEVICE_BATCH, max_epoch=2), 2),
            ("spatial", SpatialNet, SpatialTrainConfig(
                batch_size=DEVICE_BATCH, max_epoch=1), 1)):
        train = getattr(loop, f"train_{stage}")
        runs, losses, walls = {}, {}, {}
        for name, dev in (("ranks", list(devices)), ("one", devices[0])):
            rec = losses[name] = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[name] = train(
                data, cfg=cfg, model_dir=os.path.join(tmp, f"{stage}_{name}"),
                max_steps_per_epoch=1, model_h=FRAME_HW[0],
                model_w=FRAME_HW[1], device=dev,
                on_step=lambda i, m, rec=rec: rec.append(float(m["total"])))
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0
        two, one = runs["ranks"], runs["one"]
        require(len(losses["ranks"]) == len(losses["one"]) == steps,
                f"{tag} {stage}: {steps} steps {losses}")
        loss_gap = max(abs(a - b) / abs(b)
                       for a, b in zip(losses["ranks"], losses["one"]))
        require(loss_gap <= RANKS_LOSS_RTOL,
                f"{tag} {stage}: losses {losses} within {RANKS_LOSS_RTOL}")
        path = two.checkpointer.path(steps)
        require(two.saved_by_rank == [[path], []],
                f"{tag} {stage}: rank 0 alone saved step {steps}: "
                f"{two.saved_by_rank}")
        saved = torch.load(path, map_location="cpu",
                           weights_only=True)["model"]
        state, ref = two.net.state_dict(), one.net.state_dict()
        require(all(torch.equal(saved[k], v.cpu()) for k, v in state.items()),
                f"{tag} {stage}: the checkpoint holds the returned weights")
        excess = 0.0
        for k, v in ref.items():
            if v.dtype.is_floating_point:
                d = (state[k] - v).abs() - (RANKS_PARAM_ATOL
                                            + RANKS_PARAM_RTOL * v.abs())
                excess = max(excess, float(d.max()))
        require(excess <= 0.0, f"{tag} {stage}: parameters within rtol "
                f"{RANKS_PARAM_RTOL}, atol {RANKS_PARAM_ATOL} ({excess})")
        grads = {}
        got = dict(two.net.named_parameters())
        for k, p in one.net.named_parameters():
            if p.grad is None:
                continue
            part = "trunk" if k.startswith("feature_extractor") else "heads"
            grads[part] = max(grads.get(part, 0.0),
                              rel_l2(got[k].grad, p.grad))
        info = {"steps": steps, "losses_ranks_vs_one": list(zip(
                    losses["ranks"], losses["one"])),
                "loss_rel_gap": loss_gap, "param_excess": excess,
                "grad_rel_l2_ranks_vs_one": grads,
                "launches_per_rank": two.launches_by_rank,
                "saved_by_rank": two.saved_by_rank,
                "wall_s_ranks": walls["ranks"], "wall_s_one": walls["one"]}
        if steps == 1:
            require(grads["trunk"] <= RANKS_TRUNK_GRAD_RTOL_L2
                    and grads["heads"] <= RANKS_GRAD_RTOL_L2,
                    f"{tag} {stage}: gradients (relative L2) {grads} within "
                    f"{RANKS_TRUNK_GRAD_RTOL_L2} (trunk), "
                    f"{RANKS_GRAD_RTOL_L2}")
        else:
            net = make(*FRAME_HW)
            init_weights(net, torch.Generator().manual_seed(0))
            init = net.state_dict()
            update = max(rel_l2(state[k].cpu() - init[k],
                                ref[k].cpu() - init[k])
                         for k, p in one.net.named_parameters()
                         if p.grad is not None)
            info["update_rel_l2_ranks_vs_one"] = update
            require(max(grads.values()) <= RANKS_LOOP_GRAD_RTOL_L2
                    and update <= RANKS_UPDATE_RTOL_L2,
                    f"{tag} {stage}: step {steps}'s gradients {grads} and "
                    f"the update {update} (relative L2) within "
                    f"{RANKS_LOOP_GRAD_RTOL_L2} and {RANKS_UPDATE_RTOL_L2}")
        want = ["cost_volume"] + (["tps_coords"] if stage == "spatial"
                                  else [])
        require(all(r[k] > 0 for r in two.launches_by_rank for k in want),
                f"{tag} {stage}: {want} launched on every rank "
                f"{two.launches_by_rank}")
        out[stage] = info
    return out


def devices_stitch(devices, data, tmp, tag):
    """``cli stitch``'s loop (``build_stitcher``, the loader thread,
    ``stitch_stream``) at the CLI's defaults over the clips in ``data``,
    with the stitcher dealt over ``devices`` (a device list, or
    ``--n_devices`` when the cards differ), in bulk and stream upload,
    counted; against the one-device stitcher's frames and meshes, bit for
    bit, and one wait per ``stitch_begin``."""
    import torch

    from stabstitch2_tpu_torch import cli
    from stabstitch2_tpu_torch.data.video_io import list_videos
    from stabstitch2_tpu_torch.ops import corr_cuda, fused_warp_cuda

    argv = ["stitch", "--test_path", data, "--output_path",
            os.path.join(tmp, "out")]
    one = cli.build_stitcher(cli.make_parser().parse_args(argv))
    if len(set(devices)) == len(devices):
        args = cli.make_parser().parse_args(argv + ["--n_devices",
                                                    str(len(devices))])
    else:
        args = cli.make_parser().parse_args(argv)
        args.device = list(devices)
    st = cli.build_stitcher(args)
    require(st.devices == list(devices), f"{tag}: stitcher on {st.devices}")
    videos = list_videos(data)
    loaded = {os.path.basename(vd): arrays
              for vd, arrays, _ in cli.load_videos(videos)}

    def run(stitcher, mode):
        got = {}
        stitcher.upload_mode = mode
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            done, failed = cli.stitch_stream(
                stitcher, cli.threaded(cli.load_videos(videos)),
                lambda name, r: got.__setitem__(name, r))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            stitcher.upload_mode = "bulk"
        require((done, failed) == (len(videos), 0),
                f"{tag} {mode}: stitched {done}, failed {failed}")
        return got, wall

    st.stitch_arrays(*loaded[sorted(loaded)[0]])       # warm-up
    one.stitch_arrays(*loaded[sorted(loaded)[0]])
    out = {"devices": [str(d) for d in st.devices],
           "replicas": len(st._motion.replicas)}
    frames = DEVICE_VIDEOS * DEVICE_FRAMES
    for mode in ("bulk", "stream"):
        ref, one_s = run(one, mode)
        corr_cuda.LAUNCHES.clear()
        fused_warp_cuda.LAUNCHES.clear()
        replays = st.graphs.replays
        got, wall = run(st, mode)
        replays = st.graphs.replays - replays
        require((replays > 0) == (mode == "bulk"),
                f"{tag} {mode}: graph replays {replays} (bulk replays, "
                "stream runs eagerly)")
        launches = {"cost_volume": sum(corr_cuda.LAUNCHES.values()),
                    "fused_warp": fused_warp_cuda.LAUNCHES["fused_warp"]}
        require(all(v > 0 for v in launches.values()),
                f"{tag} {mode}: K1 and K2 launched: {launches}")
        for name, r in ref.items():
            same = (r.frames.shape == got[name].frames.shape
                    and bool((r.frames == got[name].frames).all())
                    and mesh_gap(r, got[name]) == 0.0)
            require(same, f"{tag} {mode} {name}: frames and meshes of "
                          f"{len(devices)} devices equal one device's")
        st.upload_mode = mode
        try:
            syncs = begin_waits(st, loaded[sorted(loaded)[0]])
        finally:
            st.upload_mode = "bulk"
        require(one_wait(syncs), f"{tag} {mode}: one wait per stitch_begin "
                                 f"(the canvas fetch): {syncs}")
        out[mode] = {"bit_equal_to_one_device": True, "launches": launches,
                     "graph_replays": replays,
                     "fps": frames / wall, "fps_one_device": frames / one_s,
                     "stitch_begin_waits": syncs}
    return out


def kernels_on(card, warp):
    """Each kernel's wrapper with its inputs on ``card`` against its plain
    version there (the kernels phase's tolerances); ``warp`` is the main
    path's first chunk (:func:`first_chunk`)."""
    import torch

    from stabstitch2_tpu_torch.ops import (corr_cuda, fused_warp_cuda,
                                           patch_gather_cuda, tps_coords_cuda)

    gen = torch.Generator().manual_seed(0)
    h8, w8 = FRAME_HW[0] // 8, FRAME_HW[1] // 8
    x1, x2 = (torch.randn(8, h8, w8, 128, generator=gen).to(card)
              for _ in range(2))
    out = {}
    for r in (5, 3):
        got = corr_cuda.cost_volume_cuda(x1, x2, r)
        ref = corr_cuda.cost_volume_plain(x1, x2, r)
        err = float((got - ref).abs().max())
        require(got.device == card and err <= CV_ATOL + 1e-5 * float(
            ref.abs().max()), f"cost_volume r={r} on {card}: {err}")
        out[f"cost_volume_r{r}"] = err
    im, T, src, size, span = (t.to(card) if torch.is_tensor(t) else t
                              for t in warp)
    got = fused_warp_cuda.fused_warp_planes(im, T, src, size, span)
    ref = fused_warp_cuda.fused_warp_planes_plain(im, T, src, size, span)
    require(got[0].device == card and all(
        torch.equal(g, r) for g, r in zip(got[:4], ref[:4])),
        f"fused_warp on {card} equals its plain version")
    out["fused_warp"] = 0.0
    x, y = tps_coords_cuda.tps_coords(T, src, size, grid_span=span)
    xr, yr = tps_coords_cuda.tps_coords_plain(T, src, size, grid_span=span)
    require(x.device == card and torch.equal(x, xr) and torch.equal(y, yr),
            f"tps_coords on {card} equals its plain version")
    out["tps_coords"] = 0.0
    got = patch_gather_cuda.bilinear_sample_patch_u8_cuda(im, x, y, size)
    ref = patch_gather_cuda.patch_gather_plain(im, x, y, size, False)
    err = float((got[0] - ref[0]).abs().max())
    require(got[0].device == card and torch.equal(got[0], ref[0]),
            f"patch_gather on {card}: {err}")
    out["patch_gather"] = err
    return out


def phase_devices(device, tmp, warp):
    """Multi-device: ``cli stitch`` dealt over two replicas on one card
    (bulk and stream) against one replica, bit for bit
    (:func:`devices_stitch`); two gloo training ranks on that card
    against one process (:func:`devices_train`); and, only where two or
    more cards are visible, the same over two cards (``--n_devices 2``,
    NCCL) and each kernel on the last card (:func:`kernels_on`)."""
    import torch

    from synthetic import write_clip_dirs

    smi = nvidia_smi()
    data = os.path.join(tmp, "devices")
    for seed in range(DEVICE_VIDEOS):
        write_clip_dirs(data, num_frames=DEVICE_FRAMES, height=FRAME_HW[0],
                        width=FRAME_HW[1], seed=40 + seed,
                        video_name=f"clip{seed}")
    train_data = os.path.join(tmp, "devices_train")
    write_clip_dirs(train_data, num_frames=DEVICE_TRAIN_FRAMES,
                    height=FRAME_HW[0], width=FRAME_HW[1], seed=50,
                    video_name="v0")
    one_card = [device, device]
    info = {"phase": "devices", "card": smi, "frame_hw": list(FRAME_HW),
            "videos": DEVICE_VIDEOS, "frames_per_video": DEVICE_FRAMES,
            "stitch_one_card": devices_stitch(one_card, data, tmp,
                                              "two replicas on one card"),
            "train_one_card": devices_train(
                one_card, train_data, os.path.join(tmp, "one_card"),
                "two gloo ranks"),
            "held_against_plain": {}}
    count = torch.cuda.device_count()
    if count < 2:
        info["multi_card"] = "skipped: 1 card"
        emit({"devices": {"multi_card": "skipped: 1 card"}})
        return info
    cards = [torch.device("cuda", i) for i in range(2)]
    last = torch.device("cuda", count - 1)
    info["multi_card"] = {
        "cards": count,
        "stitch": devices_stitch(cards, data, tmp, "two cards"),
        "train": devices_train(cards, train_data,
                               os.path.join(tmp, "two_cards"),
                               "two NCCL ranks"),
        "kernels_on_last_card": {"card": str(last),
                                 "max_abs_err": kernels_on(last, warp)}}
    return info


def main() -> int:
    t_all = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [root, os.path.join(root, "tests")]
    try:
        from stabstitch2_tpu_torch.utils import cuda_build
        from synthetic import make_two_view_clip
    except ImportError as e:
        print(f"chip_smoke: the stabstitch2_tpu_torch package or "
              f"tests/synthetic.py is missing: {e}", file=sys.stderr)
        return 1

    # the slice is float32 end to end: no TF32 anywhere it is compared
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")

    t = time.perf_counter()
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    emit({"phase": "device", "name": name, "count": count, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "seconds": time.perf_counter() - t})

    t = time.perf_counter()
    info = cuda_build.build()
    cuda_build.load_kernels()
    for k in ("fused_warp_kernel", "tps_coords_kernel"):
        rep = info.ptxas.get(k, {})
        require(rep.get("spill_stores") == 0 and rep.get("spill_loads") == 0,
                f"{k} spills nothing: ptxas {rep}")
    logs = log_sass_ops()
    # the bounds count the cheapest log proven bit-equal (kernels phase)
    log_ops = logs["log_core_probe"][0]
    emit({"phase": "build",
          "commands": [" ".join(c) for c in info.commands],
          "nvcc_seconds": info.seconds, "built": info.built,
          "ptxas": info.ptxas,
          "log_fp32_ops": {k: v[0] for k, v in logs.items()},
          "log_fp32_opcodes": {k: v[1] for k, v in logs.items()},
          "seconds": time.perf_counter() - t})

    t = time.perf_counter()
    clip = make_two_view_clip(num_frames=T_FRAMES, height=360, width=480,
                              overlap=0.5, shake_px=4.0, seed=0)
    st, res, info = phase_stitch(device, clip)
    info["seconds"] = time.perf_counter() - t
    emit(info)

    t = time.perf_counter()
    routes = phase_routes(device, clip, st, res)
    routes["seconds"] = time.perf_counter() - t
    emit(routes)

    t = time.perf_counter()
    resize = phase_resize(device, st)
    resize["seconds"] = time.perf_counter() - t
    emit(resize)

    with tempfile.TemporaryDirectory() as tmp:
        data = write_cli_data(tmp)
        t = time.perf_counter()
        loader = phase_loader(data)
        loader["seconds"] = time.perf_counter() - t
        emit(loader)

        t = time.perf_counter()
        st_cli, videos, cli_info = phase_cli(device, tmp, data)
        cli_info["seconds"] = time.perf_counter() - t
        emit(cli_info)

        t = time.perf_counter()
        tr = phase_trace(st_cli, videos, tmp)
        tr["seconds"] = time.perf_counter() - t
        emit(tr)
    del st_cli

    # K1 and K2 carry the launches of the default path (the cli phase)
    launches = cli_info["launches"]
    t = time.perf_counter()
    h8, w8 = 360 // 8, 480 // 8
    kernels = [
        k1_entry([k1_case(5, (st.chunk, h8, w8, 128),
                          launches["cost_volume_r5"], device),
                  k1_case(3, (2 * st.chunk, h8, w8, 128),
                          launches["cost_volume_r3"], device)]),
        k2_entry(st, res, clip, launches["fused_warp"], log_ops),
        k3_entry(st, res, clip, routes["launches"]["tps_coords"], log_ops),
        k4_entry(st, res, clip, routes["launches"]["patch_gather"]),
    ]
    emit({"phase": "kernels", "kernels": [k["name"] for k in kernels],
          "detail": kernels, "seconds": time.perf_counter() - t})

    t = time.perf_counter()
    cmp_ = phase_cpu_compare(st, clip)
    cmp_["seconds"] = time.perf_counter() - t
    emit(cmp_)
    warp = first_chunk(st, res, clip)

    for run in (phase_online, phase_multi, phase_metric, phase_train,
                lambda dev, tmp: phase_devices(dev, tmp, warp)):
        with tempfile.TemporaryDirectory() as tmp:
            t = time.perf_counter()
            info = run(device, tmp)
            info["seconds"] = time.perf_counter() - t
            emit(info)
        # each kernel's error against its plain version: the largest over
        # the kernels phase and the inputs of every path that ran it
        for e in kernels:
            for row in info["held_against_plain"].get(e["name"], ()):
                e["max_abs_err"] = max(e["max_abs_err"], row["max_abs_err"])

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{k: e[k] for k in keys} for e in kernels],
          "total_seconds": time.perf_counter() - t_all})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
