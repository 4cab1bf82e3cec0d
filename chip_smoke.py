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
3. ``stitch``: the main path through the entry points a user calls,
   ``init_stitcher(rng_seed=0, device="cuda")`` (random float32 weights
   from the seed) and ``stitch_arrays`` on a synthetic two-view clip of 16
   frames at 360x480 made from a numpy seed (``tests/synthetic.py``), at
   the full width of the model (ResNet-18 trunks, 360x480 input, 7x9 mesh,
   7-frame window). The kernels' launch counts are set to 0 just before
   the run and read just after; each must be > 0.
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
6. ``kernels``: each kernel against its plain PyTorch version on the card,
   at the shapes the main path gives it, with CUDA-event times, the bound
   (bytes over 3.35 TB/s or float32 operations over 67 TFLOP/s, the H100
   SXM's published peaks; an FMA counts two operations) and the share of
   it reached. ``cost_volume``
   runs at both search ranges the path gives it (r=5 and r=3); its entry
   carries each as a case and, at the top, their launch-weighted mean.
   The warp kernels run on the first chunk of the stitch phase (16 images
   onto the padded canvas); K3 and K4 carry the routes phase's launches.
   K2 must equal its plain version bit for bit (planes and mask), and
   its log (``log_core``) must equal ``logf`` on every float32 from 1e-6
   to FLT_MAX.
7. ``cpu_compare``: the same port on the CPU over the first 8 frames,
   against the card: smooth meshes, and composited frames on the same
   meshes with AVERAGE and with LINEAR fusion (LINEAR reads K2's coverage
   masks).

Then one line ``{"kernels": [...]}``, the nvidia-smi line, and as the last
line ``{"ok": true, "device": {...}}``. Any failed check raises, so the
script exits nonzero without that last line. It exits nonzero before
printing anything where no CUDA device is present or the package is
missing.
"""

from __future__ import annotations

import collections
import json
import os
import re
import subprocess
import sys
import time

T_FRAMES = 16        # clip length of the main-path run
CPU_FRAMES = 8       # frames the CPU comparison runs
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_FLOP_PER_S = 67e12         # H100 SXM float32 outside the tensor cores

# tolerances (see the docstrings of the checks below)
CV_ATOL = 1e-5
# K2's coverage mask and K4's samples against their plain versions: a
# float32 ulp of a sample coordinate near 500 px is 6e-5, so 1e-4 allows
# one rounding step of a coordinate and fails any value wrong by a real
# amount (0 is expected: the same float32 operations in the same order)
MASK_ATOL = 1e-4
GATHER_ATOL = 1e-4
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
FRAC_DIFF = 1e-2
FRAC_DIFF_GT1 = 1e-4


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
    """The main path, counted: returns the stitcher and its result."""
    import numpy as np
    import torch

    from stabstitch2_tpu_torch.ops import corr_cuda, fused_warp_cuda
    from stabstitch2_tpu_torch.pipeline.stitcher import init_stitcher

    v1, v2 = clip
    st = init_stitcher(rng_seed=0, device=device)
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
    return st, res, launches, info


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
        require(errs[key] <= GATHER_ATOL,
                f"patch_gather {key}: max|d| {errs[key]} vs plain")
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
    return {"name": "patch_gather", "route": "cuda",
            "source": "stabstitch2_tpu_torch/csrc/patch_gather.cu",
            "replaces": "stabstitch2_tpu/ops/pallas_gather.py:72",
            "launches": launches, "max_abs_err": max(errs.values()),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": library_ms,
            "library_note": "F.grid_sample(bilinear, zeros, "
                            "align_corners=False) on the float32 NCHW image "
                            "at the same coordinates: the same four-corner "
                            "gather and combine per pixel, with another "
                            "border rule and float input",
            "max_abs_err_by_layout": errs, "dead_nonzero": dead,
            "atol": GATHER_ATOL, "images": B2, "source_hw": [int(H), int(W)],
            "canvas_hw": list(size), "live_frac": n_live / npix,
            "bytes": nbytes, "ops": ops, "roofline_share": bms / ms}


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
    sb = init_stitcher(rng_seed=0, config=cfg_b, device=device)
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
    from stabstitch2_tpu_torch.config import StitchConfig
    from stabstitch2_tpu_torch.pipeline.compositor import composite_video
    from stabstitch2_tpu_torch.pipeline.stitcher import init_stitcher

    v1, v2 = (v[:CPU_FRAMES] for v in clip)
    st_cpu = init_stitcher(rng_seed=0, device="cpu")
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
    st, res, launches, info = phase_stitch(device, clip)
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
