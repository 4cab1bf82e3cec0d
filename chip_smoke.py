#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``stabstitch2_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases, each printing one JSON line with its seconds:

1. ``device``: the card's name and count, and its name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives.
2. ``build``: the one ``nvcc`` call that builds ``csrc/*.cu`` into a
   plain-C library (bound with ``ctypes``), its wall seconds and ptxas's
   registers / shared memory / spills per kernel.
3. ``stitch``: the main path through the entry points a user calls,
   ``init_stitcher(rng_seed=0, device="cuda")`` (random float32 weights
   from the seed) and ``stitch_arrays`` on a synthetic two-view clip of 16
   frames at 360x480 made from a numpy seed (``tests/synthetic.py``), at
   the full width of the model (ResNet-18 trunks, 360x480 input, 7x9 mesh,
   7-frame window). The kernels' launch counts are set to 0 just before
   the run and read just after; each must be > 0.
4. ``kernels``: each kernel against its plain PyTorch version on the card,
   at the shapes the main path gives it, with CUDA-event times, the bound
   (bytes over 3.35 TB/s or float32 operations over 67 TFLOP/s, the H100
   SXM's published peaks) and the share of it reached. ``cost_volume``
   runs at both search ranges the path gives it (r=5 and r=3); its entry
   carries each as a case and, at the top, their launch-weighted mean.
5. ``cpu_compare``: the same port on the CPU over the first 8 frames,
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

import json
import os
import subprocess
import sys
import time

T_FRAMES = 16        # clip length of the main-path run
CPU_FRAMES = 8       # frames the CPU comparison runs
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_FLOP_PER_S = 67e12         # H100 SXM float32 outside the tensor cores

# tolerances (see the docstrings of the checks below)
CV_ATOL = 1e-5
# K2's coverage mask against its plain version: a float32 ulp of a sample
# coordinate near 500 px is 6e-5, so 1e-4 allows one rounding step of a
# coordinate and fails any mask that is wrong by a real amount
MASK_ATOL = 1e-4
MESH_ATOL_PX = 0.05
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


def k2_entry(st, res, clip, launches):
    """K2 against its plain version on the first chunk of the main path."""
    import numpy as np
    import torch

    from stabstitch2_tpu_torch.ops import fused_warp_cuda
    from stabstitch2_tpu_torch.ops.interp import support_mask
    from stabstitch2_tpu_torch.ops.tps import tps_sample_coords
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
    size = (c.pad_h, c.pad_w)
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
    x_s, y_s = tps_sample_coords(T, src, size, grid_span=span)
    live = support_mask(x_s, y_s, H, W).reshape(im.shape[0], *size)
    dead_nonzero = int((g[~live] != 0).any(-1).sum())
    require(lsb_max <= 1, f"fused_warp: {lsb_max} uint8 levels vs plain")
    require(dead_nonzero == 0, f"fused_warp: {dead_nonzero} nonzero dead px")
    require(mask_err <= MASK_ATOL, f"fused_warp: mask max|d| {mask_err}")
    require(not bool(got[4]), "fused_warp: viol is False")
    B2, P = im.shape[0], src.shape[1]
    npix = B2 * size[0] * size[1]
    n_live = int(live.sum())
    nbytes = (im.numel() + (T.numel() + src.numel() + size[0] + size[1]) * 4
              + B2 * 4 * size[0] * size[1] * 4)
    # per pixel: spline 8 + 12 per point, corners/weights/mask/support 30;
    # per live pixel: 3 channels x (4 multiplies + 3 adds)
    ops = npix * (38 + 12 * P) + n_live * 21
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
            "live_frac": n_live / npix, "bytes": nbytes, "ops": ops,
            "roofline_share": bms / ms}


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
    emit({"phase": "build", "command": " ".join(info.command),
          "nvcc_seconds": info.seconds, "built": info.built,
          "ptxas": info.ptxas, "seconds": time.perf_counter() - t})

    t = time.perf_counter()
    clip = make_two_view_clip(num_frames=T_FRAMES, height=360, width=480,
                              overlap=0.5, shake_px=4.0, seed=0)
    st, res, launches, info = phase_stitch(device, clip)
    info["seconds"] = time.perf_counter() - t
    emit(info)

    t = time.perf_counter()
    h8, w8 = 360 // 8, 480 // 8
    kernels = [
        k1_entry([k1_case(5, (st.chunk, h8, w8, 128),
                          launches["cost_volume_r5"], device),
                  k1_case(3, (2 * st.chunk, h8, w8, 128),
                          launches["cost_volume_r3"], device)]),
        k2_entry(st, res, clip, launches["fused_warp"]),
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
