"""Design variants of the patch-gather kernel K4, timed on the card against
the shipped kernel (``csrc/patch_gather.cu``) in one run::

    python -m stabstitch2_tpu_torch.lab.k4_variants

The variants (``lab/k4_variants.cu``) are K4 as first written (one pixel
a thread, byte loads), one pixel a thread with word reads, four pixels a
thread (float4 loads and stores, registers unbounded), two pixels a
thread with stores staged through shared memory, two pixels a thread
without the planar path at 32 and at 40 registers, and two floors that
move the same coordinate and output bytes with no gather. Inputs: 16 random
uint8 BGR images of 360x480 sampled on a 448x608 raster (the main path's
route-B shapes) that a small rotation spreads 15% past every side.

Each kernel is timed queued behind ``torch.cuda._sleep`` (CUDA events
around ITERS launches, so the host's issue time is hidden), ROUNDS times
in turns, and held against the plain version bit for bit (the floors
compute no sample). Prints one JSON line per kernel (registers and spills
from ptxas, median/min/max ms, share of the bytes bound) and the card's
name and power limit. Needs a card and ``nvcc``; builds into the
git-ignored ``_build/lab/``.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ITERS = 50
ROUNDS = 6
VARIANTS = {"one_pixel_bytes": 0, "one_pixel_words": 1,
            "four_pixels": 2, "two_pixels_staged_stores": 3,
            "floor_two_pixels": 4, "floor_two_pixels_full_grid": 5,
            "two_pixels_interleaved_32_registers": 6,
            "two_pixels_interleaved_40_registers": 7}
# ptxas names of the variants' kernels, by variant
PTXAS = {0: "bytes_kernel", 1: "pix_kernel<1,8,1,0>", 2: "pix_kernel<4,1,1,0>",
         3: "pix_kernel<2,8,1,1>", 4: "pix_kernel<2,8,0,0>",
         5: "pix_kernel<2,8,0,0>", 6: "pix_kernel<2,8,1,0>",
         7: "pix_kernel<2,6,1,0>"}
HBM_BYTES_PER_S = 3.35e12


def build():
    """nvcc the variants into a shared library; (path, ptxas report)."""
    from stabstitch2_tpu_torch.utils import cuda_build

    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(here, "k4_variants.cu")
    out_dir = os.path.join(cuda_build.BUILD_DIR, "lab")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "libk4_variants.so")
    cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-shared",
           "-I", cuda_build.CSRC, "-o", path, src]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{' '.join(cmd)}\n{r.stdout}"
                           f"{r.stderr}")
    return path, cuda_build.parse_ptxas(r.stdout + r.stderr)


def inputs(device):
    import numpy as np
    import torch

    B, H, W, oh, ow = 16, 360, 480, 448, 608
    rng = np.random.default_rng(0)
    im = torch.from_numpy(rng.integers(0, 256, (B, H, W, 3),
                                       dtype=np.uint8)).to(device)
    xx = np.tile(np.linspace(-1.15, 1.15, ow, dtype=np.float32), oh)
    yy = np.repeat(np.linspace(-1.15, 1.15, oh, dtype=np.float32), ow)
    th = rng.uniform(-0.05, 0.05, (B, 1)).astype(np.float32)
    x = (xx * np.cos(th) - yy * np.sin(th)).astype(np.float32)
    y = (xx * np.sin(th) + yy * np.cos(th)).astype(np.float32)
    return (im, torch.from_numpy(x).to(device), torch.from_numpy(y).to(device),
            (oh, ow))


def main() -> int:
    import numpy as np
    import torch

    from stabstitch2_tpu_torch.ops import patch_gather_cuda as pg
    from stabstitch2_tpu_torch.ops.interp import support_mask

    if not torch.cuda.is_available():
        print("k4_variants: needs a CUDA device", file=sys.stderr)
        return 1
    from stabstitch2_tpu_torch.utils import cuda_build

    path, ptxas = build()
    ptxas.update(cuda_build.build().ptxas)
    lib = ctypes.CDLL(path)
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.k4_variant.argtypes = [i, vp, vp, vp, vp, i, i, i, i, vp]
    lib.k4_variant.restype = ctypes.c_int
    dev = torch.device("cuda")
    im, x, y, size = inputs(dev)
    B, H, W, _ = im.shape
    N = size[0] * size[1]
    ref = pg.patch_gather_plain(im, x, y, size)[0]
    out = torch.empty_like(ref)
    stream = torch.cuda.current_stream().cuda_stream

    def variant(v):
        def run():
            err = lib.k4_variant(v, im.data_ptr(), x.data_ptr(), y.data_ptr(),
                                 out.data_ptr(), B, H, W, N, stream)
            if err:
                raise RuntimeError(f"variant {v}: CUDA error {err}")
        return run

    kernels = {"shipped_two_pixels": lambda: pg.bilinear_sample_patch_u8_cuda(
        im, x, y, size)}
    kernels.update({k: variant(v) for k, v in VARIANTS.items()})
    rows = {}
    for name, fn in kernels.items():
        out.fill_(-1.0)
        got = fn()
        torch.cuda.synchronize()
        got = got[0] if got is not None else out
        rows[name] = {"equal_to_plain": bool(torch.equal(got, ref)), "ms": []}
    for r in range(ROUNDS):
        order = list(kernels.items())
        for name, fn in (order if r % 2 == 0 else order[::-1]):
            fn()
            torch.cuda._sleep(int(2e9 * ITERS * 1e-4 * 4))
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(ITERS):
                fn()
            b.record()
            b.synchronize()
            rows[name]["ms"].append(a.elapsed_time(b) / ITERS)
    nbytes = im.numel() + 8 * B * N + 12 * B * N
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    kernel_names = {"shipped_two_pixels": "patch_gather_kernel",
                    **{k: PTXAS[v] for k, v in VARIANTS.items()}}
    for name, row in rows.items():
        ms = row.pop("ms")
        med = float(np.median(ms))
        print(json.dumps({"kernel": name, **row,
                          "ptxas": ptxas.get(kernel_names[name]),
                          "queued_ms": {"median": med, "min": min(ms),
                                        "max": max(ms)},
                          "bound_ms": bound_ms, "share": bound_ms / med}),
              flush=True)
    print(json.dumps({"live_frac": float(support_mask(x, y, H, W).float()
                                         .mean()),
                      "rounds": ROUNDS, "iters": ITERS, "bytes": nbytes}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
