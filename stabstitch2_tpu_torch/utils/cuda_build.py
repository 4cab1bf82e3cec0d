"""Build and load the package's CUDA kernels (``csrc/*.cu``).

One ``nvcc`` command compiles every source into a plain-C shared library,
which is loaded with ``ctypes``::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o <build>/libstabstitch_kernels.so csrc/*.cu

The library goes to ``stabstitch2_tpu_torch/_build/<hash>/``, where the
hash covers the sources and the flags, so an edited source is rebuilt on
its next use. The build writes to a temporary name and renames it into
place: no lock files. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import dataclasses
import glob
import hashlib
import os
import re
import shutil
import subprocess
import time
from typing import Dict, List, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_NAME = "libstabstitch_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_VP = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argtypes (every pointer and the stream c_void_p)
_SIGNATURES = {
    # x1, x2, out, B, H, W, C, r, device, stream
    "stabstitch_cost_volume": [_VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _VP],
    # im, T, source, gx, gy, out, B, H, W, oh, ow, P, device, stream
    "stabstitch_fused_warp": [_VP, _VP, _VP, _VP, _VP, _VP,
                              _I, _I, _I, _I, _I, _I, _I, _VP],
}


@dataclasses.dataclass
class BuildInfo:
    """What a build did: the command, its wall seconds and ptxas's report."""

    path: str
    command: List[str]
    seconds: float          # 0.0 when the library was already built
    built: bool
    ptxas: Dict[str, Dict[str, int]]   # kernel -> registers, smem, spills


_lib: Optional[ctypes.CDLL] = None


def sources() -> List[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "",
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the CUDA kernels cannot be built")


def _digest(srcs: List[str]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(os.path.basename(s).encode())
        with open(s, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def parse_ptxas(log: str) -> Dict[str, Dict[str, int]]:
    """Registers, shared memory and spills per kernel from ``-Xptxas -v``."""
    out: Dict[str, Dict[str, int]] = {}
    current = None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) "
                      r"'?([A-Za-z_]\w*)'?", line)
        if m:
            current = m.group(1)
            out.setdefault(current, {})
            continue
        if current is None:
            continue
        rec = out[current]
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            rec["spill_stores"] = int(m.group(1))
            rec["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            rec["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            rec["smem_bytes"] = int(s.group(1)) if s else 0
    return {k: v for k, v in out.items() if v}


def build() -> BuildInfo:
    """Compile ``csrc/*.cu`` with one nvcc call unless already built."""
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    out_dir = os.path.join(BUILD_DIR, _digest(srcs))
    path = os.path.join(out_dir, LIB_NAME)
    tmp = f"{path}.tmp{os.getpid()}"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, *srcs]
    log_path = os.path.join(out_dir, "ptxas.log")
    if os.path.isfile(path):
        log = open(log_path).read() if os.path.isfile(log_path) else ""
        return BuildInfo(path, cmd, 0.0, False, parse_ptxas(log))
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    log = proc.stdout + proc.stderr
    with open(log_path, "w") as f:
        f.write(log)
    os.replace(tmp, path)
    return BuildInfo(path, cmd, seconds, True, parse_ptxas(log))


def load_kernels() -> ctypes.CDLL:
    """The kernel library, built on first use and bound with ``ctypes``."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build().path)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check_launch(kernel: str, err: int) -> None:
    """Raise if a C entry point returned a nonzero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA error {err} at launch")
