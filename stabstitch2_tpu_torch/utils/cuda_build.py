"""Build and load the package's CUDA kernels (``csrc/*.cu``, ``csrc/*.cuh``).

Each source is compiled by its own ``nvcc`` process, all started
together, and one more ``nvcc`` links the objects into a plain-C shared
library, which is loaded with ``ctypes``::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -Xptxas -v -c -o <build>/<name>.o csrc/<name>.cu
    nvcc -shared -o <build>/libstabstitch_kernels.so <build>/*.o

The library goes to ``stabstitch2_tpu_torch/_build/<hash>/``, where the
hash covers the sources, the headers they include and the flags, so an
edited source or header is rebuilt on its next use. The build writes to a
temporary name and renames it into place: no lock files. Nothing here
runs at import time.
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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_VP = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argtypes (every pointer and the stream c_void_p)
_SIGNATURES = {
    # x1, x2, out, B, H, W, C, r, device, stream
    "stabstitch_cost_volume": [_VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _VP],
    # im, T, source, gx, gy, out, B, H, W, oh, ow, P, device, stream
    "stabstitch_fused_warp": [_VP, _VP, _VP, _VP, _VP, _VP,
                              _I, _I, _I, _I, _I, _I, _I, _VP],
    # T, source, gx, gy, xs, ys, B, oh, ow, P, device, stream
    "stabstitch_tps_coords": [_VP, _VP, _VP, _VP, _VP, _VP,
                              _I, _I, _I, _I, _I, _VP],
    # im, xs, ys, out, B, H, W, N, planes, device, stream
    "stabstitch_patch_gather": [_VP, _VP, _VP, _VP,
                                _I, _I, _I, _I, _I, _I, _VP],
    # lo bits, count, mismatches (u64), first mismatch (u32), device, stream
    "stabstitch_log_core_check": [ctypes.c_uint, ctypes.c_uint, _VP, _VP,
                                  _I, _VP],
}


@dataclasses.dataclass
class BuildInfo:
    """What a build did: the command, its wall seconds and ptxas's report."""

    path: str
    commands: List[List[str]]   # the compiles (run together), then the link
    seconds: float          # 0.0 when the library was already built
    built: bool
    ptxas: Dict[str, Dict[str, int]]   # kernel -> registers, smem, spills


_lib: Optional[ctypes.CDLL] = None


def sources() -> List[str]:
    """The translation units nvcc compiles."""
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def hashed_files() -> List[str]:
    """Everything the library is built from: the sources and the headers
    they include."""
    return sorted(sources() + glob.glob(os.path.join(CSRC, "*.cuh")))


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "",
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the CUDA kernels cannot be built")


def source_digest() -> str:
    """Hash of the flags and of every file in :func:`hashed_files`."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in hashed_files():
        h.update(os.path.basename(s).encode())
        with open(s, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _readable(name: str) -> str:
    """``_Z18cost_volume_kernelILi5ELb1EEv...`` ->
    ``cost_volume_kernel<5,1>`` (integer and bool template arguments)."""
    m = re.match(r"_Z(\d+)(\w+)", name)
    if not m:
        return name
    n = int(m.group(1))
    base, rest = m.group(2)[:n], m.group(2)[n:]
    t = re.match(r"I((?:L[a-z]\d+E)+)E", rest)
    if not t:
        return base
    return f"{base}<{','.join(re.findall(r'L[a-z](\d+)E', t.group(1)))}>"


def parse_ptxas(log: str) -> Dict[str, Dict[str, int]]:
    """Registers, shared memory and spills per kernel from ``-Xptxas -v``."""
    out: Dict[str, Dict[str, int]] = {}
    current = None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) "
                      r"'?([A-Za-z_]\w*)'?", line)
        if m:
            current = _readable(m.group(1))
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
    """Compile ``csrc/*.cu`` (one ``nvcc`` per source, in parallel) and link
    them, unless already built."""
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    out_dir = os.path.join(BUILD_DIR, source_digest())
    path = os.path.join(out_dir, LIB_NAME)
    tag = f"tmp{os.getpid()}"
    nvcc = nvcc_path()
    objs = [os.path.join(out_dir, os.path.basename(s)[:-3] + f".{tag}.o")
            for s in srcs]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", o, s] for o, s in zip(objs, srcs)]
    cmds.append([nvcc, "-shared", "-o", f"{path}.{tag}", *objs])
    log_path = os.path.join(out_dir, "ptxas.log")
    if os.path.isfile(path):
        log = open(log_path).read() if os.path.isfile(log_path) else ""
        return BuildInfo(path, cmds, 0.0, False, parse_ptxas(log))
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds[:-1]]
    outs = [p.communicate()[0] for p in procs]
    for c, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                               f"{' '.join(c)}\n{out}")
    link = subprocess.run(cmds[-1], capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                           f"{' '.join(cmds[-1])}\n{link.stdout}"
                           f"\n{link.stderr}")
    seconds = time.perf_counter() - t0
    for o in objs:
        os.remove(o)
    log = "".join(outs)
    with open(log_path, "w") as f:
        f.write(log)
    os.replace(f"{path}.{tag}", path)
    return BuildInfo(path, cmds, seconds, True, parse_ptxas(log))


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
