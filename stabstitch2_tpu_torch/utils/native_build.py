"""Build the package's native frame loader (``native/frameloader.cpp``).

One call of the host compiler, with the flags of the JAX package's
``native/Makefile``::

    g++ -O3 -fPIC -std=c++17 -Wall -shared native/frameloader.cpp \
        -o <build>/libframeloader.so -ljpeg -lpthread

(``$CXX`` replaces ``g++`` where it is set, as in the Makefile). It needs
libjpeg's header and library. The library goes to
``stabstitch2_tpu_torch/_build/<hash>/``, the hash over the source and
the flags, written under a temporary name and renamed into place, as
``utils/cuda_build.py`` does. Nothing here runs at import time:
``data/native.py`` builds on its first use.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import subprocess
import time
from typing import List

from stabstitch2_tpu_torch.utils.cuda_build import BUILD_DIR

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "native", "frameloader.cpp")
LIB_NAME = "libframeloader.so"
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-shared"]
LD_FLAGS = ["-ljpeg", "-lpthread"]


@dataclasses.dataclass
class HostBuild:
    """What a build did: the library, the command and its wall seconds
    (0.0 when the library was already built)."""

    path: str
    command: List[str]
    seconds: float
    built: bool


def compiler() -> str:
    return os.environ.get("CXX") or "g++"


def source_digest() -> str:
    """Hash of the compiler, the flags and the source."""
    h = hashlib.sha256(" ".join([compiler(), *CXX_FLAGS, *LD_FLAGS]).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return h.hexdigest()[:16]


def libjpeg_missing(message: str) -> bool:
    """Whether a failed build's message says only that libjpeg's header or
    library is absent."""
    return ("jpeglib.h" in message and "No such file" in message) or (
        "cannot find -ljpeg" in message)


def build() -> HostBuild:
    """Compile the loader unless already built. Raises RuntimeError with
    the compiler's message when the build fails."""
    out_dir = os.path.join(BUILD_DIR, source_digest())
    path = os.path.join(out_dir, LIB_NAME)
    tmp = f"{path}.tmp{os.getpid()}"
    cmd = [compiler(), *CXX_FLAGS, SOURCE, "-o", tmp, *LD_FLAGS]
    if os.path.isfile(path):
        return HostBuild(path, cmd, 0.0, False)
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    try:
        r = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:            # no compiler at all
        raise RuntimeError(f"{' '.join(cmd)}: {e}") from e
    if r.returncode != 0:
        raise RuntimeError(f"frame loader build failed ({r.returncode}):\n"
                           f"{' '.join(cmd)}\n{r.stdout}{r.stderr}")
    os.replace(tmp, path)
    return HostBuild(path, cmd, time.perf_counter() - t0, True)
