"""``ctypes`` binding of the package's native frame loader
(``native/frameloader.cpp``).

The library is built with the host compiler on the first call of
:func:`available` (``utils/native_build.py``, g++ and libjpeg); when that
fails, :func:`available` is False, :func:`build_error` keeps the
compiler's message, and callers decode with cv2.
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Optional, Tuple

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_ERROR: Optional[str] = None
_LOCK = threading.Lock()
BUILD = None        # the HostBuild of the first call, None before it


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    ip = ctypes.POINTER(ctypes.c_int)
    paths = ctypes.POINTER(ctypes.c_char_p)
    i, vp = ctypes.c_int, ctypes.c_void_p
    lib.fl_probe.argtypes = [ctypes.c_char_p, ip, ip]
    lib.fl_probe.restype = i
    lib.fl_decode_batch.argtypes = [paths, i, i, i, vp, i, i, vp, i]
    lib.fl_decode_batch.restype = i
    lib.fl_prefetch_open.argtypes = [paths, i, i, i, i, i, i]
    lib.fl_prefetch_open.restype = vp
    lib.fl_prefetch_get.argtypes = [vp, i, vp, vp]
    lib.fl_prefetch_get.restype = i
    lib.fl_prefetch_close.argtypes = [vp]
    return lib


def _find_lib() -> Optional[ctypes.CDLL]:
    """The library, built and loaded on the first call (once per process,
    under a lock: the CLI's loader thread may get there first)."""
    global _LIB, _TRIED, _ERROR, BUILD
    with _LOCK:
        if not _TRIED:
            _TRIED = True
            from stabstitch2_tpu_torch.utils import native_build

            try:
                BUILD = native_build.build()
                _LIB = _bind(ctypes.CDLL(BUILD.path))
            except (RuntimeError, OSError) as e:
                _ERROR = str(e)
    return _LIB


def available() -> bool:
    """Whether the loader is built and loaded (building it on first call)."""
    return _find_lib() is not None


def build_error() -> Optional[str]:
    """Why the loader is unavailable: the build's or the load's message."""
    _find_lib()
    return _ERROR


def _c_paths(paths: List[str]):
    arr = (ctypes.c_char_p * len(paths))()
    arr[:] = [p.encode() for p in paths]
    return arr


def _lib_or_raise() -> ctypes.CDLL:
    lib = _find_lib()
    if lib is None:
        raise RuntimeError(f"native frame loader unavailable: {_ERROR}")
    return lib


def probe(path: str) -> Tuple[int, int]:
    """(width, height) of one jpg."""
    lib = _lib_or_raise()
    w, h = ctypes.c_int(), ctypes.c_int()
    if lib.fl_probe(path.encode(), ctypes.byref(w), ctypes.byref(h)) != 0:
        raise IOError(f"failed to probe {path}")
    return w.value, h.value


def decode_batch(paths: List[str], lo_size: Optional[Tuple[int, int]] = None,
                 threads: int = 4, want_hi: bool = True
                 ) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """Decode jpgs of one size on ``threads`` threads: (hires uint8 BGR
    [N, H, W, 3] or None without ``want_hi``, the bilinear resize to
    ``lo_size`` (h, w) as uint8 [N, h, w, 3], or None without it).

    Raises IOError when a frame fails to decode or differs in size from
    the first.
    """
    lib = _lib_or_raise()
    w, h = probe(paths[0])
    n = len(paths)
    hi = np.empty((n, h, w, 3), np.uint8) if want_hi else None
    hi_ptr = hi.ctypes.data_as(ctypes.c_void_p) if want_hi else None
    lo, lo_ptr, lh, lw = None, None, 0, 0
    if lo_size is not None:
        lh, lw = lo_size
        lo = np.empty((n, lh, lw, 3), np.uint8)
        lo_ptr = lo.ctypes.data_as(ctypes.c_void_p)
    errors = lib.fl_decode_batch(_c_paths(paths), n, w, h, hi_ptr, lw, lh,
                                 lo_ptr, threads)
    if errors:
        raise IOError(f"{errors} frames failed to decode (size mismatch?)")
    return hi, lo


class FramePrefetcher:
    """Decodes ahead of the consumer on a thread of the library, into a
    ring of ``ring`` slots; frames are read in order with :meth:`get`."""

    def __init__(self, paths: List[str],
                 lo_size: Optional[Tuple[int, int]] = None, ring: int = 16):
        self._lib = _lib_or_raise()
        self.w, self.h = probe(paths[0])
        self.lo_size = lo_size
        lh, lw = lo_size if lo_size else (0, 0)
        self.n = len(paths)
        self._handle = self._lib.fl_prefetch_open(
            _c_paths(paths), self.n, self.w, self.h, lw, lh, ring)

    def get(self, i: int) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Frame ``i`` (after frame i - 1): (hires, resized or None)."""
        hi = np.empty((self.h, self.w, 3), np.uint8)
        lo, lo_ptr = None, None
        if self.lo_size:
            lo = np.empty((*self.lo_size, 3), np.uint8)
            lo_ptr = lo.ctypes.data_as(ctypes.c_void_p)
        err = self._lib.fl_prefetch_get(
            self._handle, i, hi.ctypes.data_as(ctypes.c_void_p), lo_ptr)
        if err:
            raise IOError(f"frame {i} failed to decode (code {err})")
        return hi, lo

    def close(self) -> None:
        if self._handle:
            self._lib.fl_prefetch_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
