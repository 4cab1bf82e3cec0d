"""Host-to-device copies that do not block the host.

A copy from pageable host memory to the card waits for the stream, and so
for all the device work queued before it: a small constant made with
``torch.tensor(..., device='cuda')`` in the middle of a video's enqueue
would wait for the previous video. These helpers stage the data in
page-locked memory and copy with ``non_blocking=True``. PyTorch's caching
host allocator records the copy on its stream and reuses a staging block
only after the copy has completed; on the CPU nothing is staged.
"""

from __future__ import annotations

import functools

import torch


def pinned(x, device) -> torch.Tensor:
    """``x`` (numpy array or CPU tensor) as a host tensor to copy to
    ``device``: page-locked when ``device`` is a card, else ``x`` itself."""
    t = torch.as_tensor(x)
    return t.pin_memory() if torch.device(device).type == "cuda" else t


def to_device(x, device) -> torch.Tensor:
    """Copy ``x`` to ``device`` without blocking the host."""
    return pinned(x, device).to(device, non_blocking=True)


def constant(data, dtype: torch.dtype, device) -> torch.Tensor:
    """``torch.tensor(data, dtype=dtype, device=device)`` without blocking
    the host."""
    return to_device(torch.tensor(data, dtype=dtype), device or "cpu")


@functools.lru_cache(maxsize=None)   # never evicts: a graph may read it
def _shape_constant(data: tuple, dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    return constant(data, dtype, device)


def _frozen(data):
    return tuple(_frozen(x) for x in data) if isinstance(
        data, (list, tuple)) else float(data)


def shape_constant(data, dtype: torch.dtype, device) -> torch.Tensor:
    """:func:`constant` for values fixed by integer sizes (mesh scales,
    corner points, the homography's normalization at a model or feature
    size), made once per value, dtype and device and kept for the life of
    the process; read-only. A program captured as a CUDA graph
    (``utils/graphs.py``) may read it: it copies nothing from the host
    there, since the eager first call made it, and it is never freed
    while the graph may still read it. Values that vary from call to call
    (a canvas's extent) take :func:`constant`."""
    return _shape_constant(_frozen(data), dtype,
                           torch.device(device or "cpu"))
