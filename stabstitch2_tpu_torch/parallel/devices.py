"""The devices of a run: one, or N with no fallback.

``n_devices`` means what it means in the JAX package: that many devices
do the work of one. A count above the cards that are visible raises; it
never runs on fewer cards or on the CPU. ``device='cpu'`` puts N replicas
(or ranks) on the CPU, which is what the CPU tests use. An explicit list
of devices (e.g. ``[cuda:0, cuda:0]``, two replicas or ranks on one card)
is taken as it is.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch

DeviceSpec = Union[str, torch.device, Sequence[Union[str, torch.device]]]


def resolve_device(device) -> torch.device:
    """The device to run on; a CUDA device must exist, there is no fallback."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is "
                           "available (pass device='cpu' to run on the CPU)")
    return device


def resolve_devices(n_devices: Optional[int], device: DeviceSpec = "cuda"
                    ) -> List[torch.device]:
    """The devices of an ``n_devices`` run.

    ``device`` a list or tuple: those devices (``n_devices`` None or their
    number). ``'cpu'``: ``n_devices`` times the CPU. ``'cuda'`` or
    ``'cuda:k'``: cards k .. k + n - 1, which must be visible. One device
    (``n_devices`` None or 1) is :func:`resolve_device`'s.
    """
    if isinstance(device, (list, tuple)):
        devices = [resolve_device(d) for d in device]
        if not devices or n_devices not in (None, len(devices)):
            raise ValueError(f"n_devices={n_devices} with the devices "
                             f"{[str(d) for d in devices]}")
        return devices
    n = 1 if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    dev = resolve_device(device)
    if n == 1 or dev.type != "cuda":
        return [dev] * n
    first = dev.index or 0
    visible = torch.cuda.device_count()
    if first + n > visible:
        raise RuntimeError(
            f"n_devices={n} from cuda:{first} needs {first + n} cards, but "
            f"{visible} are visible (no fallback to fewer cards or the CPU)")
    return [torch.device("cuda", first + i) for i in range(n)]


def backend_for(devices: Sequence[torch.device]) -> str:
    """The ``torch.distributed`` backend of ranks on ``devices``: NCCL when
    every rank owns a card of its own, else gloo (ranks on the CPU, or
    several ranks on one card, which NCCL refuses)."""
    cards = [d for d in devices if d.type == "cuda"]
    if len(cards) == len(devices) and len(set(cards)) == len(cards):
        return "nccl"
    return "gloo"
