"""Captured device programs: the port's counterpart of the JAX package's
``jax.jit`` cache on its fused motion programs (``pipeline/stitcher.py:
_motion_fused``, ``_smooth_phase``; ``pipeline/online.py:_step``) and on
its training steps (``train/{spatial,temporal,smooth}.py:*_train_step``).

PyTorch runs eagerly, so a motion chain costs one host dispatch per
kernel: ~114 kernels per frame in ``stitch_begin`` and ~1,000 per online
push, for a few ms of device work. :meth:`GraphCache.run` runs a function
of tensors as a CUDA graph (``torch.cuda.graphs``) instead, one captured
program per key, replayed by one launch on every later call. The key is
the caller's name, the device, the inputs' shapes and dtypes, and the
identity of the modules (and other objects, such as an optimizer) the
function reads (their parameters are read in place, so a module replaced
by a copy needs a new graph).

- The first call at a key runs the function eagerly on the current
  stream: its result is that call's, and the run makes what CUDA and the
  port create at first use (cuBLAS and cuDNN handles and workspaces, the
  kernels' library, ``utils/transfer.py:shape_constant``), so none of it
  falls inside the capture. Then the function is captured into a graph
  on a capture stream of the device, reading static copies of the inputs,
  its memory taken from the cache's one pool on that device
  (``torch.cuda.graph_pool_handle()``), which the cache's graphs share.
- Every later call copies its inputs into the static ones, replays the
  graph on the current stream and returns copies of the static outputs:
  a later replay (of this graph, or of another one whose intermediates
  share the pool) overwrites the static outputs, so nothing outside the
  cache holds them. Replays on one stream run one after the other, which
  is what makes the shared pool safe.
- A capture runs under ``capture_error_mode="thread_local"``: the CLI's
  loader thread decodes beside it and must not break it. Anything in the
  function that waits for the card or copies from the host (``.item()``,
  a branch on a tensor's value, ``torch.tensor(..., device=...)``) makes
  the capture raise, and the process should stop there: on an H100
  the next call after a failed capture raised too. Nothing falls back to
  the eager function.
- The kernels' wrappers count their launches (``LAUNCHES`` of
  ``ops/corr_cuda.py``, ``fused_warp_cuda.py``, ``tps_coords_cuda.py``,
  ``patch_gather_cuda.py``) when Python calls them. A capture calls them
  without launching: the counts it adds are taken off again and kept as
  the graph's, and each replay adds them, so the counts stay what the
  card runs.

A training step's graph (``train/common.py:run_step``) holds the whole
step: normalization and augmentation of the static batch, the forward
with BatchNorm's running statistics updated in place, the backward (K1's
and K3's plain backwards with it) accumulating into the parameters'
gradient tensors, which the eager first step made and ``zero_grad``
zeroes in place, the clip, the rate from the optimizer's device count,
the count's increment and Adam's update of the parameters and its state
in place. Its static outputs are the detached loss terms. Nothing of it
moves Python state, so the capture changes no count: the host counts
the step after :meth:`GraphCache.run` returns.

On a CPU device, which the caller asked for, :meth:`GraphCache.run` calls
the function directly: that is the path the CPU tests take, and the card
path differs from it only in capture and replay.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from stabstitch2_tpu_torch.ops import (corr_cuda, fused_warp_cuda,
                                       patch_gather_cuda, tps_coords_cuda)

# the modules whose LAUNCHES a capture records and a replay adds to
COUNTED = (corr_cuda, fused_warp_cuda, tps_coords_cuda, patch_gather_cuda)


def _launches() -> List[collections.Counter]:
    return [collections.Counter(m.LAUNCHES) for m in COUNTED]


def _flatten(out) -> Tuple[List[torch.Tensor], Callable]:
    """A function's result (a tensor, a tuple of tensors or a dict of
    them) as a list, and how to rebuild it from one."""
    if isinstance(out, dict):
        keys = list(out)
        return [out[k] for k in keys], lambda xs: dict(zip(keys, xs))
    if isinstance(out, (tuple, list)):
        return list(out), tuple
    return [out], lambda xs: xs[0]


@dataclasses.dataclass
class _Captured:
    graph: "torch.cuda.CUDAGraph"
    inputs: List[torch.Tensor]        # static: copied into before a replay
    outputs: List[torch.Tensor]       # static: copied out after a replay
    rebuild: Callable
    launches: List[collections.Counter]   # per COUNTED module, per replay
    modules: Tuple                    # held, so that their ids stay theirs


class GraphCache:
    """One captured program per key, replayed (see the module docstring).

    ``captures`` and ``replays`` count this cache's captures and replays,
    ``capture_seconds`` the host seconds its captures took;
    ``replayed`` counts the kernel launches its replays made, by kernel
    (``cost_volume_r5``, ``cost_volume_r3``, ``fused_warp``,
    ``tps_coords``, ``patch_gather``).
    """

    def __init__(self):
        self._graphs: Dict[tuple, _Captured] = {}
        self._pools: Dict[torch.device, tuple] = {}
        self._streams: Dict[torch.device, torch.cuda.Stream] = {}
        self.captures = 0
        self.capture_seconds = 0.0
        self.replays = 0
        self.replayed: collections.Counter = collections.Counter()

    def __len__(self) -> int:
        return len(self._graphs)

    def run(self, name: str, fn: Callable, *inputs: torch.Tensor,
            modules: Sequence[object] = ()):
        """``fn(*inputs)``: directly on the CPU; on a card eagerly at a
        key's first call and then captured, replayed at every later call
        (outputs returned as copies). ``fn`` reads ``modules`` (and
        nothing else that changes between calls except ``inputs`` and
        tensors the caller updates in place)."""
        device = inputs[0].device
        if device.type != "cuda":
            return fn(*inputs)
        key = self.key(name, inputs, modules)
        captured = self._graphs.get(key)
        with torch.cuda.device(device):
            if captured is None:
                out = fn(*inputs)
                self._graphs[key] = self._capture(device, fn, inputs,
                                                  tuple(modules))
                return out
            return self._replay(captured, inputs)

    @staticmethod
    def key(name: str, inputs: Sequence[torch.Tensor],
            modules: Sequence[object] = ()) -> tuple:
        """The key of :meth:`run`'s call: one graph per key."""
        return (name, inputs[0].device,
                tuple((tuple(x.shape), x.dtype) for x in inputs),
                tuple(id(m) for m in modules))

    def _capture(self, device, fn, inputs, modules) -> _Captured:
        t0 = time.perf_counter()
        static = [x.clone() for x in inputs]
        if device not in self._pools:
            self._pools[device] = torch.cuda.graph_pool_handle()
            self._streams[device] = torch.cuda.Stream(device)
        before = _launches()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=self._pools[device],
                                  stream=self._streams[device],
                                  capture_error_mode="thread_local"):
                outputs, rebuild = _flatten(fn(*static))
        finally:
            during = _launches()
            for m, c in zip(COUNTED, before):
                m.LAUNCHES.clear()
                m.LAUNCHES.update(c)
        self.captures += 1
        self.capture_seconds += time.perf_counter() - t0
        return _Captured(graph, static, outputs, rebuild,
                         [d - b for d, b in zip(during, before)], modules)

    def _replay(self, captured: _Captured, inputs):
        for s, x in zip(captured.inputs, inputs):
            s.copy_(x)
        captured.graph.replay()
        self.replays += 1
        for m, c in zip(COUNTED, captured.launches):
            m.LAUNCHES.update(c)
            self.replayed.update({_name(m, k): n for k, n in c.items()})
        return captured.rebuild([o.clone() for o in captured.outputs])


def _name(module, key) -> str:
    """A kernel's name in :attr:`GraphCache.replayed`."""
    if module is corr_cuda:
        return f"cost_volume_r{key}"
    return str(key)
