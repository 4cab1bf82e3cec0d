"""Data-parallel training over N processes (port of ``parallel/train.py``).

The JAX package jits one step over its mesh, so its BatchNorm takes the
statistics of the global batch and every loss is a mean over it. Here N
processes, spawned by :func:`run_ranks` and joined under one
``torch.distributed`` process group, each take their rows of the same
global batch: rank r the rows [r B/N, (r+1) B/N). The nets' BatchNorm
layers all-reduce their sums (``models/backbone.py:BatchNorm2d``), the
optimizer averages the gradients before the clip and the loss terms
after the step (``train/common.py:Optimizer``), so a step of N ranks is
the step of one process on the whole batch.

Ranks that each own a card use NCCL; ranks on the CPU, or several on one
card (which NCCL refuses), use gloo (``parallel/devices.py:backend_for``).
They meet through a ``file://`` store in a fresh directory of the run's
own, so runs side by side never share a port. Each rank runs PyTorch on
one intra-op thread, with the caller's TF32 settings (``cli train`` turns
TF32 off; a fresh process would have cuDNN's TF32 convolutions on).
Everything a rank gets and returns crosses as ``torch.save`` bytes, and
the functions a rank runs live in this package, so a rank imports
neither JAX nor the tests.

A run has no deadline of its own: the caller waits until every rank has
sent its result, and fails as soon as one rank fails or dies. Two bounds
catch ranks that hang: the rendezvous fails after RANK_TIMEOUT_S (a rank
that never arrives), and a collective after GROUP_TIMEOUT_S (a rank that
stops taking part; it must outlast the work rank 0 does alone while the
others wait at the epoch's barrier, such as scoring the test set).
"""

from __future__ import annotations

import dataclasses
import datetime
import io
import os
import queue
import shutil
import tempfile
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from stabstitch2_tpu_torch.parallel.devices import backend_for

# a rendezvous that is not complete after this many seconds fails
RANK_TIMEOUT_S = 600.0
# a collective or barrier that waits longer than this fails
GROUP_TIMEOUT_S = 4 * 3600.0
# a rank that has sent its result is killed if it has not exited by then
EXIT_TIMEOUT_S = 60.0


@dataclasses.dataclass(frozen=True)
class Rank:
    """One process of a data-parallel run: its rank, the number of ranks,
    its device and the process group (None for a run of one process)."""

    rank: int
    world: int
    device: torch.device
    group: Any = None

    def rows(self, batch_size: int) -> slice:
        """This rank's rows of a global batch."""
        if batch_size % self.world:
            raise ValueError(f"batch_size {batch_size} is not divisible by "
                             f"n_devices {self.world}")
        n = batch_size // self.world
        return slice(self.rank * n, (self.rank + 1) * n)

    def barrier(self) -> None:
        """Wait for every rank (nothing in a run of one process)."""
        if self.group is not None:
            import torch.distributed as dist

            dist.barrier(group=self.group)


def _dumps(obj) -> bytes:
    buf = io.BytesIO()
    torch.save(obj, buf)
    return buf.getvalue()


def _loads(data: bytes):
    # only bytes this module or its ranks wrote
    return torch.load(io.BytesIO(data), map_location="cpu",
                      weights_only=False)


def _tf32() -> Tuple[bool, bool]:
    """Whether cuDNN convolutions and CUDA matrix products may use TF32."""
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


def _rank_main(rank: int, devices: Sequence[torch.device], init_method: str,
               job: bytes, results, timeouts: Tuple[float, float],
               tf32: Tuple[bool, bool]) -> None:
    """A spawned rank: take the caller's TF32 settings (a new process has
    PyTorch's defaults, TF32 convolutions on), join the group within the
    rendezvous timeout, run the job on a group with the collectives'
    timeout, send its result."""
    import torch.distributed as dist

    try:
        torch.set_num_threads(1)
        torch.backends.cudnn.allow_tf32 = tf32[0]
        torch.backends.cuda.matmul.allow_tf32 = tf32[1]
        device = devices[rank]
        if device.type == "cuda":
            torch.cuda.set_device(device)
        fn, args = _loads(job)
        rendezvous_s, group_s = timeouts
        dist.init_process_group(
            backend_for(devices), init_method=init_method, rank=rank,
            world_size=len(devices),
            timeout=datetime.timedelta(seconds=rendezvous_s))
        try:
            group = dist.new_group(
                list(range(len(devices))),
                timeout=datetime.timedelta(seconds=group_s))
            out = fn(Rank(rank, len(devices), device, group), *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, _dumps(out)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn: Callable, devices: Sequence[torch.device], args=(),
              run_dir: Optional[str] = None) -> List[Any]:
    """``fn(rank, *args)`` on ``len(devices)`` spawned processes, rank r on
    ``devices[r]``, under one process group; returns each rank's result
    in rank order.

    ``fn`` must be importable by name (a function of this package).
    Waits as long as the ranks work; raises with the rank's traceback as
    soon as one fails, or when one exits without a result, and then
    kills every rank. The rendezvous and the collectives are bounded by
    RANK_TIMEOUT_S and GROUP_TIMEOUT_S (module docstring). The rendezvous
    file lives in a fresh directory under ``run_dir`` (default: the
    temporary directory), removed at the end.
    """
    import multiprocessing

    # 'cuda' without an index is the current card, as a tensor there has it
    devices = [torch.device("cuda", torch.cuda.current_device())
               if d.type == "cuda" and d.index is None else d
               for d in map(torch.device, devices)]
    ctx = multiprocessing.get_context("spawn")
    if run_dir:
        os.makedirs(run_dir, exist_ok=True)
    store = tempfile.mkdtemp(prefix=".rendezvous_", dir=run_dir)
    results = ctx.Queue()
    job = _dumps((fn, tuple(args)))
    procs = [ctx.Process(target=_rank_main,
                         args=(r, devices,
                               "file://" + os.path.join(store, "store"), job,
                               results, (RANK_TIMEOUT_S, GROUP_TIMEOUT_S),
                               _tf32()))
             for r in range(len(devices))]
    got: Dict[int, Any] = {}
    try:
        for p in procs:
            p.start()
        while len(got) < len(procs):
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue.Empty:
                dead = [(i, p.exitcode) for i, p in enumerate(procs)
                        if i not in got and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"ranks exited without a result "
                                       f"(rank, exit code): {dead}")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{payload}")
            got[rank] = _loads(payload)
        for p in procs:     # every result is in: a rank stuck exiting is killed
            p.join(timeout=EXIT_TIMEOUT_S)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        results.close()
        shutil.rmtree(store, ignore_errors=True)
    return [got[r] for r in range(len(procs))]


def _launches() -> Dict[str, int]:
    """This process's launches of each kernel so far."""
    from stabstitch2_tpu_torch.ops import (corr_cuda, fused_warp_cuda,
                                           patch_gather_cuda, tps_coords_cuda)

    return {"cost_volume": sum(corr_cuda.LAUNCHES.values()),
            "fused_warp": sum(fused_warp_cuda.LAUNCHES.values()),
            "tps_coords": sum(tps_coords_cuda.LAUNCHES.values()),
            "patch_gather": sum(patch_gather_cuda.LAUNCHES.values())}


def _train_rank(rank: Rank, fn: Callable, kwargs: Dict) -> Dict:
    """A rank of a trainer loop (``train/loop.py``): the loop itself on
    this rank's device and rows. Every rank returns the checkpoints it
    wrote and its kernel launches; rank 0 also what the caller's
    ``TrainRun`` is made of: the weights, the optimizer state, the last
    step's gradients (averaged over the ranks and clipped, as the net
    holds them after the step) and the loss terms of every step for its
    ``on_step``."""
    steps: List = []

    def record(step, metrics):
        steps.append((step, {k: float(v) for k, v in metrics.items()}))

    run = fn(**kwargs, rank=rank, on_step=record if rank.rank == 0 else None)
    out = {"saved": list(run.checkpointer.saved), "launches": _launches()}
    if rank.rank == 0:
        out.update(
            model={k: v.detach().cpu()
                   for k, v in run.net.state_dict().items()},
            grads={k: p.grad.detach().cpu()
                   for k, p in run.net.named_parameters()
                   if p.grad is not None},
            optimizer=run.opt.state_dict(), steps=steps,
            steps_per_epoch=run.opt.steps_per_epoch,
            metrics={k: float(v) for k, v in run.metrics.items()})
    return out


def run_training(fn: Callable, kwargs: Dict, devices: Sequence[torch.device],
                 run_dir: str) -> List[Dict]:
    """A trainer loop ``fn(**kwargs)`` of ``train/loop.py`` as a
    data-parallel run over ``devices``: each rank's summary
    (:func:`_train_rank`)."""
    return run_ranks(_train_rank, devices, (fn, kwargs), run_dir=run_dir)
