"""What the three trainers share (port of ``train/common.py``): the
optimizer recipe, image normalization, the augmentation, and how a step
is split into a host part and a device body.

The optimizer is optax's chain of the JAX package, step for step:
``clip_by_global_norm(3.0)`` (scale by ``max_norm / norm`` only where
``norm >= max_norm``, with no epsilon, where
``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6``), then Adam,
then the learning rate ``lr * 0.97 ** (step // steps_per_epoch)``. As
optax's ``scale_by_learning_rate(schedule)`` evaluates the schedule inside
the jitted step from the count in its state, the rate is computed on the
device from a step counter held there (:meth:`Optimizer.rate`) and handed
to Adam as a tensor: a step captured as a CUDA graph then follows the
staircase on every replay. The counter is saved and restored with the
optimizer's state, so a resumed run continues the staircase. On the card
Adam is ``capturable`` in the eager step too, so that both run the same
arithmetic; PyTorch takes ``capturable`` only for parameters on a card,
so on the CPU it is off.

A step (``train/{spatial,temporal,smooth}.py``) is a host part, which
uploads the batch, draws the augmentation factors on the host generator,
copies them to the device and advances :attr:`Optimizer.step_count`, and
a device body, a function of tensors only that does the rest on the card
(normalization, augmentation, forward with BatchNorm in train mode,
backward, clip, the rate, Adam) and returns the detached loss terms. The
body waits for nothing and copies nothing from the host, and moves no
Python state, so :func:`run_step` can run it through a
``utils/graphs.py:GraphCache``: the trainers' loops capture it on the card.

In a data-parallel run (``parallel/train.py``) the optimizer carries the
process group: each step first averages the gradients over the ranks, in
one all-reduce of them all, so the clip sees the global batch's norm and
every rank takes the same update; the loss terms the steps return are
averaged likewise. Every loss term is a mean over equal shards of the
batch (the brightness-balanced term a mean of per-sample ratios), so the
ranks' average is the global batch's.

The augmentation is split in two so that a test can feed the JAX
package's draws to the port: :func:`draw_aug` draws the factors from a
``torch.Generator``, :func:`apply_aug` applies them.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

import torch

from stabstitch2_tpu_torch.config import TrainConfig
from stabstitch2_tpu_torch.ops.tps import batched_lu_on_cublas
from stabstitch2_tpu_torch.utils.transfer import to_device

# (brightness 1, brightness 2, colour 1 [3], colour 2 [3])
AugFactors = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


class Optimizer:
    """Global-norm clipping, Adam and the staircase learning rate.

    ``step_count`` is the host's count of steps (the logs, checkpoints and
    panels read it); ``count`` is the same count on the device, which
    :meth:`update` reads and advances. ``loads`` counts
    :meth:`load_state_dict` calls: a load replaces Adam's state tensors,
    so a captured step keyed on it is captured anew.
    """

    def __init__(self, params: Iterable[torch.nn.Parameter], cfg: TrainConfig,
                 steps_per_epoch: int, group=None):
        self.params = [p for p in params if p.requires_grad]
        self.cfg = cfg
        self.group = group      # a data-parallel run's process group
        self.steps_per_epoch = max(int(steps_per_epoch), 1)
        device = (self.params[0].device if self.params
                  else torch.device("cpu"))
        self.capturable = device.type == "cuda"
        self.count = torch.zeros((), dtype=torch.int64, device=device)
        # Adam reads the rate from this tensor, which update() fills
        self._rate = torch.full((), cfg.learning_rate, dtype=torch.float32,
                                device=device)
        self.adam = torch.optim.Adam(self.params, lr=self._rate,
                                     betas=(cfg.b1, cfg.b2), eps=cfg.eps,
                                     capturable=self.capturable)
        # capturable in the eager step too, on purpose (module docstring)
        self.adam._warned_capturable_if_run_uncaptured = True
        self.step_count = 0
        self.loads = 0

    def lr(self, step: int) -> float:
        """The learning rate of update number ``step`` (from 0)."""
        epoch = step // self.steps_per_epoch
        return self.cfg.learning_rate * self.cfg.lr_decay_per_epoch ** epoch

    def rate(self) -> torch.Tensor:
        """The rate of the next update, on the device, from ``count``: in
        float64 as :meth:`lr` computes it, rounded to float32 (optax's
        ``exponential_decay(staircase=True)`` in the JAX step)."""
        epoch = torch.div(self.count, self.steps_per_epoch,
                          rounding_mode="floor")
        decay = torch.pow(self.cfg.lr_decay_per_epoch,
                          epoch.to(torch.float64))
        return (self.cfg.learning_rate * decay).to(torch.float32)

    @torch.no_grad()
    def clip(self) -> torch.Tensor:
        """Scale the gradients as ``optax.clip_by_global_norm``; returns the
        global norm, on the device (no wait for it)."""
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        keep = norm < self.cfg.grad_clip_norm
        for g in grads:
            g.copy_(torch.where(keep, g,
                                (g / norm) * self.cfg.grad_clip_norm))
        return norm

    def zero_grad(self) -> None:
        """Zero the gradients in place. Once the first step has made them,
        each parameter keeps its gradient tensor, which backward then
        accumulates into: a captured step reads and writes those tensors,
        so after a capture they still hold the eager step's gradients, and
        every replay overwrites them."""
        self.adam.zero_grad(set_to_none=False)

    @torch.no_grad()
    def average_grads(self) -> None:
        """Average the gradients over the process group's ranks, in one
        all-reduce (nothing without a group)."""
        if self.group is None:
            return
        import torch.distributed as dist

        grads = [p.grad for p in self.params if p.grad is not None]
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=self.group)
        flat /= dist.get_world_size(self.group)
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))

    @torch.no_grad()
    def mean(self, metrics: Dict[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
        """Detached loss terms, averaged over the process group's ranks
        (as they are without a group)."""
        out = {k: v.detach() for k, v in metrics.items()}
        if self.group is None:
            return out
        import torch.distributed as dist

        flat = torch.stack(list(out.values()))
        dist.all_reduce(flat, group=self.group)
        flat /= dist.get_world_size(self.group)
        return dict(zip(out, flat.unbind()))

    def update(self) -> torch.Tensor:
        """The device part of a step: average the gradients over the ranks
        (:meth:`average_grads`), clip, set the rate from the device count
        and advance it, then one Adam update. Waits for nothing; returns
        the gradients' global norm before clipping."""
        self.average_grads()
        norm = self.clip()
        with torch.no_grad():
            self._rate.copy_(self.rate())
            self.count += 1
        self.adam.step()
        return norm

    def step(self) -> torch.Tensor:
        """:meth:`update`, then count the step on the host."""
        norm = self.update()
        self.step_count += 1
        return norm

    def state_dict(self) -> Dict:
        return {"adam": self.adam.state_dict(), "step": self.step_count,
                "count": self.count.detach().clone()}

    def load_state_dict(self, state: Dict) -> None:
        """Restore Adam's state and both counts (a checkpoint without a
        device count takes the host's). Adam keeps this optimizer's rate
        tensor and ``capturable``, whatever the saving one had: its state
        steps then land on the parameters' device."""
        adam = dict(state["adam"])
        adam["param_groups"] = [dict(g, capturable=self.capturable)
                                for g in adam["param_groups"]]
        self.adam.load_state_dict(adam)
        for group in self.adam.param_groups:
            group["lr"] = self._rate
        self.step_count = int(state["step"])
        self.count.copy_(torch.as_tensor(state.get("count",
                                                   self.step_count)))
        self.loads += 1


def make_optimizer(params: Iterable[torch.nn.Parameter], cfg: TrainConfig,
                   steps_per_epoch: int, group=None) -> Optimizer:
    """clip(3) -> Adam with the staircase decay per epoch; gradients
    averaged over ``group``'s ranks first, where one is given."""
    return Optimizer(params, cfg, steps_per_epoch, group)


def normalize_images(img: torch.Tensor) -> torch.Tensor:
    """uint8 0..255 -> float32 [-1, 1] (float inputs pass unchanged)."""
    if img.dtype == torch.uint8:
        return img.to(torch.float32) / 127.5 - 1.0
    return img


def draw_aug(generator: torch.Generator) -> AugFactors:
    """One brightness scalar and one colour 3-vector per image tensor,
    uniform in [0.7, 1.3], shared across the batch (the reference's
    ``data_aug``), drawn on the generator's device."""
    kw = dict(generator=generator, device=generator.device)

    def u(*shape):
        return 0.7 + 0.6 * torch.rand(*shape, **kw)

    return u(()), u(()), u(3), u(3)


def device_factors(factors: Optional[AugFactors], device
                   ) -> Tuple[torch.Tensor, ...]:
    """The host-drawn factors as device tensors, copied without blocking
    the host (a step body's inputs); () without factors."""
    if factors is None:
        return ()
    return tuple(to_device(f, device) for f in factors)


def step_body(opt: Optimizer, loss: Callable) -> Callable:
    """The device body of a step (module docstring) around ``loss(*inputs)
    -> (total, terms)``: zero the gradients, the loss and its backward,
    :meth:`Optimizer.update`; returns the terms, detached (averaged over
    the ranks of a data-parallel run)."""

    def body(*inputs):
        opt.zero_grad()
        total, metrics = loss(*inputs)
        total.backward()
        opt.update()
        return opt.mean(metrics)

    return body


def run_step(graphs, name: str, body: Callable, inputs: Sequence[torch.Tensor],
             modules: Sequence, opt: Optimizer) -> Dict[str, torch.Tensor]:
    """``body(*inputs)``, then the step counted on the host. With a
    ``utils/graphs.py:GraphCache`` the body runs through it: on the card
    eagerly at the first call at a shape, then captured, and replayed at
    every later call; keyed also on the modules and the optimizer the body
    reads, and on the optimizer's ``loads``. Either way on the card under
    :func:`batched_lu_on_cublas`."""
    with batched_lu_on_cublas(inputs[0].device):
        if graphs is None:
            out = body(*inputs)
        else:
            out = graphs.run(f"{name}@{opt.loads}", body, *inputs,
                             modules=[m for m in (*modules, opt)
                                      if m is not None])
    opt.step_count += 1
    return out


def apply_aug(img1: torch.Tensor, img2: torch.Tensor, factors: AugFactors
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scale each image tensor by its brightness and colour factors and
    clamp to [-1, 1]."""
    b1, b2, c1, c2 = (f.to(img1.device) for f in factors)
    return (torch.clamp(img1 * b1 * c1, -1.0, 1.0),
            torch.clamp(img2 * b2 * c2, -1.0, 1.0))
