"""What the three trainers share (port of ``train/common.py``): the
optimizer recipe, image normalization and the augmentation.

The optimizer is optax's chain of the JAX package, step for step:
``clip_by_global_norm(3.0)`` (scale by ``max_norm / norm`` only where
``norm >= max_norm``, with no epsilon, where
``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6``), then Adam,
then the learning rate ``lr * 0.97 ** (step // steps_per_epoch)``, set
from the step count before every update so that a resumed run continues
the staircase.

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

from typing import Dict, Iterable, Tuple

import torch

from stabstitch2_tpu_torch.config import TrainConfig

# (brightness 1, brightness 2, colour 1 [3], colour 2 [3])
AugFactors = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


class Optimizer:
    """Global-norm clipping, Adam and the staircase learning rate."""

    def __init__(self, params: Iterable[torch.nn.Parameter], cfg: TrainConfig,
                 steps_per_epoch: int, group=None):
        self.params = [p for p in params if p.requires_grad]
        self.cfg = cfg
        self.group = group      # a data-parallel run's process group
        self.steps_per_epoch = max(int(steps_per_epoch), 1)
        self.adam = torch.optim.Adam(self.params, lr=cfg.learning_rate,
                                     betas=(cfg.b1, cfg.b2), eps=cfg.eps)
        self.step_count = 0

    def lr(self, step: int) -> float:
        """The learning rate of update number ``step`` (from 0)."""
        epoch = step // self.steps_per_epoch
        return self.cfg.learning_rate * self.cfg.lr_decay_per_epoch ** epoch

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
        self.adam.zero_grad(set_to_none=True)

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

    def step(self) -> torch.Tensor:
        """Average the gradients over the ranks (:meth:`average_grads`),
        clip, then one Adam update at this step's rate. Returns the
        gradients' global norm before clipping."""
        self.average_grads()
        norm = self.clip()
        for group in self.adam.param_groups:
            group["lr"] = self.lr(self.step_count)
        self.adam.step()
        self.step_count += 1
        return norm

    def state_dict(self) -> Dict:
        return {"adam": self.adam.state_dict(), "step": self.step_count}

    def load_state_dict(self, state: Dict) -> None:
        self.adam.load_state_dict(state["adam"])
        self.step_count = int(state["step"])


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


def apply_aug(img1: torch.Tensor, img2: torch.Tensor, factors: AugFactors
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scale each image tensor by its brightness and colour factors and
    clamp to [-1, 1]."""
    b1, b2, c1, c2 = (f.to(img1.device) for f in factors)
    return (torch.clamp(img1 * b1 * c1, -1.0, 1.0),
            torch.clamp(img2 * b2 * c2, -1.0, 1.0))
