"""Epoch loops of the three trainers (port of ``train/loop.py``).

Each loop builds its net with random weights from ``seed`` (the same
draws on every device), resumes from the latest ``step_<N>.pth`` in
``model_dir``, and runs ``max_epoch`` epochs of at most
``max_steps_per_epoch`` steps over a threaded batch iterator. Per step
the augmentation factors are drawn on the CPU from a generator seeded
with ``seed``, so the card and the CPU train on the same draws. Like the
reference trainers: the spatial loop scores SSIM on every 20th test
sample after each epoch and saves when it improves (the best score in a
``best_ssim.json`` sidecar, so a resumed run keeps it), or every epoch
without a test set; the temporal loop saves every 20 epochs, the smooth
loop every 10, both at the last. ``summary_dir`` imports tensorboardX
only when it is given; the writer then takes the loss terms every 100th
batch and, as the JAX package's loops do, image panels at every step
that is a multiple of 300: the first sample's warps from the net in eval
mode (spatial: ``output_H_ref``, ``output_H_tgt``, ``output_tps_ref``,
``output_tps_tgt``; temporal: ``img_t0``, ``img_t1``, ``warp_mesh``;
smooth: none). ``on_step(step, metrics)``, when given, is called after
every step (the metrics are tensors on the device, not waited on).

Each step is a host part and a device body (``train/common.py``). With
``capture_step`` (the default, the counterpart of the JAX package's
jitted steps) the loop runs the body through a ``utils/graphs.py:
GraphCache`` of its own: on a card the first step at a batch shape runs
eagerly, is then captured as one CUDA graph (forward, K1/K3 and their
backwards, clip, the device rate, Adam, BatchNorm statistics), and every
later step copies its batch and augmentation factors into the graph's
inputs and replays it; ``batch_iterator`` drops the last partial batch,
so a run captures once. ``capture_step=False`` runs the same body eagerly
(the counterpart of ``jax.disable_jit``). A capture that fails raises:
nothing falls back to the eager step. On the CPU the body always runs
directly. The panels, the test-set score and the logs stay eager, outside
the graph. The loop's first line says which step runs.

``n_devices`` > 1 runs the loop data-parallel (``parallel/train.py``): N
processes, rank r on device r (``parallel/devices.py:resolve_devices``;
N ranks on the CPU with ``device='cpu'``, or an explicit device list),
each on its rows of every batch of ``batch_size`` rows (which N must
divide), with BatchNorm over the global batch and the gradients averaged
before the clip: the step of one process on the whole batch. Every rank
draws the same batches and augmentation factors and restores the same
checkpoint; rank 0 alone writes checkpoints, ``best_ssim.json``,
summaries and panels and scores the test set, while the others wait at
a barrier after each epoch. The returned ``TrainRun`` holds rank 0's net
(with its last step's gradients, as one process's net holds them) and
optimizer on the first device, and what each rank wrote and launched;
``on_step`` is called after the ranks are done, once per step, with rank
0's loss terms (the ranks' average). A data-parallel run keeps the eager
step: its global BatchNorm all-reduces inside the forward, and the gloo
collectives that several ranks on one card use cannot be captured.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from stabstitch2_tpu_torch.config import (SmoothTrainConfig,
                                          SpatialTrainConfig,
                                          TemporalTrainConfig)
from stabstitch2_tpu_torch.data.datasets import (SmoothWindowDataset,
                                                 SpatialPairDataset,
                                                 TemporalPairDataset,
                                                 batch_iterator)
from stabstitch2_tpu_torch.models import SmoothNet, SpatialNet, TemporalNet
from stabstitch2_tpu_torch.models.backbone import (init_weights,
                                                   set_process_group)
from stabstitch2_tpu_torch.parallel.devices import resolve_devices
from stabstitch2_tpu_torch.parallel.train import Rank
from stabstitch2_tpu_torch.train.common import Optimizer, draw_aug, make_optimizer
from stabstitch2_tpu_torch.utils.checkpoint import TrainCheckpointer
from stabstitch2_tpu_torch.utils.graphs import GraphCache
from stabstitch2_tpu_torch.utils.transfer import to_device

OnStep = Optional[Callable[[int, Dict[str, torch.Tensor]], None]]
# first-sample arrays of a numpy batch -> {panel name: float HWC in [0, 1]}
Panels = Optional[Callable[..., Dict[str, np.ndarray]]]
PANEL_EVERY = 300
SPATIAL_PANELS = ("output_H_ref", "output_H_tgt", "output_tps_ref",
                  "output_tps_tgt")


@dataclasses.dataclass
class TrainRun:
    """What a loop leaves: the trained net (train mode), its optimizer
    (whose ``step_count`` is the global step) and the last step's loss
    terms; the cache its steps ran through (None for the eager step); of
    a data-parallel run also the checkpoint paths each rank wrote and each
    rank's kernel launches."""

    net: nn.Module
    opt: Optimizer
    metrics: Dict[str, torch.Tensor]
    checkpointer: TrainCheckpointer
    graphs: Optional[GraphCache] = None
    saved_by_rank: Optional[List[List[str]]] = None
    launches_by_rank: Optional[List[Dict[str, int]]] = None


def _data_parallel(fn: Callable, kwargs: Dict, devices: List[torch.device],
                   on_step: OnStep, net: nn.Module, cfg) -> TrainRun:
    """``fn(**kwargs)`` as a data-parallel run over ``devices``
    (``parallel/train.py:run_training``), its ``TrainRun`` rebuilt from
    rank 0's weights and last gradients into ``net``."""
    from stabstitch2_tpu_torch.parallel.train import run_training

    Rank(0, len(devices), devices[0]).rows(cfg.batch_size)  # before spawning
    ranks = run_training(fn, kwargs, devices, run_dir=kwargs["model_dir"])
    lead = ranks[0]
    net.load_state_dict(lead["model"], strict=True)
    net.to(devices[0]).train()
    for k, p in net.named_parameters():
        if k in lead["grads"]:
            p.grad = lead["grads"][k].to(devices[0])
    opt = make_optimizer(net.parameters(), cfg, lead["steps_per_epoch"])
    opt.load_state_dict(lead["optimizer"])
    if on_step is not None:
        for step, metrics in lead["steps"]:
            on_step(step, {k: torch.tensor(v) for k, v in metrics.items()})
    return TrainRun(net, opt,
                    {k: torch.tensor(v) for k, v in lead["metrics"].items()},
                    TrainCheckpointer(kwargs["model_dir"]),
                    saved_by_rank=[r["saved"] for r in ranks],
                    launches_by_rank=[r["launches"] for r in ranks])


def _setup(net: nn.Module, cfg, n_samples: int, model_dir: str,
           max_steps_per_epoch: Optional[int], rank: Rank, seed: int,
           what: str):
    """Device, random weights, the global BatchNorm of a data-parallel
    run, optimizer, checkpointer and the resume: returns (net, opt, ckpt,
    steps_per_epoch, start_epoch, restored)."""
    if n_samples < cfg.batch_size:
        raise ValueError(f"dataset too small: {n_samples} {what} < batch "
                         f"size {cfg.batch_size}")
    rank.rows(cfg.batch_size)       # raises unless the ranks divide it
    device = rank.device
    init_weights(net, torch.Generator().manual_seed(seed))
    net.to(device).train()
    set_process_group(net, rank.group)
    steps_per_epoch = min(n_samples // cfg.batch_size,
                          max_steps_per_epoch or 10 ** 9)
    opt = make_optimizer(net.parameters(), cfg, steps_per_epoch, rank.group)
    ckpt = TrainCheckpointer(model_dir)
    restored = ckpt.restore(map_location=device)
    start_epoch = 0
    if restored is not None:
        net.load_state_dict(restored["model"], strict=True)
        opt.load_state_dict(restored["optimizer"])
        start_epoch = opt.step_count // max(steps_per_epoch, 1)
    return net, opt, ckpt, steps_per_epoch, start_epoch, restored is not None


def _writer(summary_dir: Optional[str]):
    if not summary_dir:
        return None
    from tensorboardX import SummaryWriter

    return SummaryWriter(log_dir=summary_dir)


def _log(writer, metrics, step: int) -> None:
    if writer is not None:
        for k, v in metrics.items():
            writer.add_scalar(k, float(v), step)


def _unit(x: torch.Tensor) -> np.ndarray:
    """An image in [-1, 1] as float HWC in [0, 1] on the host."""
    return ((x + 1.0) / 2.0).clamp(0, 1).cpu().numpy()


def _images(writer, net: nn.Module, panels: Panels, batch, step: int) -> None:
    """Write ``panels(*batch)`` computed with the net in eval mode (its
    BatchNorm layers read the running statistics and do not move them),
    then put it back in train mode."""
    net.eval()
    try:
        with torch.no_grad():
            images = panels(*batch)
    finally:
        net.train()
    for key, img in images.items():
        writer.add_image(key, img, step, dataformats="HWC")


def _save(ckpt: TrainCheckpointer, net: nn.Module, opt: Optimizer,
          epoch: int) -> str:
    return ckpt.save(opt.step_count, {
        "model": net.state_dict(), "optimizer": opt.state_dict(),
        "step": opt.step_count, "epoch": epoch})


def _to(device, *arrays):
    """Host arrays on ``device``, copied without blocking the host."""
    return tuple(to_device(np.ascontiguousarray(a), device) for a in arrays)


def _step_graphs(capture_step: bool, rank: Rank
                 ) -> Tuple[Optional[GraphCache], str]:
    """The cache a loop's steps run through, and what the loop says of it
    in its first line."""
    if rank.group is not None:
        return None, (f"eager step (data-parallel over {rank.world} ranks: "
                      f"the global BatchNorm's all-reduces are not captured)")
    if not capture_step:
        return None, "eager step (capture_step=False)"
    if rank.device.type != "cuda":
        return GraphCache(), f"step run directly on {rank.device}"
    return GraphCache(), ("step captured as a CUDA graph after its first "
                          "call at a batch shape, then replayed")


def _epochs(name, dataset, cfg, net, opt, steps_per_epoch, start_epoch,
            seed, writer, on_step, step_fn, after_epoch, rank: Rank,
            mode: str, panels: Panels = None):
    """The shared epoch loop: ``step_fn(rows) -> metrics`` per step on this
    rank's rows of the batch, ``panels`` written at every PANEL_EVERY-th
    step (where there is a writer), ``after_epoch(epoch)`` after each
    epoch on rank 0, then a barrier. Rank 0 first prints ``mode``."""
    device = rank.device
    rows = rank.rows(cfg.batch_size)
    metrics: Dict[str, torch.Tensor] = {}
    if rank.rank == 0:
        print(f"[{name}] {mode}", flush=True)
    for epoch in range(start_epoch, cfg.max_epoch):
        t0 = time.perf_counter()
        it = batch_iterator(dataset, cfg.batch_size, seed=seed + epoch,
                            limit=steps_per_epoch)
        try:
            for bi, batch in enumerate(it):
                if bi >= steps_per_epoch:
                    break
                metrics = step_fn(_to(device, *(x[rows] for x in batch)))
                if bi % 100 == 0:
                    _log(writer, metrics, opt.step_count)
                if (writer is not None and panels is not None
                        and opt.step_count % PANEL_EVERY == 0):
                    _images(writer, net, panels, batch, opt.step_count)
                if on_step is not None:
                    on_step(opt.step_count, metrics)
        finally:
            it.close()
        if rank.rank == 0:
            loss = float(metrics["total"]) if metrics else float("nan")
            print(f"[{name}] epoch {epoch + 1}/{cfg.max_epoch} "
                  f"loss={loss:.4f} ({time.perf_counter() - t0:.1f}s)",
                  flush=True)
            after_epoch(epoch)
        rank.barrier()
    return metrics


def train_spatial(train_path: str, test_path: Optional[str] = None,
                  cfg: Optional[SpatialTrainConfig] = None,
                  model_dir: str = "model_spatial",
                  summary_dir: Optional[str] = None,
                  vgg_state_dict: Optional[Dict[str, torch.Tensor]] = None,
                  seed: int = 0, max_steps_per_epoch: Optional[int] = None,
                  model_h: int = 360, model_w: int = 480,
                  n_devices: Optional[int] = None, device="cuda",
                  on_step: OnStep = None, rank: Optional[Rank] = None,
                  capture_step: bool = True) -> TrainRun:
    """The spatial trainer (module docstring); ``rank`` is set on the
    ranks of a data-parallel run (``parallel/train.py``)."""
    from stabstitch2_tpu_torch.metrics.psnr_ssim import ssim
    from stabstitch2_tpu_torch.train.spatial import (frozen_vgg,
                                                     spatial_train_outputs,
                                                     spatial_train_step)

    kwargs = dict(train_path=train_path, test_path=test_path, cfg=cfg,
                  model_dir=model_dir, summary_dir=summary_dir,
                  vgg_state_dict=vgg_state_dict, seed=seed,
                  max_steps_per_epoch=max_steps_per_epoch, model_h=model_h,
                  model_w=model_w)
    cfg = cfg or SpatialTrainConfig()
    if cfg.perception_weight > 0 and vgg_state_dict is None:
        # the tra recipe needs the perceptual term; training without it
        # would make another model without a word
        raise ValueError(
            "the config has perception_weight > 0 (tra recipe) but no VGG-19 "
            "weights were given: pass a torchvision vgg19 state_dict "
            "(cli train --vgg_pth), or set perception_weight=0 (ssd)")
    if rank is None:
        devices = resolve_devices(n_devices, device)
        if len(devices) > 1:
            return _data_parallel(train_spatial, kwargs, devices, on_step,
                                  SpatialNet(model_h, model_w), cfg)
        rank = Rank(0, 1, devices[0])
    dataset = SpatialPairDataset(train_path, training=True, seed=seed,
                                 model_size=(model_h, model_w))
    net, opt, ckpt, spe, start, restored = _setup(
        SpatialNet(model_h, model_w), cfg, len(dataset), model_dir,
        max_steps_per_epoch, rank, seed, "samples")
    dev = rank.device
    vgg = (frozen_vgg(vgg_state_dict, dev) if cfg.perception_weight > 0
           else None)
    writer = _writer(summary_dir if rank.rank == 0 else None)
    aug = torch.Generator().manual_seed(seed)
    graphs, mode = _step_graphs(capture_step, rank)
    best_file = os.path.join(model_dir, "best_ssim.json")
    best = {"ssim": -1.0}
    if restored and os.path.exists(best_file):
        with open(best_file) as f:
            best["ssim"] = float(json.load(f)["best_ssim"])

    def step_fn(batch):
        img1, img2 = batch
        return spatial_train_step(net, opt, img1, img2, draw_aug(aug), cfg,
                                  vgg, graphs)

    def panels(img1, img2):
        out = spatial_train_outputs(net, *_to(dev, img1[:1], img2[:1]))
        return {k: _unit(out[k][0, ..., :3]) for k in SPATIAL_PANELS}

    @torch.no_grad()
    def score() -> float:
        test = SpatialPairDataset(test_path, training=False,
                                  model_size=(model_h, model_w))
        net.eval()
        scores = []
        for i in range(0, len(test), 20):
            a, b = _to(dev, *test[i])
            out = spatial_train_outputs(net, a[None], b[None])
            ov = (out["output_tps_ref"][0, ..., 3]
                  * out["output_tps_tgt"][0, ..., 3])[..., None]
            ref = (out["output_tps_ref"][0, ..., :3] + 1) * 127.5
            tgt = (out["output_tps_tgt"][0, ..., :3] + 1) * 127.5
            scores.append(float(ssim(ref * ov, tgt * ov)))
        net.train()
        return float(np.mean(scores)) if scores else -1.0

    def after_epoch(epoch):
        if not test_path:
            _save(ckpt, net, opt, epoch + 1)
            return
        cur = score()
        if writer is not None:
            writer.add_scalar("SSIM", cur, epoch + 1)
        if cur > best["ssim"]:
            best["ssim"] = cur
            _save(ckpt, net, opt, epoch + 1)
            with open(best_file, "w") as f:
                json.dump({"best_ssim": cur, "step": opt.step_count}, f)

    metrics = _epochs("spatial", dataset, cfg, net, opt, spe, start, seed,
                      writer, on_step, step_fn, after_epoch, rank, mode,
                      panels)
    return TrainRun(net, opt, metrics, ckpt, graphs)


def train_temporal(train_path: str, cfg: Optional[TemporalTrainConfig] = None,
                   model_dir: str = "model_temporal",
                   summary_dir: Optional[str] = None, seed: int = 0,
                   max_steps_per_epoch: Optional[int] = None,
                   model_h: int = 360, model_w: int = 480,
                   n_devices: Optional[int] = None, device="cuda",
                   on_step: OnStep = None, rank: Optional[Rank] = None,
                   capture_step: bool = True) -> TrainRun:
    """The temporal trainer (module docstring); ``rank`` is set on the
    ranks of a data-parallel run (``parallel/train.py``)."""
    from stabstitch2_tpu_torch.train.temporal import (temporal_train_outputs,
                                                      temporal_train_step)

    kwargs = dict(train_path=train_path, cfg=cfg, model_dir=model_dir,
                  summary_dir=summary_dir, seed=seed,
                  max_steps_per_epoch=max_steps_per_epoch, model_h=model_h,
                  model_w=model_w)
    cfg = cfg or TemporalTrainConfig()
    if rank is None:
        devices = resolve_devices(n_devices, device)
        if len(devices) > 1:
            return _data_parallel(train_temporal, kwargs, devices, on_step,
                                  TemporalNet(model_h, model_w), cfg)
        rank = Rank(0, 1, devices[0])
    dataset = TemporalPairDataset(train_path, cfg.train_frame_num, seed=seed,
                                  model_size=(model_h, model_w))
    net, opt, ckpt, spe, start, _ = _setup(
        TemporalNet(model_h, model_w), cfg, len(dataset), model_dir,
        max_steps_per_epoch, rank, seed, "samples")
    writer = _writer(summary_dir if rank.rank == 0 else None)
    aug = torch.Generator().manual_seed(seed)
    graphs, mode = _step_graphs(capture_step, rank)

    def step_fn(batch):
        prev, nxt = batch
        return temporal_train_step(net, opt, prev, nxt, draw_aug(aug), cfg,
                                   graphs)

    def panels(prev, nxt):
        dev = next(net.parameters()).device
        out = temporal_train_outputs(net, *_to(dev, prev[:1], nxt[:1]))
        return {"img_t0": np.clip(prev[0].astype(np.float32) / 255.0, 0, 1),
                "img_t1": np.clip(nxt[0].astype(np.float32) / 255.0, 0, 1),
                "warp_mesh": _unit(out["output_mesh"][0, ..., :3])}

    def after_epoch(epoch):
        if (epoch + 1) % 20 == 0 or epoch + 1 == cfg.max_epoch:
            _save(ckpt, net, opt, epoch + 1)

    metrics = _epochs("temporal", dataset, cfg, net, opt, spe, start, seed,
                      writer, on_step, step_fn, after_epoch, rank, mode,
                      panels)
    return TrainRun(net, opt, metrics, ckpt, graphs)


def train_smooth(train_path: str, cfg: Optional[SmoothTrainConfig] = None,
                 model_dir: str = "model_smooth",
                 summary_dir: Optional[str] = None, seed: int = 0,
                 max_steps_per_epoch: Optional[int] = None,
                 model_h: int = 360, model_w: int = 480,
                 n_devices: Optional[int] = None, device="cuda",
                 on_step: OnStep = None, rank: Optional[Rank] = None,
                 capture_step: bool = True) -> TrainRun:
    """The smooth trainer (module docstring); ``rank`` is set on the ranks
    of a data-parallel run (``parallel/train.py``)."""
    from stabstitch2_tpu_torch.train.smooth import smooth_train_step

    kwargs = dict(train_path=train_path, cfg=cfg, model_dir=model_dir,
                  summary_dir=summary_dir, seed=seed,
                  max_steps_per_epoch=max_steps_per_epoch, model_h=model_h,
                  model_w=model_w)
    cfg = cfg or SmoothTrainConfig()
    if rank is None:
        devices = resolve_devices(n_devices, device)
        if len(devices) > 1:
            return _data_parallel(train_smooth, kwargs, devices, on_step,
                                  SmoothNet(), cfg)
        rank = Rank(0, 1, devices[0])
    dataset = SmoothWindowDataset(
        train_path, selected_frames=cfg.frame_num + cfg.train_sqe - 1,
        train_frame_num=cfg.train_frame_num, seed=seed,
        model_size=(model_h, model_w))
    net, opt, ckpt, spe, start, _ = _setup(
        SmoothNet(), cfg, len(dataset), model_dir, max_steps_per_epoch,
        rank, seed, "windows (did export-motions run?)")
    writer = _writer(summary_dir if rank.rank == 0 else None)
    graphs, mode = _step_graphs(capture_step, rank)

    def step_fn(batch):
        return smooth_train_step(net, opt, batch, cfg, graphs)

    def after_epoch(epoch):
        if (epoch + 1) % 10 == 0 or epoch + 1 == cfg.max_epoch:
            _save(ckpt, net, opt, epoch + 1)

    metrics = _epochs("smooth", dataset, cfg, net, opt, spe, start, seed,
                      writer, on_step, step_fn, after_epoch, rank, mode)
    return TrainRun(net, opt, metrics, ckpt, graphs)
