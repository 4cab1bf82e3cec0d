"""Spatial training, closed loop: the trainer's own step
(``train/spatial.py:spatial_train_step`` through ``train/common.py:
run_step`` and a ``utils/graphs.py:GraphCache``: the first step eager,
then captured, then replayed) fed by its own input pipeline
(``data/datasets.py:batch_iterator`` over a ``SpatialPairDataset``), as
``cli train --stage spatial`` runs it (TF32 off, the configuration's
preset), with no checkpoint, log or panel.

Traffic (the mix): a training tree of ``videos`` two-view clips of
``frames`` frames each, written as JPEG under ``TMPDIR`` in set-up
(``traffic/clips.py:write_pairs``); epochs over it in the loader's
order, each from ``seed + epoch`` as the trainer's loop draws them; the
augmentation factors of each step drawn by the benchmark from the seed
(uniform in [0.7, 1.3]) and handed to the step. Set-up runs the first
``checked_steps`` steps and ``warm_steps`` more, so the graph is
captured before the window.

End to end: ``train_step_ms``, the window's seconds, ended by a
synchronize, over the steps it made. The profiled slice
(``--trace 1``) is ``slice_steps`` more steps after the window.

``correct``: the plain reference (``reference/train.py``) follows the
first ``checked_steps`` steps from the same weights, the same JPEG files
(it decodes them itself: each row the loader fed is matched to its file)
and the same factors. Compared: the first step's loss (``loss_gap``, the
gap over the reference's loss; every step's pair is printed, but a later
step's loss follows parameters that Adam's first updates, about the rate
times the sign of each gradient, have moved apart wherever a gradient is
near zero, and on some seeds reads 25 times the first's); the first
gradient as Adam took it, read from Adam's first moment after step 1
(``grad_gap``); and each parameter's change over the checked steps, read
before step ``checked_steps + 1`` (``change_gap``). The last two by the worst
parameter: the gap between the program's norm and the reference's, over
the reference's norm of that parameter or of the median parameter,
whichever is larger; the change leaves out parameters whose reference
gradient is under a thousandth of the median's (round-off alone moves
them under Adam). A fed row that matches no file of the tree is a
failed answer.
"""

from __future__ import annotations

import atexit
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from benchmark.lib.sampling import stream_seed
from benchmark.lib.trace import Slice
from benchmark.lib.weights import for_run
from benchmark.reference import train as RT
from benchmark.traffic import clips

# what control.py puts in the program's place
CONTROL = "the reference with TF32 on in its matrix products and convolutions"
# a fed row is its file's where their 12x16 means differ by at most this
MATCH_LEVELS = 3.0
# parameters whose reference gradient is under this share of the median
# parameter's move by round-off alone under Adam
ROUNDOFF_GRAD = 1e-3


def draw_factors(gen: torch.Generator):
    """One step's augmentation: a brightness and a colour factor per view,
    uniform in [0.7, 1.3] (the recipe's draw), on the host."""
    u = 0.7 + 0.6 * torch.rand(8, generator=gen)
    return u[0], u[1], u[2:5].clone(), u[5:8].clone()


def write_tree(cfg: dict, mix: dict, seed: int) -> str:
    """The mix's training tree in a new directory under TMPDIR, removed at
    the process's exit."""
    root = tempfile.mkdtemp(prefix="bench_train_")
    atexit.register(shutil.rmtree, root, True)
    nbytes = clips.write_pairs(root, mix["videos"], mix["frames"],
                               cfg["frame_h"], cfg["frame_w"], mix["overlap"],
                               mix["shake_px"], stream_seed(seed, 0),
                               mix["jpeg_quality"])
    print(f"training tree: {nbytes} bytes of JPEG under TMPDIR",
          file=sys.stderr)
    return root


class Driver:
    def __init__(self, run):
        self.run = run
        self.cfg, self.mix = run.cfg, run.mix

    def setup(self):
        from stabstitch2_tpu_torch import cli
        from stabstitch2_tpu_torch import config as C
        from stabstitch2_tpu_torch.data.datasets import SpatialPairDataset
        from stabstitch2_tpu_torch.models import SpatialNet
        from stabstitch2_tpu_torch.train.common import make_optimizer
        from stabstitch2_tpu_torch.utils.graphs import GraphCache

        run, cfg, mix = self.run, self.cfg, self.mix
        recipe = mix["recipe"]
        cli.no_tf32()
        self.tcfg = C.spatial_train_preset(cfg["preset"])
        stated = {"batch": self.tcfg.batch_size, "lr": self.tcfg.learning_rate,
                  "b1": self.tcfg.b1, "b2": self.tcfg.b2, "eps": self.tcfg.eps,
                  "clip": self.tcfg.grad_clip_norm,
                  "grid_weight": self.tcfg.grid_weight,
                  "perception_weight": self.tcfg.perception_weight}
        if any(stated[k] != recipe[k] for k in stated):
            raise RuntimeError(f"the program's {cfg['preset']} spatial recipe "
                               f"{stated} is not the mix's {recipe}")
        self.weights = for_run(run)
        self.root = write_tree(cfg, mix, run.seed)
        mh, mw = cfg["model_h"], cfg["model_w"]
        self.net = SpatialNet(mh, mw)
        if self.net.feature_extractor_stage1.compute_dtype != getattr(
                torch, recipe["dtype"]):
            raise RuntimeError("the program's training net is not "
                               f"{recipe['dtype']}")
        self.net.load_state_dict(self.weights["spatial"], strict=True)
        self.net.to(run.device).train()
        self.loader_seed = stream_seed(run.seed, 1) % 2 ** 31
        self.dataset = SpatialPairDataset(self.root, training=True,
                                          seed=self.loader_seed,
                                          model_size=(mh, mw))
        self.steps_per_epoch = len(self.dataset) // recipe["batch"]
        self.opt = make_optimizer(self.net.parameters(), self.tcfg,
                                  self.steps_per_epoch)
        self.graphs = GraphCache()
        self.gen = torch.Generator().manual_seed(stream_seed(run.seed, 2))
        self.epoch, self.it = 0, None

        names = [n for n, _ in self.net.named_parameters()]
        params = [p for _, p in self.net.named_parameters()]
        self.fed, losses = [], []
        for k in range(mix["checked_steps"]):
            img1, img2, factors, out = self.step()
            self.fed.append((img1, img2, factors))
            losses.append(out["total"])
            if k == 0:
                grad = {n: self.first_moment(p) / (1.0 - self.tcfg.b1)
                        for n, p in zip(names, params)}
        start = self.weights["spatial"]
        self.program = {
            "losses": [float(x) for x in losses], "grad_norm": grad,
            "change_norm": {n: float((p.detach() - start[n]).norm())
                            for n, p in zip(names, params)}}
        for _ in range(mix["warm_steps"]):
            self.step()

    def first_moment(self, p) -> float:
        """The norm of Adam's first moment of ``p`` (0 where Adam keeps
        none: it has not stepped)."""
        m = self.opt.adam.state.get(p, {}).get("exp_avg")
        return 0.0 if m is None else float(m.norm())

    def batch(self):
        """The trainer's next batch: epoch after epoch of the loader, each
        from ``seed + epoch`` (``train/loop.py``)."""
        from stabstitch2_tpu_torch.data.datasets import batch_iterator

        while True:
            if self.it is None:
                self.it = batch_iterator(self.dataset, self.mix["recipe"][
                    "batch"], seed=self.loader_seed + self.epoch,
                    limit=self.steps_per_epoch)
            b = next(self.it, None)
            if b is not None:
                return b
            self.it.close()
            self.it, self.epoch = None, self.epoch + 1

    def step(self):
        """One step as the trainer's loop makes it: the batch copied to the
        card without blocking the host, the step run (no wait)."""
        from stabstitch2_tpu_torch.train.spatial import spatial_train_step
        from stabstitch2_tpu_torch.utils.transfer import to_device

        img1, img2 = self.batch()
        factors = draw_factors(self.gen)
        d1, d2 = (to_device(np.ascontiguousarray(x), self.run.device)
                  for x in (img1, img2))
        out = spatial_train_step(self.net, self.opt, d1, d2, factors,
                                 self.tcfg, None, self.graphs)
        return img1, img2, factors, out

    def window(self, seconds):
        steps, failed = 0, 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            try:
                self.step()
            except Exception as e:  # noqa: BLE001 - counted and reported
                print(f"step {steps} failed: {type(e).__name__}: {e}",
                      file=sys.stderr)
                failed += 1
            steps += 1
        if torch.device(self.run.device).type == "cuda":
            torch.cuda.synchronize(self.run.device)
        window_s = time.perf_counter() - t0
        run = self.run
        run.attempted, run.failed = steps, failed
        run.end_to_end["train_step_ms"] = 1e3 * window_s / steps
        run.layer.update(window_s=window_s, steps=steps)

    def traced_slice(self):
        with Slice() as s:
            for _ in range(self.mix["slice_steps"]):
                self.step()
        if s.summary is not None:
            s.summary.units = self.mix["slice_steps"]
        return s.summary

    def release(self):
        if self.it is not None:
            self.it.close()
        del self.net, self.opt, self.graphs, self.it

    def check(self):
        return check(self.run, self.root, dict(self.program, fed=self.fed),
                     self.weights)


def _fingerprint(img: np.ndarray) -> np.ndarray:
    import cv2

    return cv2.resize(img, (16, 12), interpolation=cv2.INTER_AREA).astype(
        np.float32)


def match_rows(root: str, fed):
    """Each fed row's file: the reference decodes every JPEG of the tree
    with cv2 and matches by 12x16 means. Returns per step (img1, img2)
    as the reference decoded them, [B, H, W, 3] uint8, and the rows that
    matched no file."""
    import cv2

    paths = sorted(os.path.join(d, f) for d, _, fs in os.walk(root)
                   for f in fs if f.endswith(".jpg"))
    images = [cv2.imread(p) for p in paths]
    prints = np.stack([_fingerprint(x) for x in images])
    out, unmatched = [], 0
    for rows in fed:
        pair = []
        for batch in rows[:2]:
            picked = []
            for row in batch:
                d = np.abs(prints - _fingerprint(row)).mean(axis=(1, 2, 3))
                j = int(np.argmin(d))
                unmatched += int(d[j] > MATCH_LEVELS)
                picked.append(images[j])
            pair.append(np.stack(picked))
        out.append(tuple(pair))
    return out, unmatched


def worst_leaf(prog: dict, ref: dict, keep=None) -> float:
    """The largest gap between the program's and the reference's norm of
    a parameter, over the reference's norm of that parameter or of the
    median parameter, whichever is larger."""
    names = [n for n in ref if keep is None or n in keep]
    med = float(np.median([ref[n] for n in names]))
    return max(abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
               for n in names)


def check(run, root, kept, weights) -> dict:
    """``loss_gap``, ``grad_gap`` and ``change_gap`` of the checked steps
    (module docstring); every step's losses go to standard error."""
    cfg, dev = run.cfg, run.device
    rows, unmatched = match_rows(root, kept["fed"])
    run.failed += unmatched
    batches = [(torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev),
                tuple(f.to(dev) for f in factors))
               for (a, b), (_, _, factors) in zip(rows, kept["fed"])]
    ref = RT.train_steps(cfg, run.mix["recipe"], weights["spatial"], batches,
                         dev)
    med = float(np.median(list(ref["grad_norm"].values())))
    moved = {n for n, g in ref["grad_norm"].items()
             if g >= ROUNDOFF_GRAD * med}
    run.layer["left_out"] = sorted(set(ref["grad_norm"]) - moved)
    print(f"parameters left out of change_gap: {run.layer['left_out']}",
          file=sys.stderr)
    print("loss by step (program, reference):",
          list(zip(kept["losses"], ref["losses"])), file=sys.stderr)
    return {"loss_gap": abs(kept["losses"][0] - ref["losses"][0])
            / abs(ref["losses"][0]),
            "grad_gap": worst_leaf(kept["grad_norm"], ref["grad_norm"]),
            "change_gap": worst_leaf(kept["change_norm"], ref["change_norm"],
                                     moved)}


def control(run, weights):
    """The control: the reference in the program's place with TF32 on,
    on the first batches of the mix's tree in a seed-drawn order. Returns
    (the tree, its outputs as :func:`check` reads the program's)."""
    import cv2

    cfg, mix = run.cfg, run.mix
    root = write_tree(cfg, mix, run.seed)
    paths = sorted(os.path.join(d, f) for d, _, fs in os.walk(root)
                   for f in fs if f.endswith(".jpg"))
    pairs = [(p, p.replace(os.sep + "video1" + os.sep,
                           os.sep + "video2" + os.sep))
             for p in paths if os.sep + "video1" + os.sep in p]
    rng = np.random.default_rng([run.seed, 3])
    order = rng.permutation(len(pairs))
    gen = torch.Generator().manual_seed(stream_seed(run.seed, 2))
    B = mix["recipe"]["batch"]
    fed = []
    for k in range(mix["checked_steps"]):
        idx = order[k * B:(k + 1) * B]
        a = np.stack([cv2.imread(pairs[i][0]) for i in idx])
        b = np.stack([cv2.imread(pairs[i][1]) for i in idx])
        fed.append((a, b, draw_factors(gen)))
    dev = run.device
    batches = [(torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev),
                tuple(f.to(dev) for f in factors)) for a, b, factors in fed]
    out = RT.train_steps(cfg, mix["recipe"], weights["spatial"], batches,
                         dev, tf32=True)
    return root, dict(out, fed=fed)
