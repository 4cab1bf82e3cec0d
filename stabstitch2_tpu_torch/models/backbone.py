"""ResNet-18 trunk and regression heads (port of ``models/backbone.py``).

Parameter names follow the reference checkpoints (the keys that
``stabstitch2_tpu/utils/torch_import.py`` maps from): the trunk is the
reference's ``feature_extractor_stage1`` Sequential (conv1, bn1, relu,
maxpool, layer1, layer2 at indices 0..5), heads are Sequentials of
conv, relu, conv, relu, pool per stage and of Linear, ReLU, ... layers.

Every module takes and returns NHWC tensors; NCHW exists only inside,
around the convolutions.

Compute dtype, as the Flax modules' ``dtype`` field: parameters and
BatchNorm statistics stay float32. :class:`ResNetStage1`,
:class:`ConvHead` and :class:`MLPHead` cast their input to their
``compute_dtype`` (float32 by default), and every convolution and linear
layer computes in the dtype of its input, casting its float32 parameters
per call. The casts are explicit, not ``torch.autocast``, so the CPU and
the card cast at the same points, the JAX package's. BatchNorm takes the
bfloat16 activations with its float32 statistics and affine parameters,
normalizes in float32 and rounds the result to bfloat16: what Flax's
``BatchNorm(dtype=bfloat16)`` does (it promotes to float32 and casts
back), and what PyTorch's batch_norm does on both devices for a
bfloat16 input with float32 parameters.

BatchNorm in train mode follows Flax's ``BatchNorm(momentum=0.9,
epsilon=1e-5)`` (:class:`BatchNorm2d`): it normalizes with the batch's
biased statistics and keeps the running mean and the running *biased*
variance (``nn.BatchNorm2d`` keeps the unbiased one). Eval mode and the
state_dict keys are ``nn.BatchNorm2d``'s.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


def nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def nchw_to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in its input's dtype."""

    def forward(self, x):
        return self._conv_forward(x, self.weight.to(x.dtype),
                                  _cast(self.bias, x.dtype))


class Conv3d(nn.Conv3d):
    """``nn.Conv3d`` computing in its input's dtype."""

    def forward(self, x):
        return self._conv_forward(x, self.weight.to(x.dtype),
                                  _cast(self.bias, x.dtype))


class Linear(nn.Linear):
    """``nn.Linear`` computing in its input's dtype."""

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype))


# Flax's BatchNorm momentum: running = m * running + (1 - m) * batch
FLAX_BN_MOMENTUM = 0.9


class AllReduceSum(torch.autograd.Function):
    """The sum of a tensor over a process group, with the sum's gradient:
    the backward all-reduces the incoming gradients, since every rank's
    loss reads the sum of every rank's input."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (eps 1e-5) with Flax's train-mode statistics.

    Train mode normalizes with the batch mean and biased variance, through
    which gradients flow, and updates the running statistics as Flax does:
    the mean and the variance ``E[x^2] - E[x]^2`` (clipped at 0), each
    blended with momentum 0.9. Eval mode is ``nn.BatchNorm2d``'s.

    With a ``process_group`` (set by ``parallel/train.py`` on the ranks of
    a data-parallel run) the batch is the global one, as in the JAX
    package's one program over its mesh: the per-channel sums of x and the
    count are all-reduced, then the sums of the squares about the global
    mean (two passes, as ``F.batch_norm`` computes the variance: a float32
    ``E[x^2] - E[x]^2`` moves the spatial trunk's gradient by ~2e-2 at
    128x160); gradients flow through both all-reduces. The batch is
    normalized with the global mean and biased variance, and every rank
    moves its running statistics alike. ``nn.SyncBatchNorm`` would keep
    the unbiased variance instead.
    """

    process_group = None

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        if self.process_group is not None:
            return self._global_forward(x)
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                         self.eps)
        with torch.no_grad():
            xf = x.float()
            mean = xf.mean(dim=(0, 2, 3))
            var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean,
                              min=0.0)
            self._update_running(mean, var)
        return y

    def _global_forward(self, x):
        xf = x.float()
        C, dims = x.shape[1], (0, 2, 3)
        count = xf.new_full((1,), float(x.numel() // C))
        s1 = AllReduceSum.apply(torch.cat([xf.sum(dim=dims), count]),
                                self.process_group)
        mean = s1[:C] / s1[C]
        centered = xf - mean[:, None, None]
        var = AllReduceSum.apply((centered * centered).sum(dim=dims),
                                 self.process_group) / s1[C]
        scale = torch.rsqrt(var + self.eps) * self.weight
        y = centered * scale[:, None, None] + self.bias[:, None, None]
        with torch.no_grad():
            self._update_running(mean, var)
        return y.to(x.dtype)

    @torch.no_grad()
    def _update_running(self, mean, var):
        m = FLAX_BN_MOMENTUM
        self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
        self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        self.num_batches_tracked.add_(1)


def set_process_group(net: nn.Module, group) -> None:
    """Every :class:`BatchNorm2d` of ``net`` takes its train-mode statistics
    over ``group``'s global batch (None: over its own batch)."""
    for m in net.modules():
        if isinstance(m, BatchNorm2d):
            m.process_group = group


def _cast(p, dtype):
    return None if p is None else p.to(dtype)


def conv_out(n: int, stride: int = 2) -> int:
    """Output size of a 3x3/7x7 'same'-padded conv or 3x3 pool at stride 2."""
    return (n - 1) // stride + 1


class BasicBlock(nn.Module):
    """torchvision BasicBlock: two 3x3 convs + BN, identity/1x1 shortcut (NCHW)."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm2d(cout)
        self.relu = nn.ReLU()
        self.conv2 = Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                Conv2d(cin, cout, 1, stride, bias=False),
                BatchNorm2d(cout))

    def forward(self, x):
        idt = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        return self.relu(self.bn2(self.conv2(y)) + idt)


class ResNetStage1(nn.Sequential):
    """conv1 -> bn -> relu -> maxpool -> layer1 -> layer2 (H/8, 128 ch)."""

    def __init__(self, compute_dtype: torch.dtype = torch.float32):
        super().__init__(
            Conv2d(3, 64, 7, 2, 3, bias=False), BatchNorm2d(64),
            nn.ReLU(), nn.MaxPool2d(3, 2, 1),
            nn.Sequential(BasicBlock(64, 64), BasicBlock(64, 64)),
            nn.Sequential(BasicBlock(64, 128, 2), BasicBlock(128, 128)))
        self.compute_dtype = compute_dtype

    def forward(self, x):
        x = nhwc_to_nchw(x.to(self.compute_dtype))
        return nchw_to_nhwc(super().forward(x))


class ResNetStage2(nn.Sequential):
    """layer3 only (H/16, 256 ch)."""

    def __init__(self):
        super().__init__(nn.Sequential(BasicBlock(128, 256, 2),
                                       BasicBlock(256, 256)))

    def forward(self, x):
        return nchw_to_nhwc(super().forward(nhwc_to_nchw(x)))


class ConvHead(nn.Sequential):
    """(conv3x3 -> relu) x2 -> maxpool2 per stage, bias-free convs."""

    def __init__(self, cin: int, stage_features: Sequence[int],
                 compute_dtype: torch.dtype = torch.float32):
        layers = []
        for feat in stage_features:
            layers += [Conv2d(cin, feat, 3, 1, 1, bias=False), nn.ReLU(),
                       Conv2d(feat, feat, 3, 1, 1, bias=False), nn.ReLU(),
                       nn.MaxPool2d(2, 2)]
            cin = feat
        super().__init__(*layers)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        x = nhwc_to_nchw(x.to(self.compute_dtype))
        return nchw_to_nhwc(super().forward(x))


class MLPHead(nn.Sequential):
    """Linear layers with ReLU between them; input flattened in C,H,W order."""

    def __init__(self, dims: Sequence[int],
                 compute_dtype: torch.dtype = torch.float32):
        layers = []
        for i in range(len(dims) - 1):
            layers.append(Linear(dims[i], dims[i + 1]))
            if i + 2 < len(dims):
                layers.append(nn.ReLU())
        super().__init__(*layers)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        x = nhwc_to_nchw(x).reshape(x.shape[0], -1)
        return super().forward(x.to(self.compute_dtype))


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Random weights from ``generator``, in the JAX package's distributions.

    Convolutions and linear layers: normal with variance 1/fan_in (Flax's
    lecun_normal), regression-head convolutions 2/fan_in (he_normal),
    zero biases, BatchNorm at identity statistics. Values differ from the
    JAX package's (another generator); tests carry weights across with
    ``utils.weights.from_jax_params`` instead.
    """
    head_convs = set()
    for m in module.modules():
        if isinstance(m, ConvHead):
            head_convs.update(id(c) for c in m if isinstance(c, nn.Conv2d))
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.Linear)):
                fan_in = m.weight[0].numel()
                gain = 2.0 if id(m) in head_convs else 1.0
                w = torch.randn(m.weight.shape, generator=generator)
                m.weight.copy_(w * (gain / fan_in) ** 0.5)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
