"""The three nets of the triad in plain PyTorch, float32, eval mode.

A frozen copy of the published architecture (the reference's
``SpatialWarp``, ``TemporalWarp`` and ``SmoothWarp`` nets, as the
reference checkpoints name their parameters): ResNet-18 stage 1 (conv1,
bn1, relu, maxpool, layer1, layer2: H/8, 128 channels) and layer3 (H/16,
256 channels), the CCL flow, a 4-point homography head, two cost volumes
(search range 5) and per-view mesh heads for the spatial net; stage 1, a
cost volume (search range 3) and a mesh head for the temporal net; two
embeddings, three Conv3D layers and a decoder for the smoothing net.

Everything computes in float32 on NHWC tensors, with BatchNorm at its
running statistics. ``quant='fp8'`` rounds the input, the weight and the
output of every convolution and linear layer of the spatial and temporal
nets to float8 e4m3, with one scale per tensor (amax / 448), and
accumulates in float32, as an fp8 matrix unit would: the control of a
configuration that runs those nets in bfloat16 (bfloat16 inputs,
weights and outputs).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import geometry as G

FP8_MAX = 448.0     # largest finite float8 e4m3


def fake_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale (amax / 448), back in
    float32."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class QConv2d(nn.Conv2d):
    quant: Optional[str] = None

    def forward(self, x):
        if self.quant == "fp8":
            return fake_fp8(self._conv_forward(fake_fp8(x),
                                               fake_fp8(self.weight),
                                               self.bias))
        return super().forward(x)


class QLinear(nn.Linear):
    quant: Optional[str] = None

    def forward(self, x):
        if self.quant == "fp8":
            return fake_fp8(F.linear(fake_fp8(x), fake_fp8(self.weight),
                                     self.bias))
        return super().forward(x)


def set_quant(net: nn.Module, quant: Optional[str]) -> None:
    for m in net.modules():
        if isinstance(m, (QConv2d, QLinear)):
            m.quant = quant


def conv_out(n: int) -> int:
    return (n - 1) // 2 + 1


def feature_sizes(h: int, w: int):
    h8 = conv_out(conv_out(conv_out(h)))
    w8 = conv_out(conv_out(conv_out(w)))
    return (h8, w8), (conv_out(h8), conv_out(w8))


class BasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = QConv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(cout)
        self.relu = nn.ReLU()
        self.conv2 = QConv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                QConv2d(cin, cout, 1, stride, bias=False),
                nn.BatchNorm2d(cout))

    def forward(self, x):
        idt = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        return self.relu(self.bn2(self.conv2(y)) + idt)


class Stage1(nn.Sequential):
    def __init__(self):
        super().__init__(
            QConv2d(3, 64, 7, 2, 3, bias=False), nn.BatchNorm2d(64),
            nn.ReLU(), nn.MaxPool2d(3, 2, 1),
            nn.Sequential(BasicBlock(64, 64), BasicBlock(64, 64)),
            nn.Sequential(BasicBlock(64, 128, 2), BasicBlock(128, 128)))

    def forward(self, x):                     # NHWC in and out
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class Stage2(nn.Sequential):
    def __init__(self):
        super().__init__(nn.Sequential(BasicBlock(128, 256, 2),
                                       BasicBlock(256, 256)))

    def forward(self, x):
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class ConvHead(nn.Sequential):
    def __init__(self, cin: int, feats: Sequence[int]):
        layers = []
        for f in feats:
            layers += [QConv2d(cin, f, 3, 1, 1, bias=False), nn.ReLU(),
                       QConv2d(f, f, 3, 1, 1, bias=False), nn.ReLU(),
                       nn.MaxPool2d(2, 2)]
            cin = f
        super().__init__(*layers)

    def forward(self, x):
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class MLPHead(nn.Sequential):
    def __init__(self, dims: Sequence[int]):
        layers = []
        for i in range(len(dims) - 1):
            layers.append(QLinear(dims[i], dims[i + 1]))
            if i + 2 < len(dims):
                layers.append(nn.ReLU())
        super().__init__(*layers)

    def forward(self, x):                     # flattened in C, H, W order
        return super().forward(x.permute(0, 3, 1, 2).reshape(x.shape[0], -1))


class SpatialNet(nn.Module):
    """(offset [B, 8], mesh motion ref, mesh motion tgt [B, GH+1, GW+1, 2])."""

    def __init__(self, model_h: int, model_w: int, grid_h: int, grid_w: int):
        super().__init__()
        self.grid_h, self.grid_w = grid_h, grid_w
        (h8, w8), (h16, w16) = feature_sizes(model_h, model_w)
        mesh_out = (grid_h + 1) * (grid_w + 1) * 2
        self.feature_extractor_stage1 = Stage1()
        self.feature_extractor_stage2 = Stage2()
        self.regressNet1_part1 = ConvHead(2, (64, 128, 128))
        self.regressNet1_part2 = MLPHead(
            (128 * (h16 // 8) * (w16 // 8), 512, 128, 8))
        head_in = 256 * (h8 // 16) * (w8 // 16)
        self.regressNet2_part1_ref = ConvHead(121, (64, 128, 128, 256))
        self.regressNet2_part2_ref = MLPHead((head_in, 1024, 512, mesh_out))
        self.regressNet2_part1_tgt = ConvHead(121, (64, 128, 128, 256))
        self.regressNet2_part2_tgt = MLPHead((head_in, 1024, 512, mesh_out))

    def forward(self, img1, img2):
        B, img_h, img_w, _ = img1.shape
        f1_8 = self.feature_extractor_stage1(img1)
        f1_16 = self.feature_extractor_stage2(f1_8)
        f2_8 = self.feature_extractor_stage1(img2)
        f2_16 = self.feature_extractor_stage2(f2_8)
        flow = G.ccl_flow(f1_16, f2_16)
        offset_1 = self.regressNet1_part2(self.regressNet1_part1(flow))
        H_ref, H_tgt = G.bidirectional_homographies(
            offset_1.reshape(B, 4, 2), img_h, img_w, scale=8.0)
        h8, w8 = img_h // 8, img_w // 8
        wf1 = G.homo_warp(f1_8, G.normalize_homography(H_ref, h8, w8),
                          (h8, w8))
        wf2 = G.homo_warp(f2_8, G.normalize_homography(H_tgt, h8, w8),
                          (h8, w8))
        off_ref = self.regressNet2_part2_ref(self.regressNet2_part1_ref(
            G.cost_volume(wf1, wf2, 5)))
        off_tgt = self.regressNet2_part2_tgt(self.regressNet2_part1_tgt(
            G.cost_volume(wf2, wf1, 5)))
        shape = (B, self.grid_h + 1, self.grid_w + 1, 2)
        return offset_1, off_ref.reshape(shape), off_tgt.reshape(shape)


class TemporalNet(nn.Module):
    def __init__(self, model_h: int, model_w: int, grid_h: int, grid_w: int):
        super().__init__()
        self.grid_h, self.grid_w = grid_h, grid_w
        (h8, w8), _ = feature_sizes(model_h, model_w)
        self.feature_extractor_stage1 = Stage1()
        self.regressNet2_part1 = ConvHead(49, (64, 128, 128, 256))
        self.regressNet2_part2 = MLPHead(
            (256 * (h8 // 16) * (w8 // 16), 1024, 512,
             (grid_h + 1) * (grid_w + 1) * 2))

    def features(self, img):
        return self.feature_extractor_stage1(img)

    def motion_from_features(self, prev, nxt):
        off = self.regressNet2_part2(self.regressNet2_part1(
            G.cost_volume(prev, nxt, 3)))
        return off.reshape(-1, self.grid_h + 1, self.grid_w + 1, 2)


class MotionPrediction(nn.Module):
    def __init__(self, kernel_t: int = 5):
        super().__init__()
        pad = (kernel_t // 2, 1, 1)
        self.embedding1 = nn.Sequential(nn.Linear(2, 32), nn.ReLU())
        self.embedding3 = nn.Sequential(nn.Linear(2, 32), nn.ReLU())
        self.MotionConv3D = nn.Sequential(
            nn.Conv3d(128, 128, (kernel_t, 3, 3), padding=pad), nn.ReLU(),
            nn.Conv3d(128, 128, (kernel_t, 3, 3), padding=pad), nn.ReLU(),
            nn.Conv3d(128, 128, (kernel_t, 3, 3), padding=pad), nn.ReLU())
        self.decoding = nn.Sequential(nn.Linear(128, 4))

    def forward(self, smesh1, smesh2, tsflow1, tsflow2):
        h1 = torch.cat([self.embedding1(smesh1), self.embedding3(tsflow1)], -1)
        h2 = torch.cat([self.embedding1(smesh2), self.embedding3(tsflow2)], -1)
        h = torch.cat([h1, h2], -1).permute(0, 4, 1, 2, 3)  # B,128,T,H,W
        return self.decoding(self.MotionConv3D(h).permute(0, 2, 3, 4, 1))


class SmoothNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.MotionPre = MotionPrediction()

    def forward(self, smesh1, smesh2, tsmotion1, tsmotion2):
        """Windows [B, T, GH+1, GW+1, 2] -> dict of meshes and paths."""
        path1 = torch.cumsum(tsmotion1, dim=1)
        path2 = torch.cumsum(tsmotion2, dim=1)
        delta = self.MotionPre(smesh1, smesh2, path1, path2)
        d1, d2 = delta[..., 0:2], delta[..., 2:4]
        return {"ori_mesh1": smesh1, "ori_mesh2": smesh2,
                "smooth_mesh1": smesh1 - d1, "smooth_mesh2": smesh2 - d2}


def float32() -> None:
    """Matrix products and convolutions in float32, TF32 off, from here on
    in this process; nothing restores the setting."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def build(cfg: dict, state_dicts: dict, device,
          quant: Optional[str] = None):
    """The three nets of configuration ``cfg`` on ``device``, in eval mode,
    holding ``state_dicts`` ({'spatial', 'temporal', 'smooth'}: reference
    keys). Sets TF32 off for the rest of the process: the reference is
    float32 whatever the program chose before it (``float32``)."""
    float32()
    mh, mw, gh, gw = (cfg["model_h"], cfg["model_w"], cfg["grid_h"],
                      cfg["grid_w"])
    nets = {"spatial": SpatialNet(mh, mw, gh, gw),
            "temporal": TemporalNet(mh, mw, gh, gw),
            "smooth": SmoothNet()}
    for name, net in nets.items():
        net.load_state_dict(state_dicts[name], strict=True)
        net.to(device).eval()
        set_quant(net, quant)
    return nets
