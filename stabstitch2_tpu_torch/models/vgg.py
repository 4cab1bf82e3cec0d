"""VGG-19 feature trunk of the perceptual loss (port of ``models/vgg.py``).

torchvision's ``vgg19.features`` up to index 13 (relu3_2): 0..255 NHWC
pixels minus the fixed channel mean, conv1_1 .. conv3_2 with ReLUs and two
2x2 max-pools. Only those layers exist; their keys are torchvision's
(``features.{0,2,5,7,10,12}``), so a torchvision ``vgg19`` state_dict
loads through :func:`vgg19_state_dict`.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from stabstitch2_tpu_torch.models.backbone import nchw_to_nhwc, nhwc_to_nchw

VGG_MEAN = (123.6800, 116.7790, 103.9390)
# torchvision vgg19.features indices of the convolutions up to relu3_2
VGG_CONV_INDICES = (0, 2, 5, 7, 10, 12)


class VGG19Features(nn.Module):
    """0..255 NHWC input -> relu3_2 features [B, H/4, W/4, 256] (float32)."""

    def __init__(self):
        super().__init__()
        layers, cin = [], 3
        for feat in (64, 64, "pool", 128, 128, "pool", 256, 256):
            if feat == "pool":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(cin, feat, 3, 1, 1), nn.ReLU()]
                cin = feat
        self.features = nn.Sequential(*layers)
        self.register_buffer("mean", torch.tensor(VGG_MEAN), persistent=False)

    def forward(self, x_255: torch.Tensor) -> torch.Tensor:
        x = nhwc_to_nchw(x_255 - self.mean.to(x_255.dtype))
        return nchw_to_nhwc(self.features(x))


def vgg19_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The entries of a torchvision ``vgg19`` state_dict that
    :class:`VGG19Features` holds (the rest of the net is unused)."""
    keys = {f"features.{i}.{p}" for i in VGG_CONV_INDICES
            for p in ("weight", "bias")}
    missing = keys - set(sd)
    if missing:
        raise KeyError(f"not a torchvision vgg19 state_dict: missing "
                       f"{sorted(missing)}")
    return {k: sd[k] for k in keys}
