"""Model families as torch modules named like the reference checkpoints."""

from stabstitch2_tpu_torch.models.smooth import SmoothNet
from stabstitch2_tpu_torch.models.spatial import SpatialNet
from stabstitch2_tpu_torch.models.temporal import TemporalNet
from stabstitch2_tpu_torch.models.vgg import VGG19Features

__all__ = ["SpatialNet", "TemporalNet", "SmoothNet", "VGG19Features"]
