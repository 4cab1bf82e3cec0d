"""The precisions one step below what the configurations state, in which
the control of a stitching cell (``control.py``) computes the reference:
the spatial and temporal nets, bfloat16 in the configurations, in float8
e4m3 (``reference/nets.py:fake_fp8``), and the composite's spline and
fusion, float32 in the configurations, in bfloat16."""

import torch

NETS = "fp8"
COMPOSITE = torch.bfloat16
DESCRIPTION = ("the reference, its nets in float8 e4m3 and its composite in "
               "bfloat16")
