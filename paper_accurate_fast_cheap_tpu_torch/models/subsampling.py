"""Conv2d /4 subsampling (port of the JAX ``models/subsampling.py``)."""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from paper_accurate_fast_cheap_tpu_torch.models.layers import conv, dense


class Conv2dSubsampling4(nn.Module):
    """Two stride-2 3x3 ReLU convs over (time, freq), then Linear.

    Output length ((T - 1) // 2 - 1) // 2.  The (freq, channel) axes are
    flattened as ``f * C + c``, the JAX package's NHWC order, so converted
    ``Dense_0`` weights line up.
    """

    def __init__(self, idim: int, odim: int):
        super().__init__()
        self.Conv_0 = nn.Conv2d(1, odim, 3, stride=2)
        self.Conv_1 = nn.Conv2d(odim, odim, 3, stride=2)
        f = ((idim - 1) // 2 - 1) // 2
        self.Dense_0 = nn.Linear(odim * f, odim)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor):
        y = F.relu(conv(self.Conv_0, x[:, None]))
        y = F.relu(conv(self.Conv_1, y))
        b, c, t, f = y.shape
        y = dense(self.Dense_0, y.permute(0, 2, 3, 1).reshape(b, t, f * c))
        new_lengths = torch.div(torch.div(lengths - 1, 2, rounding_mode="floor")
                                - 1, 2, rounding_mode="floor")
        return y, torch.clamp(new_lengths, min=0)
