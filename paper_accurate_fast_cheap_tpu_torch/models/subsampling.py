"""Feature subsampling front blocks (port of the JAX
``models/subsampling.py``): ``linear`` (rate 1), ``conv1d2`` (rate 2),
``conv2d`` (rate 4, the paper's ds4), ``conv2d6`` and ``conv2d8``.

The conv2d blocks run VALID convolutions over (time, freq) and flatten the
(freq, channel) axes as ``f * C + c``, the JAX package's NHWC order, so
converted ``Dense_0`` weights line up.  Every block takes ``(x (B, T,
idim), lengths (B,))`` and returns ``(y (B, T', odim), new lengths)``,
clamped at 0.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from paper_accurate_fast_cheap_tpu_torch.models.layers import (
    conv, dense, layer_norm)
from paper_accurate_fast_cheap_tpu_torch.parallel.sequence import (
    halo_exchange)


def _floor_div(x: torch.Tensor, d: int) -> torch.Tensor:
    return torch.div(x, d, rounding_mode="floor")


class LinearNoSubsampling(nn.Module):
    """Linear -> LayerNorm (eps 1e-5) -> dropout, rate 1."""

    def __init__(self, idim: int, odim: int, dropout_rate: float = 0.1):
        super().__init__()
        self.Dense_0 = nn.Linear(idim, odim)
        self.LayerNorm_0 = nn.LayerNorm(odim, eps=1e-5)
        self.dropout = nn.Dropout(dropout_rate)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor):
        y = layer_norm(self.LayerNorm_0, dense(self.Dense_0, x))
        return self.dropout(y), lengths


class Conv1dSubsampling2(nn.Module):
    """One stride-2 width-3 ReLU conv over time (idim -> odim channels),
    rate 2; output length (T - 1) // 2."""

    def __init__(self, idim: int, odim: int, dropout_rate: float = 0.1):
        super().__init__()
        self.Conv_0 = nn.Conv1d(idim, odim, 3, stride=2)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor):
        y = F.relu(conv(self.Conv_0, x.transpose(1, 2))).transpose(1, 2)
        return y, torch.clamp(_floor_div(lengths - 1, 2), min=0)


class _Conv2dSubsampling(nn.Module):
    """Stacked VALID ReLU conv2d layers (kernel, stride) over (time, freq)
    from one input channel, then Dense over the flattened (freq,
    channel)."""

    LAYERS: tuple = ()

    def __init__(self, idim: int, odim: int, dropout_rate: float = 0.1):
        super().__init__()
        f = idim
        for i, (k, s) in enumerate(self.LAYERS):
            setattr(self, f"Conv_{i}", nn.Conv2d(1 if i == 0 else odim, odim,
                                                 k, stride=s))
            f = (f - k) // s + 1
        self.Dense_0 = nn.Linear(odim * f, odim)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor):
        y = x[:, None]
        for i in range(len(self.LAYERS)):
            y = F.relu(conv(getattr(self, f"Conv_{i}"), y))
        b, c, t, f = y.shape
        y = dense(self.Dense_0, y.permute(0, 2, 3, 1).reshape(b, t, f * c))
        for k, s in self.LAYERS:
            lengths = _floor_div(lengths - k, s) + 1
        return y, torch.clamp(lengths, min=0)


class Conv2dSubsampling4(_Conv2dSubsampling):
    """Two stride-2 3x3 convs: output length ((T - 1) // 2 - 1) // 2.

    ``spmd_axis`` (sequence parallelism: this rank's T-shard inside an
    active mesh with that axis) fetches a 6-frame right halo
    (``right_context``): global output j reads inputs [4j, 4j + 6], so with
    the local T divisible by 4 the halo'd VALID convs give exactly T / 4
    outputs a shard, the unsharded outputs on every frame that exists
    globally (the last shard's tail reads the zero halo, as the unsharded
    op on the window zero-padded by 6 frames does)."""

    LAYERS = ((3, 2), (3, 2))
    right_context = 6

    def __init__(self, idim: int, odim: int, dropout_rate: float = 0.1,
                 spmd_axis: Optional[str] = None):
        super().__init__(idim, odim, dropout_rate)
        self.spmd_axis = spmd_axis

    def forward(self, x: torch.Tensor, lengths: torch.Tensor):
        if not self.spmd_axis:
            return super().forward(x, lengths)
        if x.shape[1] % 4:
            raise ValueError(f"sequence-parallel ds4 needs the local window "
                             f"({x.shape[1]}) divisible by 4")
        t_out = x.shape[1] // 4
        x = halo_exchange(x, self.spmd_axis, 0, self.right_context)
        y, lengths = super().forward(x, lengths)
        return y[:, :t_out], lengths


class Conv2dSubsampling6(_Conv2dSubsampling):
    """A stride-2 3x3 conv, then a stride-3 5x5 conv: output length
    ((T - 1) // 2 - 2) // 3."""

    LAYERS = ((3, 2), (5, 3))


class Conv2dSubsampling8(_Conv2dSubsampling):
    """Three stride-2 3x3 convs: output length (((T - 1) // 2 - 1) // 2 -
    1) // 2."""

    LAYERS = ((3, 2), (3, 2), (3, 2))


SUBSAMPLE_CLASSES = {
    "linear": LinearNoSubsampling,
    "conv1d2": Conv1dSubsampling2,
    "conv2d": Conv2dSubsampling4,
    "conv2d6": Conv2dSubsampling6,
    "conv2d8": Conv2dSubsampling8,
}
