"""Conformer convolution module and feed-forward (port of the JAX
``models/convolution.py``; layer_norm).  The causal module (left pad
``kernel - 1``) carries the streaming cache: the previous chunk's last
``kernel - 1`` post-GLU frames.

``PositionwiseFeedForward(impl="pallas")`` runs K6, the fused FFN kernel
(``ops/ffn.py``), while dropout is inactive, as the JAX module does; the
default ``impl="xla"`` runs two plain products.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from paper_accurate_fast_cheap_tpu_torch.models.layers import (
    conv, dense, layer_norm)
from paper_accurate_fast_cheap_tpu_torch.ops.ffn import ACTIVATIONS, fused_ffn


class ConvolutionModule(nn.Module):
    """pointwise(2C) -> GLU -> depthwise(k) -> LayerNorm -> SiLU ->
    pointwise, with pad frames zeroed before and after.  ``causal`` pads
    the depthwise conv by ``kernel - 1`` on the left (else (k - 1) / 2 on
    each side)."""

    def __init__(self, channels: int, kernel_size: int = 31,
                 norm: str = "layer_norm", causal: bool = False):
        super().__init__()
        if norm != "layer_norm":
            raise NotImplementedError(
                "the port's conv module has layer_norm; batch_norm waits for "
                "ROADMAP Queue 1, item 12b")
        if not causal and (kernel_size - 1) % 2:
            raise ValueError("a non-causal conv module needs an odd kernel")
        self.causal = causal
        self.lorder = kernel_size - 1
        self.Dense_0 = nn.Linear(channels, 2 * channels)
        self.Conv_0 = nn.Conv1d(channels, channels, kernel_size,
                                padding=0 if causal
                                else (kernel_size - 1) // 2,
                                groups=channels)
        self.LayerNorm_0 = nn.LayerNorm(channels, eps=1e-5)
        self.Dense_1 = nn.Linear(channels, channels)

    def forward(self, x: torch.Tensor,
                mask_pad: Optional[torch.Tensor] = None, cache=None,
                return_cache: bool = False):
        """x (B, T, C); mask_pad (B, T) True where valid.  With
        ``return_cache`` (causal only) the depthwise conv takes ``cache``
        (zeros when None) in place of its left pad and the new cache, the
        last ``kernel - 1`` post-GLU frames, comes back beside the
        output."""
        if return_cache and not self.causal:
            raise ValueError("streaming conv cache requires causal=True")
        if mask_pad is not None:
            x = torch.where(mask_pad[..., None], x, torch.zeros((), dtype=x.dtype,
                                                              device=x.device))
        a, b = dense(self.Dense_0, x).chunk(2, dim=-1)
        y = a * torch.sigmoid(b)
        new_cache = None
        if return_cache:
            if cache is None:
                cache = y.new_zeros(y.shape[0], self.lorder, y.shape[-1])
            y = torch.cat([cache.to(y.dtype), y], dim=1)
            new_cache = y[:, y.shape[1] - self.lorder:]
        elif self.causal:
            y = F.pad(y, (0, 0, self.lorder, 0))
        y = conv(self.Conv_0, y.transpose(1, 2)).transpose(1, 2)
        y = F.silu(layer_norm(self.LayerNorm_0, y))
        y = dense(self.Dense_1, y)
        if mask_pad is not None:
            y = torch.where(mask_pad[..., None], y, torch.zeros((), dtype=y.dtype,
                                                              device=y.device))
        return (y, new_cache) if return_cache else y


class PositionwiseFeedForward(nn.Module):
    """Linear -> activation -> dropout -> Linear.

    ``impl``: ``"xla"`` (default, two products), ``"pallas"`` (K6 while
    dropout is inactive: in ``.eval()`` or at rate 0) or ``"auto"``, which
    resolves to ``"xla"`` (the JAX package's ``PAFC_FFN_IMPL`` switch is not
    ported).  Both share the ``Dense_0``/``Dense_1`` parameters.
    """

    def __init__(self, d_model: int, hidden: int, dropout_rate: float = 0.1,
                 activation: str = "swish", impl: str = "xla"):
        super().__init__()
        if activation not in ACTIVATIONS:
            raise NotImplementedError(f"ffn activation {activation!r}")
        if impl not in ("xla", "pallas", "auto"):
            raise ValueError(f"ffn impl {impl!r} not in xla/pallas/auto")
        self.activation = activation
        self.impl = impl
        self.Dense_0 = nn.Linear(d_model, hidden)
        self.dropout = nn.Dropout(dropout_rate)
        self.Dense_1 = nn.Linear(hidden, d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        drop_active = self.training and self.dropout.p > 0.0
        if self.impl == "pallas" and not drop_active:
            return fused_ffn(x, self.Dense_0.weight, self.Dense_0.bias,
                             self.Dense_1.weight, self.Dense_1.bias,
                             self.activation)
        y = ACTIVATIONS[self.activation](dense(self.Dense_0, x))
        return dense(self.Dense_1, self.dropout(y))
