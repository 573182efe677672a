"""Conformer convolution module, feed-forward and mixture-of-experts FFN
(port of the JAX ``models/convolution.py``).  The causal module (left pad
``kernel - 1``) carries the streaming cache: the previous chunk's last
``kernel - 1`` post-GLU frames.  The module's ``batch_norm`` normalises with
its running statistics (flax's ``batch_stats``, carried by
``convert.state_dict_from_jax``), as the JAX module does at eval; it does
not train (see :class:`BatchNorm`).

``PositionwiseFeedForward(impl="pallas")`` runs K6, the fused FFN kernel
(``ops/ffn.py``), while dropout is inactive, as the JAX module does; the
default ``impl="xla"`` runs two plain products.

The parallel forms (``parallel/``): the conv module's ``spmd_axis`` takes
its depthwise conv's (kernel - 1) / 2 boundary frames on each side from
the neighbouring T-shards (``halo_exchange``) and refuses masks, causal
mode and caches, as JAX's; an FFN with ``tp_axis`` (set by
``parallel/mesh.shard_params_tp``) holds a column slice of ``Dense_0`` and
a row slice of ``Dense_1`` and closes its product with one psum; a
``MoEFFNLayer`` with ``ep_axis`` (``shard_params_ep``) holds a slice of
the experts and closes its combine with one psum.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from paper_accurate_fast_cheap_tpu_torch.models.layers import (
    conv, dense, lecun_normal_, layer_norm)
from paper_accurate_fast_cheap_tpu_torch.ops.ffn import ACTIVATIONS, fused_ffn
from paper_accurate_fast_cheap_tpu_torch.parallel import collectives
from paper_accurate_fast_cheap_tpu_torch.parallel.sequence import (
    halo_exchange)


BATCH_NORM_TRAINING = (
    "batch_norm trains no statistics: the JAX train step carries no "
    "batch_stats collection, so a conv module with batch_norm runs at eval "
    "only (its running mean and variance come from a converted checkpoint)")


class BatchNorm(nn.Module):
    """flax ``BatchNorm(use_running_average=True, epsilon=1e-5)`` over the
    last axis: (x - mean) / sqrt(var + eps) * weight + bias, in the
    promoted dtype.  The running statistics are buffers without a batch
    counter, so converted checkpoints load strictly; ``.train()`` raises."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(BATCH_NORM_TRAINING)
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        mean, var = self.running_mean.to(dt), self.running_var.to(dt)
        y = (x.to(dt) - mean) * torch.rsqrt(var + self.eps)
        return y * self.weight.to(dt) + self.bias.to(dt)


class ConvolutionModule(nn.Module):
    """pointwise(2C) -> GLU -> depthwise(k) -> LayerNorm or BatchNorm ->
    SiLU -> pointwise, with pad frames zeroed before and after.  ``causal``
    pads the depthwise conv by ``kernel - 1`` on the left (else (k - 1) / 2
    on each side)."""

    def __init__(self, channels: int, kernel_size: int = 31,
                 norm: str = "layer_norm", causal: bool = False,
                 spmd_axis: Optional[str] = None):
        super().__init__()
        self.spmd_axis = spmd_axis
        if norm not in ("layer_norm", "batch_norm"):
            raise ValueError(f"conv module norm {norm!r}: layer_norm or "
                             "batch_norm")
        if not causal and (kernel_size - 1) % 2:
            raise ValueError("a non-causal conv module needs an odd kernel")
        self.causal = causal
        self.lorder = kernel_size - 1
        self.Dense_0 = nn.Linear(channels, 2 * channels)
        self.Conv_0 = nn.Conv1d(channels, channels, kernel_size,
                                padding=0 if causal
                                else (kernel_size - 1) // 2,
                                groups=channels)
        if norm == "layer_norm":
            self.LayerNorm_0 = nn.LayerNorm(channels, eps=1e-5)
        else:
            self.BatchNorm_0 = BatchNorm(channels)
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
        if self.spmd_axis and (mask_pad is not None or self.causal
                               or return_cache):
            raise ValueError("spmd_axis conv requires full-length "
                             "non-causal sequences without caches")
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
        if self.spmd_axis:
            h = self.lorder // 2
            y = halo_exchange(y, self.spmd_axis, h, h)
            c = self.Conv_0
            dt = torch.promote_types(y.dtype, c.weight.dtype)
            y = F.conv1d(y.transpose(1, 2).to(dt), c.weight.to(dt),
                         c.bias.to(dt), groups=c.groups).transpose(1, 2)
        else:
            y = conv(self.Conv_0, y.transpose(1, 2)).transpose(1, 2)
        if hasattr(self, "LayerNorm_0"):
            y = layer_norm(self.LayerNorm_0, y)
        else:
            y = self.BatchNorm_0(y)
        y = F.silu(y)
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
    ported).  Both share the ``Dense_0``/``Dense_1`` parameters.  Under
    ``tp_axis`` both run on this rank's hidden slice; the psum of the
    partial products precedes ``Dense_1``'s bias.
    """

    tp_axis: Optional[str] = None

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
        up, down, axis = self.Dense_0, self.Dense_1, self.tp_axis
        if axis:
            x = collectives.pvary(x, axis)
        b2 = torch.zeros_like(down.bias) if axis else down.bias
        if self.impl == "pallas" and not drop_active:
            out = fused_ffn(x, up.weight, up.bias, down.weight, b2,
                            self.activation)
        else:
            y = self.dropout(ACTIVATIONS[self.activation](dense(up, x)))
            dt = torch.promote_types(y.dtype, down.weight.dtype)
            out = F.linear(y.to(dt), down.weight.to(dt), b2.to(dt))
        if not axis:
            return out
        return collectives.psum(out, axis) + down.bias.to(out.dtype)


def top_k_lowest_index(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of the last axis, ties to
    the lowest index, as ``jax.lax.top_k`` (a stable descending sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class MoEFFNLayer(nn.Module):
    """Token-choice top-k mixture of experts with dense dispatch: the gate
    (Linear, no bias) picks ``n_expert_per_token`` experts per frame (ties
    to the lowest index), softmax over their logits gives the combine
    weights, and every expert runs on every frame (``w1`` (E, D, H), ``w2``
    (E, H, D), no biases, flax's layout).  Under ``ep_axis`` this rank
    holds E / n experts and combines their outputs, and one psum sums the
    ranks' shares."""

    ep_axis: Optional[str] = None

    def __init__(self, d_model: int, hidden: int, n_experts: int = 4,
                 n_expert_per_token: int = 2, activation: str = "swish"):
        super().__init__()
        if activation not in ("swish", "relu", "gelu"):
            raise NotImplementedError(f"moe activation {activation!r}")
        self.activation = activation
        self.n_experts, self.k = n_experts, n_expert_per_token
        self.gate = nn.Linear(d_model, n_experts, bias=False)
        self.w1 = nn.Parameter(torch.zeros(n_experts, d_model, hidden))
        self.w2 = nn.Parameter(torch.zeros(n_experts, hidden, d_model))

    def reset_parameters_from(self, g: torch.Generator) -> None:
        # flax lecun_normal on (E, in, out): fan_in = in * E
        for w in (self.w1, self.w2):
            lecun_normal_(w, w.shape[0] * w.shape[1], g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        logits = dense(self.gate, x)                          # (B, T, E)
        topv, topi = top_k_lowest_index(logits, self.k)
        weights = torch.softmax(topv, dim=-1)
        comb = torch.zeros_like(logits).scatter_add_(-1, topi, weights)
        axis = self.ep_axis
        if axis:
            x = collectives.pvary(x, axis)
            e = self.w1.shape[0]
            comb = collectives.pvary(comb, axis).narrow(
                -1, collectives.axis_index(axis) * e, e)
        dt = torch.promote_types(x.dtype, self.w1.dtype)
        h = ACTIVATIONS[self.activation](
            torch.einsum("btd,edh->bteh", x.to(dt), self.w1.to(dt)))
        out = torch.einsum("bteh,ehd->bted", h, self.w2.to(dt))
        y = torch.einsum("bted,bte->btd", out, comb.to(dt))
        return collectives.psum(y, axis) if axis else y
