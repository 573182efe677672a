"""Branchformer and E-Branchformer encoders (port of the JAX
``models/branchformer.py``).

Each block runs a rel-pos attention branch and a convolutional-gating MLP
(cgMLP) branch side by side and merges them: ``concat`` (concatenate, then
``merge_proj``; E-Branchformer adds a depthwise ``merge_conv`` residual
before the projection), ``learned_ave`` (per-utterance branch weights from
attention-pooled scores) or ``fixed_ave`` (``cgmlp_weight``).  A block may
keep one branch only (``use_attn`` / ``use_cgmlp``).  E-Branchformer wraps
the merge in macaron FFNs (``use_ffn``, x0.5 each).

Training draws: stochastic depth skips a whole block with probability p
(and scales the kept residuals by 1 / (1 - p)); attention-branch drop zeroes
the attention weight of ``learned_ave`` with its rate.  Both draw from
torch's generator in ``.train()``; flax's draws cannot be matched bit for
bit, so parity is held in ``.eval()`` and training by rates.

flax's GELU is the tanh approximation (``ops.ffn.ACTIVATIONS["gelu"]``).
The depthwise convolutions pad (k - 1) / 2 frames on each side.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn as nn

from paper_accurate_fast_cheap_tpu_torch.models.attention import (
    RelPositionMultiHeadedAttention)
from paper_accurate_fast_cheap_tpu_torch.models.conformer import EMB_CLASSES
from paper_accurate_fast_cheap_tpu_torch.models.convolution import (
    PositionwiseFeedForward)
from paper_accurate_fast_cheap_tpu_torch.models.layers import (
    conv, dense, layer_norm)
from paper_accurate_fast_cheap_tpu_torch.models.subsampling import (
    SUBSAMPLE_CLASSES)
from paper_accurate_fast_cheap_tpu_torch.ops.ffn import ACTIVATIONS
from paper_accurate_fast_cheap_tpu_torch.utils.masks import make_pad_mask

_gelu = ACTIVATIONS["gelu"]


def zero_pad(x: torch.Tensor, valid: Optional[torch.Tensor]):
    if valid is None:
        return x
    return torch.where(valid[..., None], x, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


def depthwise(channels: int, kernel: int) -> nn.Conv1d:
    """A depthwise conv over time padded (k - 1) / 2 on each side."""
    return nn.Conv1d(channels, channels, kernel, padding=(kernel - 1) // 2,
                     groups=channels)


def conv_time(c: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """Apply a Conv1d to (B, T, C) and return (B, T', C)."""
    return conv(c, x.transpose(1, 2)).transpose(1, 2)


class ConvolutionalGatingMLP(nn.Module):
    """channel_proj1 (2h) -> GELU -> split (a, b) -> b: LayerNorm, pad
    frames zeroed, depthwise conv -> a * b -> dropout -> channel_proj2."""

    def __init__(self, d_model: int, hidden: int = 2048,
                 kernel_size: int = 31, dropout_rate: float = 0.1):
        super().__init__()
        self.channel_proj1 = nn.Linear(d_model, 2 * hidden)
        self.LayerNorm_0 = nn.LayerNorm(hidden, eps=1e-5)
        self.depthwise = depthwise(hidden, kernel_size)
        self.dropout = nn.Dropout(dropout_rate)
        self.channel_proj2 = nn.Linear(hidden, d_model)

    def forward(self, x: torch.Tensor,
                pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        a, b = _gelu(dense(self.channel_proj1, x)).chunk(2, dim=-1)
        b = zero_pad(layer_norm(self.LayerNorm_0, b), pad_mask)
        y = self.dropout(a * conv_time(self.depthwise, b))
        return dense(self.channel_proj2, y)


class BranchformerLayer(nn.Module):
    """One branchformer block (E-Branchformer with ``use_ffn`` and
    ``merge_conv_kernel > 0``)."""

    def __init__(self, d_model: int, heads: int, cgmlp_hidden: int,
                 kernel_size: int = 31, dropout_rate: float = 0.1,
                 attention_dropout_rate: float = 0.0,
                 merge_conv_kernel: int = 0, use_ffn: bool = False,
                 ffn_hidden: int = 2048, use_attn: bool = True,
                 use_cgmlp: bool = True, merge_method: str = "concat",
                 cgmlp_weight: float = 0.5,
                 attn_branch_drop_rate: float = 0.0,
                 stochastic_depth_rate: float = 0.0):
        super().__init__()
        both = use_attn and use_cgmlp
        if both and merge_method not in ("concat", "learned_ave",
                                         "fixed_ave"):
            raise ValueError(f"unknown merge method {merge_method!r}")
        if not (use_attn or use_cgmlp):
            raise ValueError("a branchformer block needs a branch")
        ln = lambda: nn.LayerNorm(d_model, eps=1e-5)  # noqa: E731
        self.d_model = d_model
        self.use_ffn, self.use_attn, self.use_cgmlp = (use_ffn, use_attn,
                                                       use_cgmlp)
        self.merge_method = merge_method if both else None
        self.cgmlp_weight = cgmlp_weight
        self.attn_branch_drop_rate = attn_branch_drop_rate
        self.stochastic_depth_rate = stochastic_depth_rate
        if use_ffn:
            self.norm_ff_macaron = ln()
            self.feed_forward_macaron = PositionwiseFeedForward(
                d_model, ffn_hidden, dropout_rate)
        if use_attn:
            self.norm_mha = ln()
            self.attn = RelPositionMultiHeadedAttention(
                heads, d_model, attention_dropout_rate)
        if use_cgmlp:
            self.norm_mlp = ln()
            self.cgmlp = ConvolutionalGatingMLP(d_model, cgmlp_hidden,
                                                kernel_size, dropout_rate)
        if self.merge_method == "concat":
            if merge_conv_kernel > 0:
                self.merge_conv = depthwise(2 * d_model, merge_conv_kernel)
            self.merge_proj = nn.Linear(2 * d_model, d_model)
        else:
            if self.merge_method == "learned_ave":
                for j in (1, 2):
                    setattr(self, f"pooling_proj{j}", nn.Linear(d_model, 1))
                    setattr(self, f"weight_proj{j}", nn.Linear(d_model, 1))
            self.merge_proj = nn.Linear(d_model, d_model)
        if use_ffn:
            self.norm_ff = ln()
            self.feed_forward = PositionwiseFeedForward(d_model, ffn_hidden,
                                                        dropout_rate)
        self.norm_final = ln()
        self.dropout = nn.Dropout(dropout_rate)

    def _pooled_weight(self, y, j: int, pad_mask):
        """The branch's scalar weight (B, 1): attention pooling over the
        valid frames, then ``weight_proj{j}``."""
        score = dense(getattr(self, f"pooling_proj{j}"), y)[..., 0]
        score = score / self.d_model ** 0.5
        if pad_mask is not None:
            score = score.masked_fill(~pad_mask, float("-inf"))
        p = torch.softmax(score, dim=-1)
        if pad_mask is not None:
            p = p.masked_fill(~pad_mask, 0.0)
        return dense(getattr(self, f"weight_proj{j}"),
                     torch.einsum("bt,btd->bd", p, y))

    def _merge(self, y1, y2, pad_mask):
        if self.merge_method is None:
            return dense(self.merge_proj, y1 if y2 is None else y2)
        if self.merge_method == "concat":
            merged = torch.cat([y1, y2], dim=-1)
            if hasattr(self, "merge_conv"):
                merged = merged + conv_time(self.merge_conv, merged)
            return dense(self.merge_proj, merged)
        if self.merge_method == "fixed_ave":
            w = self.cgmlp_weight
            return dense(self.merge_proj, (1.0 - w) * y1 + w * y2)
        mw = torch.softmax(torch.cat([self._pooled_weight(y1, 1, pad_mask),
                                      self._pooled_weight(y2, 2, pad_mask)],
                                     dim=-1), dim=-1)
        w1, w2 = mw[:, 0:1, None], mw[:, 1:2, None]
        if self.training and self.attn_branch_drop_rate > 0:
            if torch.rand(()) < self.attn_branch_drop_rate:
                w1, w2 = torch.zeros_like(w1), torch.ones_like(w2)
        return dense(self.merge_proj, w1 * y1 + w2 * y2)

    def forward(self, x, att_mask=None, pos_emb=None, pad_mask=None):
        drop = self.dropout
        p = self.stochastic_depth_rate
        coeff, skip = 1.0, False
        if self.training and p > 0:
            skip = bool(torch.rand(()) < p)
            coeff = 1.0 / (1.0 - p)
        x_in = x
        if self.use_ffn:
            x = x + coeff * 0.5 * drop(self.feed_forward_macaron(
                layer_norm(self.norm_ff_macaron, x)))
        y1 = y2 = None
        if self.use_attn:
            y1 = layer_norm(self.norm_mha, x)
            y1 = drop(self.attn(y1, y1, att_mask, pos_emb))
        if self.use_cgmlp:
            y2 = drop(self.cgmlp(layer_norm(self.norm_mlp, x), pad_mask))
        x = x + coeff * drop(self._merge(y1, y2, pad_mask))
        if self.use_ffn:
            x = x + coeff * 0.5 * drop(self.feed_forward(
                layer_norm(self.norm_ff, x)))
        out = layer_norm(self.norm_final, x)
        return x_in if skip else out


class BranchformerEncoder(nn.Module):
    """subsampling -> positional encoding -> N branchformer blocks (no
    final norm).  ``cgmlp_weight``, ``attn_branch_drop_rate`` and
    ``stochastic_depth_rate`` take one value for every block or a list of
    one per block."""

    def __init__(self, input_size: int = 80, output_size: int = 256,
                 attention_heads: int = 4, cgmlp_linear_units: int = 2048,
                 cgmlp_conv_kernel: int = 31, num_blocks: int = 12,
                 dropout_rate: float = 0.1,
                 positional_dropout_rate: float = 0.1,
                 attention_dropout_rate: float = 0.0,
                 input_layer: str = "conv2d",
                 pos_enc_layer_type: str = "rel_pos", use_ffn: bool = False,
                 linear_units: int = 2048, merge_conv_kernel: int = 0,
                 use_attn: bool = True, use_cgmlp: bool = True,
                 merge_method: str = "concat", cgmlp_weight: Any = 0.5,
                 attn_branch_drop_rate: Any = 0.0,
                 stochastic_depth_rate: Any = 0.0):
        super().__init__()
        self.num_blocks = num_blocks
        self.embed = SUBSAMPLE_CLASSES[input_layer](input_size, output_size,
                                                    dropout_rate)
        self.pos_enc = EMB_CLASSES[pos_enc_layer_type](
            output_size, positional_dropout_rate)

        def per_layer(v, i):
            return v[i] if isinstance(v, (list, tuple)) else v

        for i in range(num_blocks):
            setattr(self, f"layer_{i}", BranchformerLayer(
                output_size, attention_heads, cgmlp_linear_units,
                cgmlp_conv_kernel, dropout_rate, attention_dropout_rate,
                merge_conv_kernel, use_ffn, linear_units, use_attn,
                use_cgmlp, merge_method, per_layer(cgmlp_weight, i),
                per_layer(attn_branch_drop_rate, i),
                per_layer(stochastic_depth_rate, i)))

    def forward(self, xs: torch.Tensor, xs_lens: torch.Tensor):
        xs, out_lens = self.embed(xs, xs_lens)
        out_lens = torch.clamp(out_lens, max=xs.shape[1])
        xs, pos_emb = self.pos_enc(xs)
        pad_mask = make_pad_mask(out_lens, xs.shape[1])
        for i in range(self.num_blocks):
            xs = getattr(self, f"layer_{i}")(xs, pad_mask[:, None, :],
                                             pos_emb, pad_mask)
        return xs, out_lens


def EBranchformerEncoder(**kw) -> BranchformerEncoder:
    """E-Branchformer: branchformer with macaron FFNs and a width-3
    depthwise merge conv (unless ``kw`` sets them)."""
    kw.setdefault("use_ffn", True)
    kw.setdefault("merge_conv_kernel", 3)
    return BranchformerEncoder(**kw)
