"""Squeezeformer encoder (port of the JAX ``models/squeezeformer.py``).

Post-norm blocks: attention -> LN -> FFN -> LN -> conv module -> LN -> FFN
-> LN, each sublayer fed through a learned scale and bias
(``ScaledResidual``) of its input.  A temporal U-Net, possibly nested:
before each block index in ``reduce_idx`` the stack saves (xs, lengths,
positions) and halves the frame rate with a stride-2 width-5 depthwise
conv (padded 2 and 2; lengths (len + 1) // 2); before each index in
``recover_idx`` it restores the last saved level: repeat each frame twice,
cut to the saved length, ``time_recover_{l}`` (Linear), add the saved xs,
and zero the frames past the saved lengths.  A LayerNorm (``preln``)
precedes the blocks and another (``final_norm``) follows them.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn as nn

from paper_accurate_fast_cheap_tpu_torch.models.attention import (
    RelPositionMultiHeadedAttention)
from paper_accurate_fast_cheap_tpu_torch.models.branchformer import (
    conv_time)
from paper_accurate_fast_cheap_tpu_torch.models.conformer import EMB_CLASSES
from paper_accurate_fast_cheap_tpu_torch.models.convolution import (
    ConvolutionModule, PositionwiseFeedForward)
from paper_accurate_fast_cheap_tpu_torch.models.layers import (
    dense, layer_norm)
from paper_accurate_fast_cheap_tpu_torch.models.subsampling import (
    SUBSAMPLE_CLASSES)
from paper_accurate_fast_cheap_tpu_torch.utils.masks import make_pad_mask


class ScaledResidual(nn.Module):
    """x * weight + bias over the last axis (flax's ``scale`` and ``bias``,
    initialised to ones and zeros)."""

    def __init__(self, d_model: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d_model))
        self.bias = nn.Parameter(torch.zeros(d_model))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        return x.to(dt) * self.weight.to(dt) + self.bias.to(dt)


class SqueezeformerBlock(nn.Module):
    """x -> MHA -> LN -> FFN -> LN -> conv -> LN -> FFN -> LN, post-norm."""

    def __init__(self, d_model: int, heads: int, linear_units: int,
                 cnn_kernel: int = 31, dropout_rate: float = 0.1,
                 attention_dropout_rate: float = 0.0):
        super().__init__()
        ln = lambda: nn.LayerNorm(d_model, eps=1e-5)  # noqa: E731
        self.scale_mha = ScaledResidual(d_model)
        self.attn = RelPositionMultiHeadedAttention(heads, d_model,
                                                    attention_dropout_rate)
        self.ln_mha = ln()
        self.scale_ffn1 = ScaledResidual(d_model)
        self.ffn1 = PositionwiseFeedForward(d_model, linear_units,
                                            dropout_rate)
        self.ln_ffn1 = ln()
        self.scale_conv = ScaledResidual(d_model)
        self.conv = ConvolutionModule(d_model, cnn_kernel, "layer_norm")
        self.ln_conv = ln()
        self.scale_ffn2 = ScaledResidual(d_model)
        self.ffn2 = PositionwiseFeedForward(d_model, linear_units,
                                            dropout_rate)
        self.ln_ffn2 = ln()
        self.dropout = nn.Dropout(dropout_rate)

    def forward(self, x, att_mask=None, pos_emb=None, pad_mask=None):
        drop = self.dropout
        y = self.scale_mha(x)
        x = layer_norm(self.ln_mha, x + drop(self.attn(y, y, att_mask,
                                                       pos_emb)))
        y = self.ffn1(self.scale_ffn1(x))
        x = layer_norm(self.ln_ffn1, x + drop(y))
        y = self.conv(self.scale_conv(x), pad_mask)
        x = layer_norm(self.ln_conv, x + drop(y))
        y = self.ffn2(self.scale_ffn2(x))
        return layer_norm(self.ln_ffn2, x + drop(y))


def _levels(idx: Any) -> list:
    if isinstance(idx, int):
        return [idx]
    return list(idx or [])


class SqueezeformerEncoder(nn.Module):
    """subsampling -> positional encoding -> preln -> N blocks with the
    time U-Net -> final_norm.  Returns (encoded, lengths)."""

    def __init__(self, input_size: int = 80, output_size: int = 256,
                 attention_heads: int = 4, linear_units: int = 1024,
                 num_blocks: int = 12, reduce_idx: Any = 5,
                 recover_idx: Any = 11, cnn_module_kernel: int = 31,
                 dropout_rate: float = 0.1,
                 attention_dropout_rate: float = 0.0,
                 input_layer: str = "conv2d",
                 pos_enc_layer_type: str = "rel_pos"):
        super().__init__()
        self.reduce_idx = _levels(reduce_idx)
        self.recover_idx = _levels(recover_idx)
        if len(self.reduce_idx) != len(self.recover_idx):
            raise ValueError("squeezeformer: reduce_idx and recover_idx "
                             "need one entry per level")
        self.num_blocks = num_blocks
        self.embed = SUBSAMPLE_CLASSES[input_layer](input_size, output_size,
                                                    dropout_rate)
        self.pos_enc = EMB_CLASSES[pos_enc_layer_type](output_size,
                                                       dropout_rate)
        self.preln = nn.LayerNorm(output_size, eps=1e-5)
        for level in range(len(self.reduce_idx)):
            setattr(self, f"time_reduce_{level}", nn.Conv1d(
                output_size, output_size, 5, stride=2, padding=2,
                groups=output_size))
            setattr(self, f"time_recover_{level}",
                    nn.Linear(output_size, output_size))
        for i in range(num_blocks):
            setattr(self, f"block_{i}", SqueezeformerBlock(
                output_size, attention_heads, linear_units,
                cnn_module_kernel, dropout_rate, attention_dropout_rate))
        self.final_norm = nn.LayerNorm(output_size, eps=1e-5)

    def forward(self, xs: torch.Tensor, xs_lens: torch.Tensor):
        xs, lens = self.embed(xs, xs_lens)
        lens = torch.clamp(lens, max=xs.shape[1])
        xs, pe = self.pos_enc(xs)
        xs = layer_norm(self.preln, xs)
        saved = []
        for i in range(self.num_blocks):
            if i in self.reduce_idx:
                level = len(saved)
                saved.append((xs, lens, pe))
                xs = conv_time(getattr(self, f"time_reduce_{level}"), xs)
                lens = torch.div(lens + 1, 2, rounding_mode="floor")
                pe = pe[:, :xs.shape[1]]
            if i in self.recover_idx and saved:
                level = len(saved) - 1
                rec_xs, lens, pe = saved.pop()
                up = xs.repeat_interleave(2, dim=1)[:, :rec_xs.shape[1]]
                xs = rec_xs + dense(getattr(self, f"time_recover_{level}"),
                                    up)
                valid = make_pad_mask(lens, xs.shape[1])
                xs = torch.where(valid[..., None], xs,
                                 torch.zeros((), dtype=xs.dtype,
                                             device=xs.device))
            pad_mask = make_pad_mask(lens, xs.shape[1])
            xs = getattr(self, f"block_{i}")(
                xs, pad_mask[:, None, :], pe[:, :xs.shape[1]], pad_mask)
        return layer_norm(self.final_norm, xs), lens
