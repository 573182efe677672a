"""Efficient Conformer encoder (port of the JAX
``models/efficient_conformer.py``).

Grouped rel-pos attention: queries, keys, values and projected positions
are cut into groups of ``group_size`` frames (the tail zero-padded) that
attend as single units of width d_k * g, so the score matrix is (T/g)^2.
A group is masked when none of its frames is valid, and the softmax is the
plain one: a row with every group masked comes out uniform, not zero (the
rule of ``models/attention.masked_softmax`` does not apply here).

Progressive downsampling: a layer in ``stride_layers`` runs its depthwise
conv with that stride (padding (k - 1) / 2 on each side, so ceil(T / s)
frames) and average-pools its residual over groups of s frames, the
zero-padded tail frames counted in the mean.  Lengths become
ceil(len / s), and every later layer reads the first T' rows of the
encoder's one positional table.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from paper_accurate_fast_cheap_tpu_torch.models.attention import (
    NEG_INF, MultiHeadedAttention, RelPositionMultiHeadedAttention)
from paper_accurate_fast_cheap_tpu_torch.models.branchformer import (
    conv_time, zero_pad)
from paper_accurate_fast_cheap_tpu_torch.models.conformer import EMB_CLASSES
from paper_accurate_fast_cheap_tpu_torch.models.convolution import (
    PositionwiseFeedForward)
from paper_accurate_fast_cheap_tpu_torch.models.layers import (
    dense, layer_norm, xavier_uniform_)
from paper_accurate_fast_cheap_tpu_torch.models.subsampling import (
    SUBSAMPLE_CLASSES)
from paper_accurate_fast_cheap_tpu_torch.utils.masks import make_pad_mask


class GroupedRelPositionAttention(MultiHeadedAttention):
    """Rel-pos attention over frame groups; ``pos_bias_u`` and
    ``pos_bias_v`` are (H, d_k * group_size)."""

    def __init__(self, heads: int, d_model: int, dropout_rate: float = 0.0,
                 key_bias: bool = True, group_size: int = 3):
        super().__init__(heads, d_model, dropout_rate, key_bias)
        self.group_size = group_size
        self.linear_pos = nn.Linear(d_model, d_model, bias=False)
        self.pos_bias_u = nn.Parameter(torch.zeros(heads,
                                                   self.d_k * group_size))
        self.pos_bias_v = nn.Parameter(torch.zeros(heads,
                                                   self.d_k * group_size))

    def reset_parameters_from(self, g: torch.Generator) -> None:
        xavier_uniform_(self.pos_bias_u, g)
        xavier_uniform_(self.pos_bias_v, g)

    def forward(self, x_q: torch.Tensor, x_kv: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                pos_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        g, H, dk = self.group_size, self.heads, self.d_k
        B, T, _ = x_q.shape
        q, k, v = self._qkv(x_q, x_kv)
        if pos_emb is None:
            p = torch.zeros_like(k)
        else:
            p = dense(self.linear_pos, pos_emb).reshape(
                -1, pos_emb.shape[1], H, dk).to(k.dtype).expand(k.shape)
        pad = (-T) % g
        Tg = (T + pad) // g

        def group(a):  # (B, T, H, dk) -> (B, Tg, H, dk * g)
            a = F.pad(a, (0, 0, 0, 0, 0, pad))
            return a.reshape(B, Tg, g, H, dk).permute(0, 1, 3, 2, 4).reshape(
                B, Tg, H, dk * g)

        qg, kg, vg, pg = map(group, (q, k, v, p))
        scale = (1.0 / torch.sqrt(torch.tensor(float(dk * g)))).to(
            q.dtype).to(q.device)
        scores = (torch.einsum("bthd,bshd->bhts", qg + self.pos_bias_u, kg)
                  + torch.einsum("bthd,bshd->bhts", qg + self.pos_bias_v,
                                 pg)) * scale
        if mask is not None:
            m = mask[:, 0] if mask.ndim == 3 else mask
            mg = F.pad(m, (0, pad)).reshape(B, Tg, g).any(dim=-1)
            scores = scores.masked_fill(~mg[:, None, None, :], NEG_INF)
        probs = self.attn_dropout(torch.softmax(scores, dim=-1))
        out = torch.einsum("bhts,bshd->bthd", probs, vg)
        out = out.reshape(B, Tg, H, g, dk).permute(0, 1, 3, 2, 4).reshape(
            B, Tg * g, H * dk)[:, :T]
        return dense(self.linear_out, out)


class EfficientConformerLayer(nn.Module):
    """Macaron conformer block whose conv part (``pw1`` -> GLU -> ``dw``
    -> ``conv_ln`` -> SiLU -> ``pw2``) may be strided; the attention is
    grouped or the plain rel-pos MHA."""

    def __init__(self, d_model: int, heads: int, linear_units: int,
                 cnn_kernel: int = 15, stride: int = 1, group_size: int = 3,
                 use_grouped_attn: bool = True, dropout_rate: float = 0.1,
                 attention_dropout_rate: float = 0.0):
        super().__init__()
        ln = lambda: nn.LayerNorm(d_model, eps=1e-5)  # noqa: E731
        self.stride = stride
        self.norm_ff_macaron = ln()
        self.feed_forward_macaron = PositionwiseFeedForward(
            d_model, linear_units, dropout_rate)
        self.norm_mha = ln()
        self.attn = (GroupedRelPositionAttention(
            heads, d_model, attention_dropout_rate, group_size=group_size)
            if use_grouped_attn else RelPositionMultiHeadedAttention(
                heads, d_model, attention_dropout_rate))
        self.norm_conv = ln()
        self.pw1 = nn.Linear(d_model, 2 * d_model)
        self.dw = nn.Conv1d(d_model, d_model, cnn_kernel, stride=stride,
                            padding=(cnn_kernel - 1) // 2, groups=d_model)
        self.conv_ln = ln()
        self.pw2 = nn.Linear(d_model, d_model)
        self.norm_ff = ln()
        self.feed_forward = PositionwiseFeedForward(d_model, linear_units,
                                                    dropout_rate)
        self.norm_final = ln()
        self.dropout = nn.Dropout(dropout_rate)

    def forward(self, x, att_mask=None, pos_emb=None, pad_mask=None):
        drop = self.dropout
        x = x + 0.5 * drop(self.feed_forward_macaron(
            layer_norm(self.norm_ff_macaron, x)))
        y = layer_norm(self.norm_mha, x)
        x = x + drop(self.attn(y, y, att_mask, pos_emb))
        res = x
        y = zero_pad(layer_norm(self.norm_conv, x), pad_mask)
        a, b = dense(self.pw1, y).chunk(2, dim=-1)
        y = conv_time(self.dw, a * torch.sigmoid(b))
        y = dense(self.pw2, F.silu(layer_norm(self.conv_ln, y)))
        if self.stride > 1:
            s = self.stride
            r = F.pad(res, (0, 0, 0, (-res.shape[1]) % s))
            r = r.reshape(r.shape[0], -1, s, r.shape[-1]).mean(dim=2)
            res = r[:, :y.shape[1]]
        x = res + drop(y)
        x = x + 0.5 * drop(self.feed_forward(layer_norm(self.norm_ff, x)))
        return layer_norm(self.norm_final, x)


class EfficientConformerEncoder(nn.Module):
    """subsampling -> positional encoding -> N layers, strided at
    ``stride_layers`` (factors ``strides``, 2 by default) and grouped at
    ``group_layers`` (every layer when None); no final norm."""

    def __init__(self, input_size: int = 80, output_size: int = 256,
                 attention_heads: int = 4, linear_units: int = 1024,
                 num_blocks: int = 12, stride_layers: Sequence[int] = (3, 7),
                 strides: Optional[Sequence[int]] = None,
                 group_layers: Optional[Sequence[int]] = None,
                 group_size: int = 3, cnn_module_kernel: int = 15,
                 dropout_rate: float = 0.1,
                 attention_dropout_rate: float = 0.0,
                 input_layer: str = "conv2d",
                 pos_enc_layer_type: str = "rel_pos"):
        super().__init__()
        stride_layers = tuple(stride_layers)
        strides = (tuple(strides) if strides is not None
                   else (2,) * len(stride_layers))
        if len(strides) != len(stride_layers):
            raise ValueError("efficient conformer: one stride per stride "
                             "layer")
        self.num_blocks = num_blocks
        self.strides = [strides[stride_layers.index(i)]
                        if i in stride_layers else 1
                        for i in range(num_blocks)]
        self.embed = SUBSAMPLE_CLASSES[input_layer](input_size, output_size,
                                                    dropout_rate)
        self.pos_enc = EMB_CLASSES[pos_enc_layer_type](output_size,
                                                       dropout_rate)
        for i in range(num_blocks):
            setattr(self, f"layer_{i}", EfficientConformerLayer(
                output_size, attention_heads, linear_units,
                cnn_module_kernel, self.strides[i], group_size,
                group_layers is None or i in tuple(group_layers),
                dropout_rate, attention_dropout_rate))

    def forward(self, xs: torch.Tensor, xs_lens: torch.Tensor):
        xs, lens = self.embed(xs, xs_lens)
        lens = torch.clamp(lens, max=xs.shape[1])
        xs, pos_emb = self.pos_enc(xs)
        for i, s in enumerate(self.strides):
            pad_mask = make_pad_mask(lens, xs.shape[1])
            xs = getattr(self, f"layer_{i}")(
                xs, pad_mask[:, None, :], pos_emb[:, :xs.shape[1]], pad_mask)
            if s > 1:
                lens = torch.div(lens + s - 1, s, rounding_mode="floor")
        return xs, lens
