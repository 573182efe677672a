"""Conformer encoder with RWKV-6 attention (port of the full-context branch
of the JAX ``models/conformer.py``).

Block order (pre-norm, LayerNorm eps 1e-5): macaron FFN x0.5 -> attention
-> conv module -> FFN x0.5 -> final norm, with dropout on each branch
before its residual add (active in ``.train()``).  Submodule names follow
the flax tree (``embed``, ``layer_{i}``, ``RWKVAttention_{i}``,
``after_norm``) so ``convert.state_dict_from_jax`` is layout work only.  As
in flax, the attention modules sit on the encoder, not inside their layers;
layer i is called with ``RWKVAttention_{i}``.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn as nn

from paper_accurate_fast_cheap_tpu_torch.models.convolution import (
    ConvolutionModule, PositionwiseFeedForward)
from paper_accurate_fast_cheap_tpu_torch.models.embedding import (
    RelPositionalEncoding)
from paper_accurate_fast_cheap_tpu_torch.models.layers import layer_norm
from paper_accurate_fast_cheap_tpu_torch.models.rwkv import RWKVAttention
from paper_accurate_fast_cheap_tpu_torch.models.subsampling import (
    Conv2dSubsampling4)
from paper_accurate_fast_cheap_tpu_torch.utils.masks import make_pad_mask

_DIRECTIONS = {
    "rwkv_tmix60": "uni",
    "rwkv_tmix60_bidirectional": "bi",
    "rwkv_tmix60_bidirectional2": "bi",
}


def _make_attention(layer_type: str, heads: int, d_model: int,
                    num_blocks: int, layer_id: int, rwkv_conf: dict):
    direction = _DIRECTIONS.get(layer_type)
    if direction is None:
        raise NotImplementedError(
            f"attention type {layer_type!r} waits for a later slice")
    return RWKVAttention(
        head_size=d_model // heads,
        dim_att=d_model, n_layers=num_blocks, direction=direction,
        layer_id=layer_id,
        do_bfloat16=rwkv_conf.get("rwkv_do_bfloat16", True))


class ConformerEncoderLayer(nn.Module):
    """One conformer block (pre-norm, macaron, conv module)."""

    def __init__(self, d_model: int, linear_units: int,
                 dropout_rate: float = 0.1, cnn_module_kernel: int = 31,
                 cnn_module_norm: str = "layer_norm",
                 activation: str = "swish"):
        super().__init__()
        ln = lambda: nn.LayerNorm(d_model, eps=1e-5)  # noqa: E731
        ffn = lambda: PositionwiseFeedForward(  # noqa: E731
            d_model, linear_units, dropout_rate, activation)
        self.norm_ff_macaron = ln()
        self.feed_forward_macaron = ffn()
        self.norm_mha = ln()
        self.norm_conv = ln()
        self.conv_module = ConvolutionModule(d_model, cnn_module_kernel,
                                             cnn_module_norm)
        self.norm_ff = ln()
        self.feed_forward = ffn()
        self.norm_final = ln()
        self.dropout = nn.Dropout(dropout_rate)

    def forward(self, x, attn: nn.Module, pad_mask=None, lengths=None):
        drop = self.dropout
        x = x + 0.5 * drop(self.feed_forward_macaron(
            layer_norm(self.norm_ff_macaron, x)))
        x = x + drop(attn(layer_norm(self.norm_mha, x), lengths=lengths))
        x = x + drop(self.conv_module(layer_norm(self.norm_conv, x),
                                      pad_mask))
        x = x + 0.5 * drop(self.feed_forward(layer_norm(self.norm_ff, x)))
        return layer_norm(self.norm_final, x)


class ConformerEncoder(nn.Module):
    """conv2d /4 subsampling -> rel-pos x-scaling -> N blocks -> after_norm.

    Returns (encoded (B, T', D), out_lengths (B,)).  Only the options of
    the flagship family are ported; others raise NotImplementedError.
    """

    def __init__(self, input_size: int = 80, output_size: int = 512,
                 attention_heads: int = 8, linear_units: int = 2048,
                 num_blocks: int = 12, dropout_rate: float = 0.1,
                 positional_dropout_rate: float = 0.1,
                 input_layer: str = "conv2d",
                 pos_enc_layer_type: str = "rel_pos",
                 normalize_before: bool = True, macaron_style: bool = True,
                 use_cnn_module: bool = True, cnn_module_kernel: int = 31,
                 cnn_module_norm: str = "layer_norm",
                 activation_type: str = "swish", causal: bool = False,
                 selfattention_layer_type: str = "rwkv_tmix60_bidirectional",
                 rwkv_conf: Optional[dict] = None, **unused: Any):
        super().__init__()
        if (input_layer != "conv2d" or pos_enc_layer_type != "rel_pos"
                or not (normalize_before and macaron_style and use_cnn_module)
                or causal):
            raise NotImplementedError(
                "the port's encoder is the flagship family: conv2d input, "
                "rel_pos, pre-norm macaron blocks with a non-causal conv "
                "module")
        rwkv_conf = dict(rwkv_conf or {})
        self.num_blocks = num_blocks
        self.embed = Conv2dSubsampling4(input_size, output_size)
        self.pos_enc = RelPositionalEncoding(output_size,
                                             positional_dropout_rate)
        for i in range(num_blocks):
            setattr(self, f"RWKVAttention_{i}", _make_attention(
                selfattention_layer_type, attention_heads, output_size,
                num_blocks, i, rwkv_conf))
            setattr(self, f"layer_{i}", ConformerEncoderLayer(
                output_size, linear_units, dropout_rate, cnn_module_kernel,
                cnn_module_norm, activation_type))
        self.after_norm = nn.LayerNorm(output_size, eps=1e-5)

    def forward(self, xs: torch.Tensor, xs_lens: torch.Tensor):
        xs, out_lens = self.embed(xs, xs_lens)
        out_lens = torch.clamp(out_lens, max=xs.shape[1])
        xs, _ = self.pos_enc(xs)
        pad_mask = make_pad_mask(out_lens, xs.shape[1])
        for i in range(self.num_blocks):
            xs = getattr(self, f"layer_{i}")(
                xs, getattr(self, f"RWKVAttention_{i}"), pad_mask, out_lens)
        return layer_norm(self.after_norm, xs), out_lens
