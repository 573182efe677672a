"""Conformer encoder with a swappable attention registry (port of the
full-context branch of the JAX ``models/conformer.py``).

Block order (pre-norm, LayerNorm eps 1e-5): macaron FFN x0.5 -> attention
-> conv module -> FFN x0.5 -> final norm, with dropout on each branch
before its residual add (active in ``.train()``).  The attention registry
is the JAX one: ``selfattn``, ``rel_selfattn``, ``espnet_rel_selfattn``
(``models/attention.py``), ``limited_rel_selfattn`` (LCA with global
tokens, ``models/lca.py``; its context and global tokens come from
``rwkv_conf``) and the RWKV-6 directions (``models/rwkv.py``; the eval
controls ``bidirectional_layers`` and ``alt_decoding`` come from
``rwkv_conf`` too) and ``mamba_att`` (Mamba-2, ``models/mamba.py``: headdim
``d_model // heads``, d_state 128, chunk 64, its direction from
``rnn_att_direction``).

The full forward masks attention as JAX does: the padding mask, combined
with a chunk mask (``utils/masks.add_optional_chunk_mask``) in training with
``use_dynamic_chunk`` (one ``(chunk, nleft)`` drawn per batch from
``chunk_generator``), and when
``static_chunk_size > 0`` or ``decoding_chunk_size != 0``.  The recurrent
attentions never read the mask; MHA, its rel-pos variants and LCA do.
``gradient_checkpointing`` recomputes each block in the training backward
(``torch.utils.checkpoint``, JAX's ``nn.remat``); the recomputation reads
the block's parameters from the module, so a functional train step binds
them there (``train/train_step.bind_params``).

Streaming (``return_state``): the chunk is fully valid, so no mask is made;
each layer carries ``{"attn", "conv"}``: the uni RWKV's (x_prev, WKV state),
the uni Mamba's {"conv", "ssd"} or the MHA's fixed-size KV cache (the last
``att_cache_size`` keys, positions from ``offset - att_cache_size``, zero
rows where t < 0), and the causal conv module's cache.
Submodule names follow the flax tree (``embed``, ``layer_{i}``,
``RelPositionMultiHeadedAttention_{i}``, ``RWKVAttention_{i}``, ...,
``after_norm``) so ``convert.state_dict_from_jax`` is layout work only.  As
in flax, the attention modules sit on the encoder, not inside their layers;
layer i is called with attention module i.
"""
from __future__ import annotations

import logging
from typing import Any, Optional

import torch
import torch.nn as nn
import torch.utils.checkpoint

from paper_accurate_fast_cheap_tpu_torch.models.attention import (
    ESPnetRelPositionMultiHeadedAttention, MultiHeadedAttention,
    RelPositionMultiHeadedAttention)
from paper_accurate_fast_cheap_tpu_torch.models.convolution import (
    ConvolutionModule, PositionwiseFeedForward)
from paper_accurate_fast_cheap_tpu_torch.models.embedding import (
    NoPositionalEncoding, PositionalEncoding, RelPositionalEncoding,
    sinusoid_positions)
from paper_accurate_fast_cheap_tpu_torch.models.layers import layer_norm
from paper_accurate_fast_cheap_tpu_torch.models.lca import (
    LimitedRelPositionAttention)
from paper_accurate_fast_cheap_tpu_torch.models.mamba import MambaAttention
from paper_accurate_fast_cheap_tpu_torch.models.rwkv import RWKVAttention
from paper_accurate_fast_cheap_tpu_torch.models.subsampling import (
    Conv2dSubsampling4)
from paper_accurate_fast_cheap_tpu_torch.utils.masks import (
    add_optional_chunk_mask, make_pad_mask)

EMB_CLASSES = {
    "abs_pos": PositionalEncoding,
    "rel_pos": RelPositionalEncoding,
    "no_pos": NoPositionalEncoding,
}
_MHA_CLASSES = {
    "selfattn": MultiHeadedAttention,
    "rel_selfattn": RelPositionMultiHeadedAttention,
    "espnet_rel_selfattn": ESPnetRelPositionMultiHeadedAttention,
}
_DIRECTIONS = {
    "rwkv_tmix60": "uni",
    "rwkv_tmix60_bidirectional": "bi",
    "rwkv_tmix60_bidirectional2": "bi",
    "rwkv_tmix60_dir_layer_drop": "dirdrop",
    "rwkv_tmix60_dir_layer_drop_both": "dirdrop_both",
}


def _make_attention(layer_type: str, heads: int, d_model: int,
                    dropout_rate: float, key_bias: bool, num_blocks: int,
                    layer_id: int, rwkv_conf: dict) -> nn.Module:
    if layer_type in _MHA_CLASSES:
        return _MHA_CLASSES[layer_type](heads, d_model, dropout_rate,
                                        key_bias)
    if layer_type == "limited_rel_selfattn":
        return LimitedRelPositionAttention(
            heads, d_model, dropout_rate, key_bias,
            context_size=rwkv_conf.get("att_context_size", (256, 256)),
            global_tokens=rwkv_conf.get("global_tokens", 0),
            global_tokens_spacing=rwkv_conf.get("global_tokens_spacing", 1))
    direction = _DIRECTIONS.get(layer_type)
    if direction is not None:
        return RWKVAttention(
            head_size=d_model // heads,
            dim_att=d_model, n_layers=num_blocks, direction=direction,
            layer_id=layer_id,
            do_bfloat16=rwkv_conf.get("rwkv_do_bfloat16", True),
            bidirectional_layers=rwkv_conf.get("bidirectional_layers"),
            alt_decoding=rwkv_conf.get("alt_decoding", False))
    if layer_type == "mamba_att":
        return MambaAttention(
            head_size=d_model // heads, d_model=d_model,
            direction=rwkv_conf.get("rnn_att_direction", "bi"),
            spmd_axis=rwkv_conf.get("spmd_axis"))
    raise NotImplementedError(f"attention type {layer_type!r}")


class ConformerEncoderLayer(nn.Module):
    """One conformer block (pre-norm, macaron, conv module)."""

    def __init__(self, d_model: int, linear_units: int,
                 dropout_rate: float = 0.1, cnn_module_kernel: int = 31,
                 cnn_module_norm: str = "layer_norm",
                 activation: str = "swish", causal: bool = False):
        super().__init__()
        ln = lambda: nn.LayerNorm(d_model, eps=1e-5)  # noqa: E731
        ffn = lambda: PositionwiseFeedForward(  # noqa: E731
            d_model, linear_units, dropout_rate, activation)
        self.norm_ff_macaron = ln()
        self.feed_forward_macaron = ffn()
        self.norm_mha = ln()
        self.norm_conv = ln()
        self.conv_module = ConvolutionModule(d_model, cnn_module_kernel,
                                             cnn_module_norm, causal)
        self.norm_ff = ln()
        self.feed_forward = ffn()
        self.norm_final = ln()
        self.dropout = nn.Dropout(dropout_rate)

    def forward(self, x, attn: nn.Module, att_mask=None, pos_emb=None,
                pad_mask=None, lengths=None, layer_state=None,
                return_state: bool = False):
        """With ``return_state`` returns (x, {"attn", "conv"}), the new
        streaming state from ``layer_state`` (the zero state when None)."""
        drop = self.dropout
        x = x + 0.5 * drop(self.feed_forward_macaron(
            layer_norm(self.norm_ff_macaron, x)))
        y = layer_norm(self.norm_mha, x)
        att_state = layer_state["attn"] if layer_state else None
        new_state = {}
        if isinstance(attn, (RWKVAttention, MambaAttention)):
            if return_state:
                y, new_state["attn"] = attn(y, lengths=lengths,
                                            state=att_state,
                                            return_state=True)
            else:
                y = attn(y, lengths=lengths)
        elif return_state:
            y, new_state["attn"] = attn(y, y, att_mask, pos_emb,
                                        cache=att_state, return_cache=True)
        else:
            y = attn(y, y, att_mask, pos_emb)
        x = x + drop(y)
        y = layer_norm(self.norm_conv, x)
        if return_state:
            y, new_state["conv"] = self.conv_module(
                y, pad_mask, cache=layer_state["conv"] if layer_state
                else None, return_cache=True)
        else:
            y = self.conv_module(y, pad_mask)
        x = x + drop(y)
        x = x + 0.5 * drop(self.feed_forward(layer_norm(self.norm_ff, x)))
        x = layer_norm(self.norm_final, x)
        return (x, new_state) if return_state else x


class ConformerEncoder(nn.Module):
    """conv2d /4 subsampling -> positional encoding -> N blocks ->
    after_norm.

    Returns (encoded (B, T', D), out_lengths (B,)).  Pre-norm macaron
    blocks with a conv module (causal or not) after conv2d subsampling;
    other layouts raise NotImplementedError (other subsamplings and block
    layouts wait for ROADMAP Queue 1, item 12b).
    """

    def __init__(self, input_size: int = 80, output_size: int = 512,
                 attention_heads: int = 8, linear_units: int = 2048,
                 num_blocks: int = 12, dropout_rate: float = 0.1,
                 positional_dropout_rate: float = 0.1,
                 attention_dropout_rate: float = 0.0,
                 input_layer: str = "conv2d",
                 pos_enc_layer_type: str = "rel_pos",
                 normalize_before: bool = True, macaron_style: bool = True,
                 use_cnn_module: bool = True, cnn_module_kernel: int = 31,
                 cnn_module_norm: str = "layer_norm",
                 activation_type: str = "swish", causal: bool = False,
                 key_bias: bool = True,
                 selfattention_layer_type: str = "rel_selfattn",
                 static_chunk_size: int = 0, use_dynamic_chunk: bool = False,
                 use_dynamic_left_chunk: bool = False,
                 gradient_checkpointing: bool = False,
                 rwkv_conf: Optional[dict] = None, **unused: Any):
        super().__init__()
        if unused:
            logging.getLogger(__name__).warning(
                "conformer encoder: keys of other encoder families ignored: "
                "%s", sorted(unused))
        if (input_layer != "conv2d" or pos_enc_layer_type not in EMB_CLASSES
                or not (normalize_before and macaron_style
                        and use_cnn_module)):
            raise NotImplementedError(
                "the port's conformer has conv2d input, pre-norm macaron "
                "blocks with a conv module and abs_pos, rel_pos or no_pos "
                "positions; other layouts wait for ROADMAP Queue 1, item 12b")
        rwkv_conf = dict(rwkv_conf or {})
        self.num_blocks = num_blocks
        self.attention_type = selfattention_layer_type
        self.heads, self.output_size = attention_heads, output_size
        self.static_chunk_size = static_chunk_size
        self.use_dynamic_chunk = use_dynamic_chunk
        self.use_dynamic_left_chunk = use_dynamic_left_chunk
        self.gradient_checkpointing = gradient_checkpointing
        # the host generator of the training forward's dynamic chunk draw
        # (seeded 0 at first use unless the trainer sets it)
        self.chunk_generator: Optional[torch.Generator] = None
        self.embed = Conv2dSubsampling4(input_size, output_size)
        self.pos_enc = EMB_CLASSES[pos_enc_layer_type](
            output_size, positional_dropout_rate)
        self.attention_names = []
        for i in range(num_blocks):
            attn = _make_attention(
                selfattention_layer_type, attention_heads, output_size,
                attention_dropout_rate, key_bias, num_blocks, i, rwkv_conf)
            name = f"{type(attn).__name__}_{i}"
            setattr(self, name, attn)
            self.attention_names.append(name)
            setattr(self, f"layer_{i}", ConformerEncoderLayer(
                output_size, linear_units, dropout_rate, cnn_module_kernel,
                cnn_module_norm, activation_type, causal))
        self.after_norm = nn.LayerNorm(output_size, eps=1e-5)

    def forward(self, xs: torch.Tensor, xs_lens: torch.Tensor,
                decoding_chunk_size: int = 0,
                num_decoding_left_chunks: int = -1, *,
                streaming_state: Optional[dict] = None,
                return_state: bool = False, offset: int = 0,
                att_cache_size: int = 0, return_layers: bool = False):
        """Full forward, or with ``return_state`` one streaming chunk:
        positions from ``offset`` (encoder frames), no masks, and
        ``streaming_state`` ({"layers": [per-layer state]}, None at the
        start) carried; returns (xs, out_lens, new streaming state).  With
        ``return_layers`` the full forward returns (xs, out_lens, [each
        block's output, before the final norm])."""
        xs, out_lens = self.embed(xs, xs_lens)
        out_lens = torch.clamp(out_lens, max=xs.shape[1])
        xs, pos_emb = self.pos_enc(xs, offset=offset)
        if return_state:
            return self._chunk(xs, out_lens, pos_emb, streaming_state,
                               offset, att_cache_size)
        T = xs.shape[1]
        pad_mask = make_pad_mask(out_lens, T)
        if self.use_dynamic_chunk and self.training:
            if self.chunk_generator is None:
                self.chunk_generator = torch.Generator().manual_seed(0)
            att_mask = add_optional_chunk_mask(
                pad_mask, True, self.use_dynamic_left_chunk,
                decoding_chunk_size, self.static_chunk_size,
                num_decoding_left_chunks, generator=self.chunk_generator)
        elif self.static_chunk_size > 0 or decoding_chunk_size != 0:
            att_mask = add_optional_chunk_mask(
                pad_mask, False, False, max(decoding_chunk_size, 0),
                self.static_chunk_size, num_decoding_left_chunks)
        else:
            att_mask = pad_mask[:, None, :]
        remat = self.gradient_checkpointing and self.training
        layer_outs = []
        for i, name in enumerate(self.attention_names):
            layer, attn = getattr(self, f"layer_{i}"), getattr(self, name)
            if remat:
                xs = torch.utils.checkpoint.checkpoint(
                    layer, xs, attn, att_mask, pos_emb, pad_mask, out_lens,
                    use_reentrant=False)
            else:
                xs = layer(xs, attn, att_mask, pos_emb, pad_mask, out_lens)
            if return_layers:
                layer_outs.append(xs)
        xs = layer_norm(self.after_norm, xs)
        return (xs, out_lens, layer_outs) if return_layers else (xs, out_lens)

    def _chunk(self, xs, out_lens, pos_emb, streaming_state, offset: int,
               att_cache_size: int):
        """One streaming chunk through the blocks (the JAX encoder's
        ``return_state`` branch)."""
        layer_states = (streaming_state or {}).get("layers")
        if self.attention_type in ("selfattn", "rel_selfattn"):
            Tc, (B, T) = int(att_cache_size), xs.shape[:2]
            d, h = self.output_size, self.heads
            if layer_states is None:
                zero = lambda: {  # noqa: E731
                    "k": xs.new_zeros(B, Tc, h, d // h, dtype=torch.float32),
                    "v": xs.new_zeros(B, Tc, h, d // h, dtype=torch.float32),
                    "valid": torch.zeros(B, Tc, dtype=torch.bool,
                                         device=xs.device)}
                layer_states = [{"attn": zero(), "conv": None}
                                for _ in range(self.num_blocks)]
            # key positions offset - Tc .. offset + T, zero rows for t < 0
            pe = sinusoid_positions(offset - Tc, Tc + T, d, xs.device)
            pos_ids = offset - Tc + torch.arange(Tc + T, device=xs.device)
            pos_emb = pe.masked_fill((pos_ids < 0)[:, None], 0.0)[None]
        elif not isinstance(getattr(self, self.attention_names[0]),
                            (RWKVAttention, MambaAttention)):
            raise ValueError(
                f"streaming: attention type {self.attention_type!r} has no "
                "streaming state (selfattn, rel_selfattn, or a uni "
                "rwkv_tmix60 or mamba_att)")
        new_states = []
        for i, name in enumerate(self.attention_names):
            xs, st = getattr(self, f"layer_{i}")(
                xs, getattr(self, name), None, pos_emb, None, out_lens,
                layer_states[i] if layer_states else None, True)
            new_states.append(st)
        return (layer_norm(self.after_norm, xs), out_lens,
                {"layers": new_states})
