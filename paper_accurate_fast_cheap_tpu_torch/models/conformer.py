"""Conformer and transformer encoders with a swappable attention registry
(port of the JAX ``models/conformer.py``).

Block order (pre-norm, LayerNorm eps 1e-5): macaron FFN x0.5 -> attention
-> conv module -> FFN x0.5 -> final norm, with dropout on each branch
before its residual add (active in ``.train()``); ``macaron_style=False``
drops the first FFN (the second then counts x1) and ``use_cnn_module=False``
the conv module and the final norm.  Any subsampling of
``models/subsampling.py`` fronts the blocks (``input_layer``).
``num_langs > 0`` turns blocks 0 and N - 1 into language-specific (LSL)
blocks mixed by ``cat_embs``.  The attention registry
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

Sequence parallelism (``rwkv_conf["spmd_axis"]``, as JAX): the encoder
runs on this rank's T-shard inside an active mesh with that axis; the
conv2d (ds4) subsampling takes its right halo, the RWKV or Mamba-2
attention and the conv module take theirs, and no pad mask, attention mask
or lengths reach the blocks (full-length sequences).

Streaming (``return_state``): the chunk is fully valid, so no mask is made;
each layer carries ``{"attn", "conv"}``: the uni RWKV's (x_prev, WKV state),
the uni Mamba's {"conv", "ssd"} or the MHA's fixed-size KV cache (the last
``att_cache_size`` keys, positions from ``offset - att_cache_size``, zero
rows where t < 0), and the causal conv module's cache.
Submodule names follow the flax tree (``embed``, ``layer_{i}``,
``RelPositionMultiHeadedAttention_{i}``, ``RWKVAttention_{i}``, ...,
``after_norm``) so ``convert.state_dict_from_jax`` is layout work only.  As
in flax, the attention modules sit on the encoder, not inside their layers,
numbered over the plain blocks (an LSL block holds its own, ``lang_{k}``
with ``{type}_{k}``).

``TransformerEncoder`` is the plain stack: pre-norm self-attention
(``MultiHeadedAttention``) and FFN blocks (``norm1``/``norm2``), abs_pos by
default, relu FFNs.
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
    SUBSAMPLE_CLASSES)
from paper_accurate_fast_cheap_tpu_torch.parallel import collectives as cc
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
            alt_decoding=rwkv_conf.get("alt_decoding", False),
            spmd_axis=rwkv_conf.get("spmd_axis"))
    if layer_type == "mamba_att":
        return MambaAttention(
            head_size=d_model // heads, d_model=d_model,
            direction=rwkv_conf.get("rnn_att_direction", "bi"),
            spmd_axis=rwkv_conf.get("spmd_axis"))
    raise NotImplementedError(f"attention type {layer_type!r}")


class ConformerEncoderLayer(nn.Module):
    """One conformer block, pre-norm: [macaron FFN x0.5] -> attention ->
    [conv module] -> FFN (x0.5 with the macaron FFN, else x1) -> [final
    norm, with the conv module].  As in the JAX layer, ``normalize_before``
    does not change the block (it only drops the encoder's
    ``after_norm``)."""

    def __init__(self, d_model: int, linear_units: int,
                 dropout_rate: float = 0.1, cnn_module_kernel: int = 31,
                 cnn_module_norm: str = "layer_norm",
                 activation: str = "swish", causal: bool = False,
                 macaron_style: bool = True, use_cnn_module: bool = True,
                 spmd_axis: Optional[str] = None):
        super().__init__()
        ln = lambda: nn.LayerNorm(d_model, eps=1e-5)  # noqa: E731
        ffn = lambda: PositionwiseFeedForward(  # noqa: E731
            d_model, linear_units, dropout_rate, activation)
        self.macaron_style = macaron_style
        self.use_cnn_module = use_cnn_module
        if macaron_style:
            self.norm_ff_macaron = ln()
            self.feed_forward_macaron = ffn()
        self.norm_mha = ln()
        if use_cnn_module:
            self.norm_conv = ln()
            self.conv_module = ConvolutionModule(d_model, cnn_module_kernel,
                                                 cnn_module_norm, causal,
                                                 spmd_axis)
        self.norm_ff = ln()
        self.feed_forward = ffn()
        if use_cnn_module:
            self.norm_final = ln()
        self.dropout = nn.Dropout(dropout_rate)

    def forward(self, x, attn: nn.Module, att_mask=None, pos_emb=None,
                pad_mask=None, lengths=None, layer_state=None,
                return_state: bool = False):
        """With ``return_state`` returns (x, {"attn", "conv"}), the new
        streaming state from ``layer_state`` (the zero state when None)."""
        drop = self.dropout
        ff_scale = 0.5 if self.macaron_style else 1.0
        if self.macaron_style:
            x = x + ff_scale * drop(self.feed_forward_macaron(
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
        if self.use_cnn_module:
            y = layer_norm(self.norm_conv, x)
            if return_state:
                y, new_state["conv"] = self.conv_module(
                    y, pad_mask, cache=layer_state["conv"] if layer_state
                    else None, return_cache=True)
            else:
                y = self.conv_module(y, pad_mask)
            x = x + drop(y)
        x = x + ff_scale * drop(self.feed_forward(
            layer_norm(self.norm_ff, x)))
        if self.use_cnn_module:
            x = layer_norm(self.norm_final, x)
        return (x, new_state) if return_state else x


class LanguageSpecificConformerEncoderLayer(nn.Module):
    """LSL block: ``num_langs`` parallel conformer blocks (``lang_{k}``,
    each with its own attention ``{type}_{k}``, flax's names) mixed per
    utterance by ``cat_embs`` (B, >= num_langs): out = sum_k w[b, k] *
    lang_k(x)[b], the weights cast to the blocks' dtype; ``cat_embs=None``
    mixes uniformly (1 / num_langs)."""

    def __init__(self, num_langs: int, attn_factory, **layer_kwargs):
        super().__init__()
        self.num_langs = num_langs
        self.attention_names = []
        for k in range(num_langs):
            attn = attn_factory()
            name = f"{type(attn).__name__}_{k}"
            setattr(self, name, attn)
            self.attention_names.append(name)
            setattr(self, f"lang_{k}", ConformerEncoderLayer(**layer_kwargs))

    def forward(self, x, att_mask=None, pos_emb=None, pad_mask=None,
                lengths=None, cat_embs: Optional[torch.Tensor] = None):
        stacked = torch.stack([
            getattr(self, f"lang_{k}")(x, getattr(self, name), att_mask,
                                        pos_emb, pad_mask, lengths)
            for k, name in enumerate(self.attention_names)], dim=1)
        if cat_embs is None:
            w = torch.full((x.shape[0], self.num_langs),
                           1.0 / self.num_langs, device=x.device)
        else:
            w = cat_embs[:, :self.num_langs]
        return torch.einsum("bk,bktd->btd", w.to(stacked.dtype), stacked)


class ConformerEncoder(nn.Module):
    """subsampling (``input_layer``) -> positional encoding -> N blocks ->
    after_norm (with ``normalize_before``).

    Returns (encoded (B, T', D), out_lengths (B,)).  ``num_langs > 0``
    makes blocks 0 and N - 1 language-specific
    (:class:`LanguageSpecificConformerEncoderLayer`), mixed by the
    ``cat_embs`` that ``forward`` takes.
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
                 gradient_checkpointing: bool = False, num_langs: int = 0,
                 rwkv_conf: Optional[dict] = None, **unused: Any):
        super().__init__()
        if unused:
            logging.getLogger(__name__).warning(
                "conformer encoder: keys of other encoder families ignored: "
                "%s", sorted(unused))
        rwkv_conf = dict(rwkv_conf or {})
        self.num_blocks = num_blocks
        self.attention_type = selfattention_layer_type
        self.heads, self.output_size = attention_heads, output_size
        self.static_chunk_size = static_chunk_size
        self.use_dynamic_chunk = use_dynamic_chunk
        self.use_dynamic_left_chunk = use_dynamic_left_chunk
        self.gradient_checkpointing = gradient_checkpointing
        self.num_langs = num_langs
        # the host generator of the training forward's dynamic chunk draw
        # (seeded 0 at first use unless the trainer sets it)
        self.chunk_generator: Optional[torch.Generator] = None
        self.spmd_axis = rwkv_conf.get("spmd_axis")
        sub_kw = {}
        if self.spmd_axis:
            if input_layer != "conv2d":
                raise ValueError(
                    "spmd_axis from raw features requires the conv2d (ds4) "
                    "frontend; use pre_embedded=True for "
                    f"input_layer={input_layer!r}")
            sub_kw["spmd_axis"] = self.spmd_axis
        self.embed = SUBSAMPLE_CLASSES[input_layer](input_size, output_size,
                                                    dropout_rate, **sub_kw)
        self.pos_enc = EMB_CLASSES[pos_enc_layer_type](
            output_size, positional_dropout_rate)
        layer_kwargs = dict(
            d_model=output_size, linear_units=linear_units,
            dropout_rate=dropout_rate, cnn_module_kernel=cnn_module_kernel,
            cnn_module_norm=cnn_module_norm, activation=activation_type,
            causal=causal, macaron_style=macaron_style,
            use_cnn_module=use_cnn_module, spmd_axis=self.spmd_axis)
        # the encoder's own attention modules, one per plain block (flax
        # numbers them over the plain blocks only); None for an LSL block
        self.attention_names = []
        self.block_attention = []
        for i in range(num_blocks):
            def attn_factory(i=i):
                return _make_attention(
                    selfattention_layer_type, attention_heads, output_size,
                    attention_dropout_rate, key_bias, num_blocks, i,
                    rwkv_conf)

            if num_langs > 0 and i in (0, num_blocks - 1):
                setattr(self, f"layer_{i}",
                        LanguageSpecificConformerEncoderLayer(
                            num_langs, attn_factory, **layer_kwargs))
                self.block_attention.append(None)
                continue
            attn = attn_factory()
            name = f"{type(attn).__name__}_{len(self.attention_names)}"
            setattr(self, name, attn)
            self.attention_names.append(name)
            self.block_attention.append(name)
            setattr(self, f"layer_{i}", ConformerEncoderLayer(**layer_kwargs))
        self.after_norm = (nn.LayerNorm(output_size, eps=1e-5)
                           if normalize_before else None)

    def forward(self, xs: torch.Tensor, xs_lens: torch.Tensor,
                decoding_chunk_size: int = 0,
                num_decoding_left_chunks: int = -1, *,
                streaming_state: Optional[dict] = None,
                return_state: bool = False, offset: int = 0,
                att_cache_size: int = 0, return_layers: bool = False,
                cat_embs: Optional[torch.Tensor] = None,
                pre_embedded: bool = False):
        """Full forward, or with ``return_state`` one streaming chunk:
        positions from ``offset`` (encoder frames), no masks, and
        ``streaming_state`` ({"layers": [per-layer state]}, None at the
        start) carried; returns (xs, out_lens, new streaming state).  With
        ``return_layers`` the full forward returns (xs, out_lens, [each
        block's output, before the final norm]).  ``cat_embs`` (B, K) mixes
        the LSL blocks (ignored without them).  With ``pre_embedded`` xs is
        already at the subsampled rate and width (the SSL models' second
        pass): no subsampling, lengths clamped to T."""
        if not pre_embedded:
            xs, xs_lens = self.embed(xs, xs_lens)
        # under sequence parallelism the lengths are the whole sequence's
        # (JAX clamps them to this shard's frames)
        t_all = xs.shape[1] * (cc.axis_size(self.spmd_axis)
                               if self.spmd_axis else 1)
        out_lens = torch.clamp(xs_lens, max=t_all)
        xs, pos_emb = self.pos_enc(xs, offset=offset)
        if return_state:
            return self._chunk(xs, out_lens, pos_emb, streaming_state,
                               offset, att_cache_size)
        T = xs.shape[1]
        pad_mask = make_pad_mask(out_lens, T)
        lens = out_lens
        if self.spmd_axis:
            # this rank's T-shard of full-length sequences: no masks or
            # lengths, the modules take their boundary frames from the mesh
            pad_mask = att_mask = lens = None
        elif self.use_dynamic_chunk and self.training:
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
        for i, name in enumerate(self.block_attention):
            layer = getattr(self, f"layer_{i}")
            if name is None:
                # an LSL block gets the lengths under sequence parallelism
                # too, as in JAX (its RWKV then refuses them)
                xs = layer(xs, att_mask, pos_emb, pad_mask, out_lens,
                           cat_embs)
            elif remat:
                xs = torch.utils.checkpoint.checkpoint(
                    layer, xs, getattr(self, name), att_mask, pos_emb,
                    pad_mask, lens, use_reentrant=False)
            else:
                xs = layer(xs, getattr(self, name), att_mask, pos_emb,
                           pad_mask, lens)
            if return_layers:
                layer_outs.append(xs)
        xs = self._after_norm(xs)
        return (xs, out_lens, layer_outs) if return_layers else (xs, out_lens)

    def _after_norm(self, xs: torch.Tensor) -> torch.Tensor:
        if self.after_norm is None:
            return xs
        return layer_norm(self.after_norm, xs)

    def _chunk(self, xs, out_lens, pos_emb, streaming_state, offset: int,
               att_cache_size: int):
        """One streaming chunk through the blocks (the JAX encoder's
        ``return_state`` branch)."""
        if self.num_langs > 0:
            raise ValueError("streaming: the language-specific blocks have "
                             "no streaming state")
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
        return self._after_norm(xs), out_lens, {"layers": new_states}


class TransformerEncoderLayer(nn.Module):
    """Pre-norm attention and FFN, each with dropout before its residual
    (``normalize_before`` does not change the block, as in JAX)."""

    def __init__(self, d_model: int, linear_units: int,
                 dropout_rate: float = 0.1, activation: str = "relu"):
        super().__init__()
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.feed_forward = PositionwiseFeedForward(
            d_model, linear_units, dropout_rate, activation)
        self.dropout = nn.Dropout(dropout_rate)

    def forward(self, x, attn: nn.Module, att_mask=None, pos_emb=None):
        y = layer_norm(self.norm1, x)
        x = x + self.dropout(attn(y, y, att_mask, pos_emb))
        return x + self.dropout(self.feed_forward(layer_norm(self.norm2, x)))


class TransformerEncoder(nn.Module):
    """subsampling -> positional encoding -> N transformer blocks (their
    ``MultiHeadedAttention_{i}`` on the encoder) -> after_norm (with
    ``normalize_before``).  Returns (encoded, out_lengths)."""

    def __init__(self, input_size: int = 80, output_size: int = 256,
                 attention_heads: int = 4, linear_units: int = 2048,
                 num_blocks: int = 6, dropout_rate: float = 0.1,
                 positional_dropout_rate: float = 0.1,
                 attention_dropout_rate: float = 0.0,
                 input_layer: str = "conv2d",
                 pos_enc_layer_type: str = "abs_pos",
                 normalize_before: bool = True, key_bias: bool = True,
                 activation_type: str = "relu"):
        super().__init__()
        self.num_blocks = num_blocks
        self.embed = SUBSAMPLE_CLASSES[input_layer](input_size, output_size,
                                                    dropout_rate)
        self.pos_enc = EMB_CLASSES[pos_enc_layer_type](
            output_size, positional_dropout_rate)
        for i in range(num_blocks):
            setattr(self, f"MultiHeadedAttention_{i}", MultiHeadedAttention(
                attention_heads, output_size, attention_dropout_rate,
                key_bias))
            setattr(self, f"layer_{i}", TransformerEncoderLayer(
                output_size, linear_units, dropout_rate, activation_type))
        self.after_norm = (nn.LayerNorm(output_size, eps=1e-5)
                           if normalize_before else None)

    def forward(self, xs: torch.Tensor, xs_lens: torch.Tensor):
        xs, out_lens = self.embed(xs, xs_lens)
        xs, pos_emb = self.pos_enc(xs)
        att_mask = make_pad_mask(out_lens, xs.shape[1])[:, None, :]
        for i in range(self.num_blocks):
            xs = getattr(self, f"layer_{i}")(
                xs, getattr(self, f"MultiHeadedAttention_{i}"), att_mask,
                pos_emb)
        if self.after_norm is not None:
            xs = layer_norm(self.after_norm, xs)
        return xs, out_lens
