"""Attention (bi)transformer decoders (port of the JAX ``models/decoder.py``).

Token embedding -> x * sqrt(d) + sinusoid PE -> N pre-norm blocks of
[causal self-attention, cross-attention over the encoder output, ReLU FFN]
(LayerNorm eps 1e-5) -> LayerNorm -> vocabulary Linear.  The self mask is
the label pad mask & the subsequent mask, the memory mask the encoder's pad
mask.  ``BiTransformerDecoder`` adds a right-to-left decoder over reversed
labels; submodule names follow the flax tree (``left_decoder.layer_{i}.
self_attn.linear_q``, ``embed``, ``after_norm``, ``output_layer``, ...).

As in flax, where parameters exist only for the submodules the model's
loss calls, the right decoder is built only when ``with_right`` (the
owning model's ``reverse_weight > 0``).
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from paper_accurate_fast_cheap_tpu_torch.models.attention import (
    MultiHeadedAttention)
from paper_accurate_fast_cheap_tpu_torch.models.convolution import (
    PositionwiseFeedForward)
from paper_accurate_fast_cheap_tpu_torch.models.embedding import (
    PositionalEncoding)
from paper_accurate_fast_cheap_tpu_torch.models.layers import (
    dense, layer_norm)
from paper_accurate_fast_cheap_tpu_torch.ops.common import (
    accuracy, add_sos_eos, reverse_pad_list)
from paper_accurate_fast_cheap_tpu_torch.ops.losses import (
    label_smoothing_loss)
from paper_accurate_fast_cheap_tpu_torch.utils.masks import (
    make_pad_mask, subsequent_mask)


class DecoderLayer(nn.Module):
    def __init__(self, d_model: int, heads: int, linear_units: int,
                 dropout_rate: float = 0.1,
                 self_attention_dropout_rate: float = 0.0,
                 src_attention_dropout_rate: float = 0.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.self_attn = MultiHeadedAttention(heads, d_model,
                                              self_attention_dropout_rate)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.src_attn = MultiHeadedAttention(heads, d_model,
                                             src_attention_dropout_rate)
        self.norm3 = nn.LayerNorm(d_model, eps=1e-5)
        self.feed_forward = PositionwiseFeedForward(
            d_model, linear_units, dropout_rate, activation="relu")
        self.dropout = nn.Dropout(dropout_rate)

    def forward(self, x, self_mask, memory, memory_mask):
        y = layer_norm(self.norm1, x)
        x = x + self.dropout(self.self_attn(y, y, self_mask))
        y = layer_norm(self.norm2, x)
        x = x + self.dropout(self.src_attn(y, memory, memory_mask))
        y = layer_norm(self.norm3, x)
        return x + self.dropout(self.feed_forward(y))


class TransformerDecoder(nn.Module):
    def __init__(self, vocab_size: int, encoder_output_size: int,
                 attention_heads: int = 8, linear_units: int = 2048,
                 num_blocks: int = 3, dropout_rate: float = 0.1,
                 positional_dropout_rate: float = 0.1,
                 self_attention_dropout_rate: float = 0.0,
                 src_attention_dropout_rate: float = 0.0):
        super().__init__()
        d = encoder_output_size
        self.num_blocks = num_blocks
        self.embed = nn.Embedding(vocab_size, d)
        self.pos_enc = PositionalEncoding(d, positional_dropout_rate)
        for i in range(num_blocks):
            setattr(self, f"layer_{i}", DecoderLayer(
                d, attention_heads, linear_units, dropout_rate,
                self_attention_dropout_rate, src_attention_dropout_rate))
        self.after_norm = nn.LayerNorm(d, eps=1e-5)
        self.output_layer = nn.Linear(d, vocab_size)

    def forward(self, memory, memory_lens, ys_in, ys_lens):
        """memory (B, T, D), ys_in (B, U) starting with <sos> -> logits
        (B, U, V)."""
        x = self.embed(ys_in.long())
        x, _ = self.pos_enc(x)
        U = ys_in.shape[1]
        self_mask = (make_pad_mask(ys_lens, U)[:, None, :]
                     & subsequent_mask(U, ys_in.device)[None])
        mem_mask = make_pad_mask(memory_lens, memory.shape[1])[:, None, :]
        for i in range(self.num_blocks):
            x = getattr(self, f"layer_{i}")(x, self_mask, memory, mem_mask)
        return dense(self.output_layer, layer_norm(self.after_norm, x))

    def forward_one_step(self, memory, memory_lens, ys, ys_lens):
        """Run the full prefix; log-probs (B, V) at position ys_lens - 1."""
        logits = self(memory, memory_lens, ys, ys_lens)
        idx = (ys_lens.long() - 1)[:, None, None].expand(-1, 1,
                                                          logits.shape[-1])
        return F.log_softmax(torch.gather(logits, 1, idx)[:, 0], dim=-1)


class BiTransformerDecoder(nn.Module):
    """Left (L2R) and right (R2L) decoders (``decoder: bitransformer``;
    ``decoder: transformer`` is this with ``r_num_blocks=0``)."""

    def __init__(self, vocab_size: int, encoder_output_size: int,
                 attention_heads: int = 8, linear_units: int = 2048,
                 num_blocks: int = 3, r_num_blocks: int = 3,
                 dropout_rate: float = 0.1,
                 positional_dropout_rate: float = 0.1,
                 self_attention_dropout_rate: float = 0.0,
                 src_attention_dropout_rate: float = 0.0,
                 with_right: bool = True):
        super().__init__()
        kw = dict(vocab_size=vocab_size,
                  encoder_output_size=encoder_output_size,
                  attention_heads=attention_heads, linear_units=linear_units,
                  dropout_rate=dropout_rate,
                  positional_dropout_rate=positional_dropout_rate,
                  self_attention_dropout_rate=self_attention_dropout_rate,
                  src_attention_dropout_rate=src_attention_dropout_rate)
        self.left_decoder = TransformerDecoder(num_blocks=num_blocks, **kw)
        self.right_decoder = (TransformerDecoder(num_blocks=r_num_blocks,
                                                 **kw)
                              if with_right else None)

    def forward(self, memory, memory_lens, ys_in, ys_lens, r_ys_in=None,
                reverse_weight: float = 0.0):
        """(left logits, right logits); the right decoder runs only when
        ``reverse_weight > 0``, over the reversed labels with the left
        lengths, else its logits are zeros."""
        l_x = self.left_decoder(memory, memory_lens, ys_in, ys_lens)
        r_x = torch.zeros_like(l_x)
        if reverse_weight > 0.0 and r_ys_in is not None:
            if self.right_decoder is None:
                raise ValueError("reverse_weight > 0 needs the right "
                                 "decoder, which a model with "
                                 "reverse_weight 0 does not build")
            r_x = self.right_decoder(memory, memory_lens, r_ys_in, ys_lens)
        return l_x, r_x

    def forward_one_step(self, memory, memory_lens, ys, ys_lens):
        return self.left_decoder.forward_one_step(memory, memory_lens, ys,
                                                  ys_lens)


def attention_loss(decoder: BiTransformerDecoder, enc, enc_lens, labels,
                   label_lens, sos: int, eos: int, reverse_weight: float,
                   lsm_weight: float, ignore_id: int,
                   normalize_length: bool):
    """The attention branch of the training loss (the JAX models'
    ``_att_loss``): label smoothing on the left decoder, plus
    ``reverse_weight`` x the right decoder's over the reversed labels
    (padded with 0 before <sos>/<eos> are added), with the left lengths + 1.
    Returns (loss, the left decoder's token accuracy)."""
    ys_in, ys_out = add_sos_eos(labels, label_lens, sos, eos, ignore_id)
    r_ys = reverse_pad_list(labels, label_lens, 0)
    r_ys_in, r_ys_out = add_sos_eos(r_ys, label_lens, sos, eos, ignore_id)
    l_logits, r_logits = decoder(enc, enc_lens, ys_in, label_lens + 1,
                                 r_ys_in, reverse_weight)
    loss = label_smoothing_loss(l_logits, ys_out, lsm_weight, ignore_id,
                                normalize_length)
    if reverse_weight > 0.0:
        loss_r = label_smoothing_loss(r_logits, r_ys_out, lsm_weight,
                                      ignore_id, normalize_length)
        loss = (1.0 - reverse_weight) * loss + reverse_weight * loss_r
    return loss, accuracy(l_logits, ys_out, ignore_id)
