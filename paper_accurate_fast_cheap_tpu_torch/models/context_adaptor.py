"""Context adaptor for deep biasing (port of the JAX
``models/context_adaptor.py``).

A BLSTM encodes each biasing phrase into one vector (``encode_cv``: the
last valid forward state beside the backward state at the first token);
cross-attention from a softmax-weighted sum of the last encoder taps
(``ConformerEncoder(return_layers=True)``) onto the phrase vectors gives a
bias sequence to add onto the encoder output.  The LSTMs are
``models/predictor.LSTMLayer``'s full-sequence form.  Submodules keep
flax's names (``embed``, ``cv_lstm_fwd``, ``cv_lstm_bwd``, ``cv_proj``,
``bias_attn``, ``combine_weights``, ``out_proj``).  JAX gives it no loss.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from paper_accurate_fast_cheap_tpu_torch.models.attention import (
    MultiHeadedAttention)
from paper_accurate_fast_cheap_tpu_torch.models.layers import dense
from paper_accurate_fast_cheap_tpu_torch.models.predictor import LSTMLayer


class ContextAdaptor(nn.Module):
    def __init__(self, vocab_size: int, d_model: int = 512,
                 embed_size: int = 256, heads: int = 4,
                 num_combine_layers: int = 3):
        super().__init__()
        self.embed_size = embed_size
        self.num_combine_layers = num_combine_layers
        self.embed = nn.Embedding(vocab_size, embed_size)
        self.cv_lstm_fwd = LSTMLayer(embed_size, embed_size)
        self.cv_lstm_bwd = LSTMLayer(embed_size, embed_size)
        self.cv_proj = nn.Linear(2 * embed_size, d_model)
        self.bias_attn = MultiHeadedAttention(heads, d_model)
        self.combine_weights = nn.Parameter(torch.ones(num_combine_layers))
        self.out_proj = nn.Linear(d_model, d_model)

    def reset_parameters_from(self, g: torch.Generator) -> None:
        nn.init.ones_(self.combine_weights)

    def encode_cv(self, cv_tokens: torch.Tensor, cv_lens: torch.Tensor):
        """cv_tokens (N, U) padded phrases -> (N, d_model)."""
        N, U = cv_tokens.shape
        emb = self.embed(cv_tokens.long())
        h0 = emb.new_zeros(N, self.embed_size, dtype=torch.float32)
        fwd = self.cv_lstm_fwd(emb, h0, h0)
        bwd = self.cv_lstm_bwd(emb.flip(1), h0, h0)
        idx = torch.clamp(cv_lens.to(emb.device).long() - 1, 0, U - 1)
        f_last = fwd[torch.arange(N, device=emb.device), idx]
        return dense(self.cv_proj, torch.cat([f_last, bwd[:, -1]], dim=-1))

    def combine_layers(self, layer_outs: Sequence[torch.Tensor]):
        """Softmax-weighted sum of the last ``num_combine_layers`` taps."""
        taps = layer_outs[-self.num_combine_layers:]
        w = torch.softmax(self.combine_weights[:len(taps)], dim=0)
        return sum(wi * t for wi, t in zip(w, taps))

    def forward(self, layer_outs: Sequence[torch.Tensor],
                cv_tokens: torch.Tensor, cv_lens: torch.Tensor):
        """The bias sequence (B, T, d_model) to add onto the encoder
        output."""
        combined = self.combine_layers(layer_outs)
        cv = self.encode_cv(cv_tokens, cv_lens)
        cv_b = cv[None].expand(combined.shape[0], -1, -1)
        return dense(self.out_proj, self.bias_attn(combined, cv_b))
