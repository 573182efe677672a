"""Multi-head attention (port of ``MultiHeadedAttention`` of the JAX
``models/attention.py``; the rel-pos variants and the KV cache wait for
ROADMAP Queue 1 item 12 and streaming).

Plain tensor ops, not ``F.scaled_dot_product_attention``: masked logits are
filled with ``NEG_INF`` before the softmax and the masked probabilities are
set to 0 after it, so a fully masked row gives zeros (not a uniform
distribution), as the JAX module does.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from paper_accurate_fast_cheap_tpu_torch.models.layers import dense

NEG_INF = -1e10  # the fill of masked logits


class MultiHeadedAttention(nn.Module):
    """Scaled dot-product MHA.  ``forward(x_q, x_kv, mask)`` with ``mask`` a
    bool (B, 1, Tk) or (B, Tq, Tk) tensor, True where a query may attend."""

    def __init__(self, heads: int, d_model: int, dropout_rate: float = 0.0,
                 key_bias: bool = True):
        super().__init__()
        if d_model % heads:
            raise ValueError(f"d_model {d_model} not divisible by {heads} "
                             "heads")
        self.heads, self.d_model = heads, d_model
        self.d_k = d_model // heads
        self.linear_q = nn.Linear(d_model, d_model)
        self.linear_k = nn.Linear(d_model, d_model, bias=key_bias)
        self.linear_v = nn.Linear(d_model, d_model)
        self.linear_out = nn.Linear(d_model, d_model)
        self.attn_dropout = nn.Dropout(dropout_rate)

    def forward(self, x_q: torch.Tensor, x_kv: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, Tq, _ = x_q.shape
        Tk = x_kv.shape[1]
        q = dense(self.linear_q, x_q).reshape(B, Tq, self.heads, self.d_k)
        k = dense(self.linear_k, x_kv).reshape(B, Tk, self.heads, self.d_k)
        v = dense(self.linear_v, x_kv).reshape(B, Tk, self.heads, self.d_k)
        # the products in the promoted dtype, as jnp.einsum does (an f32
        # query over a bf16 memory runs in f32)
        dt = torch.promote_types(q.dtype, k.dtype)
        q, k, v = q.to(dt), k.to(dt), v.to(dt)
        # sqrt(d_k) in f32, then cast to q's dtype (as the JAX module)
        scale = torch.tensor(math.sqrt(self.d_k), dtype=torch.float32).to(
            q.dtype)
        scores = torch.einsum("bthd,bshd->bhts", q, k) / scale.to(q.device)
        m = None
        if mask is not None:
            m = mask[:, None]
            scores = scores.masked_fill(~m, NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        if m is not None:
            probs = probs.masked_fill(~m, 0.0)
        probs = self.attn_dropout(probs)
        out = torch.einsum("bhts,bshd->bthd", probs, v)
        return dense(self.linear_out, out.reshape(B, Tq, self.d_model))
