"""Multi-head attention (port of the JAX ``models/attention.py``):
``MultiHeadedAttention`` (the decoder's attention and the encoder's
``selfattn``), ``RelPositionMultiHeadedAttention`` (the encoder's
``rel_selfattn``, WeNet's form: ``(q+u)kᵀ + (q+v)pᵀ`` over the absolute
sinusoids, no rel_shift) and ``ESPnetRelPositionMultiHeadedAttention``
(``espnet_rel_selfattn``: the same, with the rel_shift when ``pos_emb`` has
2T-1 rows).  ``selfattn`` and ``rel_selfattn`` take the streaming KV
cache (``cache``/``return_cache``): a fixed-size {"k", "v", "valid"} of the
last Tc keys and values, prepended to the chunk's, with "valid" as the key
mask.

Plain tensor ops, not ``F.scaled_dot_product_attention``: masked logits are
filled with ``NEG_INF`` before the softmax and the masked probabilities are
set to 0 after it, so a fully masked row gives zeros (not a uniform
distribution), as the JAX module does.  Every module takes
``forward(x_q, x_kv, mask=None, pos_emb=None)``; ``mask`` is a bool
(B, 1, Tk), (B, Tq, Tk) or (B, H, Tq, Tk) tensor, True where a query may
attend.

Memory: the rel-pos score is one product over the concatenated head width,
``[q+u, q+v] · [k, p]``, so no second (B, H, T, T) tensor holds the
positional term, and the fill, the scale and the zeroing of the masked
probabilities run in place where autograd allows.  The positional
projection is cast to the queries' dtype: under bf16 weights the scores
stay bf16 (JAX promotes them to f32 through the f32 sinusoids).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from paper_accurate_fast_cheap_tpu_torch.models.layers import (
    dense, xavier_uniform_)

NEG_INF = -1e10  # the fill of masked logits


def attention_mask(mask: torch.Tensor) -> torch.Tensor:
    """A (B, Tk) or (B, Tq, Tk) mask as (B, 1, ..., Tk) over the heads."""
    return mask[:, None] if mask.ndim == 3 else mask


def masked_softmax(scores: torch.Tensor,
                   keep: Optional[torch.Tensor]) -> torch.Tensor:
    """Softmax over the last axis with the JAX masking rule: logits where
    ``keep`` is False are filled with ``NEG_INF`` (in place: ``scores`` is
    consumed) and their probabilities set to 0 afterwards."""
    if keep is None:
        return torch.softmax(scores, dim=-1)
    drop = ~keep
    probs = torch.softmax(scores.masked_fill_(drop, NEG_INF), dim=-1)
    # the softmax's output is saved for its backward: zero out of place then
    return (probs.masked_fill(drop, 0.0) if probs.requires_grad
            else probs.masked_fill_(drop, 0.0))


class MultiHeadedAttention(nn.Module):
    """Scaled dot-product MHA; ``pos_emb`` is accepted and ignored."""

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

    def _qkv(self, x_q: torch.Tensor, x_kv: torch.Tensor):
        """q (B, Tq, H, d_k), k and v (B, Tk, H, d_k), in their promoted
        dtype, as jnp.einsum runs them (an f32 query over a bf16 memory
        runs in f32)."""
        B, Tq, _ = x_q.shape
        Tk = x_kv.shape[1]
        q = dense(self.linear_q, x_q).reshape(B, Tq, self.heads, self.d_k)
        k = dense(self.linear_k, x_kv).reshape(B, Tk, self.heads, self.d_k)
        v = dense(self.linear_v, x_kv).reshape(B, Tk, self.heads, self.d_k)
        dt = torch.promote_types(q.dtype, k.dtype)
        return q.to(dt), k.to(dt), v.to(dt)

    def _attend(self, scores: torch.Tensor, v: torch.Tensor,
                mask: Optional[torch.Tensor], return_probs: bool = False):
        """scores (B, H, Tq, Tk), unscaled (consumed) -> the output, and
        with ``return_probs`` the attention probabilities (B, H, Tq, Tk)
        it applied (zeros where masked)."""
        # sqrt(d_k) in f32, then cast to the scores' dtype (as the JAX
        # module)
        scale = torch.tensor(math.sqrt(self.d_k), dtype=torch.float32).to(
            scores.dtype)
        scores.div_(scale.to(scores.device))
        keep = None if mask is None else attention_mask(mask)
        probs = self.attn_dropout(masked_softmax(scores, keep))
        out = torch.einsum("bhts,bshd->bthd", probs, v)
        B, Tq = out.shape[:2]
        out = dense(self.linear_out, out.reshape(B, Tq, self.d_model))
        return (out, probs) if return_probs else out

    @staticmethod
    def _with_cache(k, v, cache):
        """Prepend the fixed-size KV cache {"k", "v", "valid"} (B, Tc, ...)
        to the chunk's keys and values; returns (k, v, key mask (B, 1, Tc+T),
        the new cache of the last Tc keys)."""
        B, T = k.shape[:2]
        Tc = cache["k"].shape[1]
        k = torch.cat([cache["k"].to(k.dtype), k], dim=1)
        v = torch.cat([cache["v"].to(v.dtype), v], dim=1)
        valid = torch.cat([cache["valid"], torch.ones(
            B, T, dtype=torch.bool, device=k.device)], dim=1)
        n = k.shape[1] - Tc
        return k, v, valid[:, None, :], {"k": k[:, n:], "v": v[:, n:],
                                         "valid": valid[:, n:]}

    def forward(self, x_q: torch.Tensor, x_kv: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                pos_emb: Optional[torch.Tensor] = None, cache=None,
                return_cache: bool = False, return_probs: bool = False):
        """The output; with ``return_cache`` also the new KV cache, with
        ``return_probs`` (no cache) the attention probabilities."""
        q, k, v = self._qkv(x_q, x_kv)
        if return_probs:
            return self._attend(torch.einsum("bthd,bshd->bhts", q, k), v,
                                mask, return_probs=True)
        new_cache = None
        if cache is not None:
            k, v, mask, new_cache = self._with_cache(k, v, cache)
        out = self._attend(torch.einsum("bthd,bshd->bhts", q, k), v, mask)
        return (out, new_cache) if return_cache else out


class RelPositionMultiHeadedAttention(MultiHeadedAttention):
    """Rel-pos MHA, WeNet's form: scores = (q+u)kᵀ + (q+v)pᵀ, no
    rel_shift; ``pos_bias_u`` and ``pos_bias_v`` are (H, d_k)."""

    def __init__(self, heads: int, d_model: int, dropout_rate: float = 0.0,
                 key_bias: bool = True):
        super().__init__(heads, d_model, dropout_rate, key_bias)
        self.linear_pos = nn.Linear(d_model, d_model, bias=False)
        self.pos_bias_u = nn.Parameter(torch.zeros(heads, self.d_k))
        self.pos_bias_v = nn.Parameter(torch.zeros(heads, self.d_k))

    def reset_parameters_from(self, g: torch.Generator) -> None:
        xavier_uniform_(self.pos_bias_u, g)
        xavier_uniform_(self.pos_bias_v, g)

    def _pos(self, pos_emb: torch.Tensor, dtype) -> torch.Tensor:
        """The projected positions (Np, H, d_k); ``pos_emb`` is (1, Np,
        d)."""
        Np = pos_emb.shape[1]
        return dense(self.linear_pos, pos_emb).reshape(
            Np, self.heads, self.d_k).to(dtype)

    def _rel_scores(self, q, k, p) -> torch.Tensor:
        """(q+u)kᵀ + (q+v)p[:Tk]ᵀ as one product over 2 d_k."""
        B, Tk = k.shape[:2]
        qc = torch.cat([q + self.pos_bias_u, q + self.pos_bias_v], dim=-1)
        kc = torch.cat([k, p[:Tk].expand(B, -1, -1, -1)], dim=-1)
        return torch.einsum("bthd,bshd->bhts", qc, kc)

    def forward(self, x_q: torch.Tensor, x_kv: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                pos_emb: Optional[torch.Tensor] = None, cache=None,
                return_cache: bool = False):
        """With a ``cache``, ``pos_emb`` covers the cache's and the
        chunk's key positions."""
        if pos_emb is None:
            raise ValueError("rel_pos attention needs pos_emb")
        q, k, v = self._qkv(x_q, x_kv)
        new_cache = None
        if cache is not None:
            k, v, mask, new_cache = self._with_cache(k, v, cache)
        scores = self._rel_scores(q, k, self._pos(pos_emb, q.dtype))
        out = self._attend(scores, v, mask)
        return (out, new_cache) if return_cache else out


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """(B, H, T, 2T-1) -> (B, H, T, T): out[..., i, j] = x[..., i, (T-1) +
    (j - i)]."""
    B, H, T, _ = x.shape
    x = F.pad(x, (1, 0)).reshape(B, H, 2 * T, T)
    return x[:, :, 1:].reshape(B, H, T, 2 * T - 1)[..., :T]


class ESPnetRelPositionMultiHeadedAttention(RelPositionMultiHeadedAttention):
    """ESPnet's rel-pos MHA: with ``pos_emb`` of 2T-1 rows (relative
    offsets -(T-1)..(T-1)) the positional term is rel-shifted so column j
    is offset j - i; with any other row count it is WeNet's form."""

    def forward(self, x_q: torch.Tensor, x_kv: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                pos_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        if pos_emb is None:
            raise ValueError("rel_pos attention needs pos_emb")
        q, k, v = self._qkv(x_q, x_kv)
        p = self._pos(pos_emb, q.dtype)
        if p.shape[0] != 2 * q.shape[1] - 1:
            return self._attend(self._rel_scores(q, k, p), v, mask)
        ac = torch.einsum("bthd,bshd->bhts", q + self.pos_bias_u, k)
        bd = rel_shift(torch.einsum("bthd,shd->bhts", q + self.pos_bias_v,
                                    p))
        return self._attend(ac + bd[..., :k.shape[1]], v, mask)
