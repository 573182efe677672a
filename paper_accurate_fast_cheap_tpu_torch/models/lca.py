"""Limited-context attention (LCA) with global tokens (port of the JAX
``models/lca.py``): sliding-window rel-pos attention with context
(left, right) plus global tokens that attend everywhere and are attended
by everyone; rel-pos scores without rel_shift, as the encoder's
``rel_selfattn``.

The keys and values are gathered into per-block banded contexts: with W =
max(left, right) and T padded to a multiple of W, each query block of W
attends its [prev, self, next] key blocks (3W keys), masked to relative
offsets in [-left, right] and to valid keys.  Global keys leave the band
and get their own score columns; global queries attend the whole valid
sequence and overwrite their rows.  As in the rel-pos MHA
(``models/attention.py``), the content and positional terms are one
product over ``[q+u, q+v] · [k, p]``, here with the global keys appended
to every block's band so the band and the global columns are one product
and one softmax too.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from paper_accurate_fast_cheap_tpu_torch.models.attention import (
    NEG_INF, RelPositionMultiHeadedAttention, masked_softmax)
from paper_accurate_fast_cheap_tpu_torch.models.layers import dense


def _banded_context(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Blocks along ``dim`` -> [prev, self, next] concatenated along
    ``dim + 1`` (zeros past either end)."""
    zero = torch.zeros_like(x.narrow(dim, 0, 1))
    n = x.shape[dim]
    prev = torch.cat([zero, x.narrow(dim, 0, n - 1)], dim)
    nxt = torch.cat([x.narrow(dim, 1, n - 1), zero], dim)
    return torch.cat([prev, x, nxt], dim + 1)


class LimitedRelPositionAttention(RelPositionMultiHeadedAttention):
    """Sliding-window rel-pos attention + global tokens (the parameters of
    ``RelPositionMultiHeadedAttention``)."""

    def __init__(self, heads: int, d_model: int, dropout_rate: float = 0.0,
                 key_bias: bool = True,
                 context_size: Sequence[int] = (256, 256),
                 global_tokens: int = 0, global_tokens_spacing: int = 1):
        super().__init__(heads, d_model, dropout_rate, key_bias)
        self.context_size = tuple(int(c) for c in context_size)
        self.global_tokens = int(global_tokens)
        self.global_tokens_spacing = int(global_tokens_spacing)

    def forward(self, x_q: torch.Tensor, x_kv: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                pos_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        left, right = self.context_size
        W = max(left, right)
        B, T, _ = x_q.shape
        H, Dk = self.heads, self.d_k
        q, k, v = self._qkv(x_q, x_kv)                    # (B, T, H, Dk)
        dev = q.device
        # 1 / sqrt(Dk) with sqrt(Dk) in q's dtype, as the JAX module
        scale = 1.0 / torch.sqrt(torch.tensor(float(Dk))).to(q.dtype)
        if pos_emb is not None:
            p = dense(self.linear_pos, pos_emb).reshape(
                -1, pos_emb.shape[1], H, Dk).to(q.dtype).expand(B, T, H, Dk)
        else:
            p = torch.zeros_like(k)
        # [q+u, q+v] against [k, p]: (B, H, T, 2 Dk)
        qc = torch.cat([q + self.pos_bias_u, q + self.pos_bias_v],
                       dim=-1).transpose(1, 2)
        kc = torch.cat([k, p], dim=-1).transpose(1, 2)
        vT = v.transpose(1, 2)                            # (B, H, T, Dk)
        if mask is None:
            valid = torch.ones(B, T, dtype=torch.bool, device=dev)
        else:
            valid = mask[:, 0, :] if mask.ndim == 3 else mask

        pad = (-T) % W
        Tp = T + pad
        NB = Tp // W

        def blockify(a):  # (B, H, T, D) -> (B, H, NB, W, D)
            return F.pad(a, (0, 0, 0, pad)).reshape(B, H, NB, W, a.shape[-1])

        qb = blockify(qc)
        kb = _banded_context(blockify(kc), 2)             # (B, H, NB, 3W, 2Dk)
        vb = _banded_context(blockify(vT), 2)
        valid_p = F.pad(valid, (0, pad))
        keep = _banded_context(valid_p.reshape(B, NB, W), 1)[:, None, :,
                                                             None, :]
        # relative offset of key (block offset) - query in [-left, right]
        rel = (torch.arange(3 * W, device=dev)[None, :] - W
               - torch.arange(W, device=dev)[:, None])
        keep = keep & ((rel >= -left) & (rel <= right))   # (B, 1, NB, W, 3W)

        G = self.global_tokens
        if G > 0:
            last = (G - 1) * self.global_tokens_spacing
            if last >= T:
                raise ValueError(f"global token index {last} is past the {T} "
                                 "frames (JAX clamps such a gather)")
            g_idx = torch.arange(G, device=dev) * self.global_tokens_spacing
            # global keys leave the band (they get their own columns)
            is_global = torch.zeros(Tp, dtype=torch.bool, device=dev)
            is_global[g_idx] = True
            keep = keep & ~_banded_context(is_global.reshape(NB, W),
                                           0)[:, None, :]
            # the global keys and values appended to every block's band
            kb = torch.cat([kb, kc[:, :, None, g_idx].expand(
                B, H, NB, G, 2 * Dk)], dim=3)
            vb = torch.cat([vb, vT[:, :, None, g_idx].expand(
                B, H, NB, G, Dk)], dim=3)
            keep = torch.cat([keep.expand(B, 1, NB, W, 3 * W),
                              valid[:, g_idx][:, None, None, None, :].expand(
                                  B, 1, NB, W, G)], dim=-1)
        scores = torch.matmul(qb, kb.transpose(-1, -2)).mul_(scale)
        # probabilities are zeroed where the logit was filled (JAX tests
        # all_scores > NEG_INF / 2: the same set), so a query whose band
        # holds no valid key gives zeros
        probs = self.attn_dropout(masked_softmax(scores, keep))
        out = torch.matmul(probs, vb).reshape(B, H, Tp, Dk)[:, :, :T]

        if G > 0:
            # global queries attend the whole valid sequence (no zeroing
            # after their softmax, as in JAX)
            sg = torch.matmul(qc[:, :, g_idx], kc.transpose(-1, -2)).mul_(
                scale)
            sg = sg.masked_fill_(~valid[:, None, None, :], NEG_INF)
            pg = self.attn_dropout(torch.softmax(sg, dim=-1))
            out = out.index_copy(2, g_idx, torch.matmul(pg, vT))
        out = out.transpose(1, 2).reshape(B, T, self.d_model)
        return dense(self.linear_out, out)
