"""Exact top-k selections with fixed tie rules (no ``torch.topk``/``sort``,
whose tie order is unspecified).

* :func:`top_k_iter` -- k rounds of masked argmax: value descending, lowest
  index among equal values (``torch.argmax`` returns the first maximum).
* :func:`top_k_vocab` -- the two-level vocab selection of the JAX package's
  ``decode/rnnt_search.py:top_k_vocab``: 128-wide chunk maxima, the top-k
  chunks (lowest chunk id on ties), then the top-k of the k*128 survivors
  gathered in ascending chunk order (lowest global index on ties).  The
  plain version of the joint+top-k kernel's selection.
* :func:`stable_top_k` -- ``jax.lax.top_k`` order (value descending, index
  ascending, no repeats) by pairwise ranks, for small last axes.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = float("-inf")


def top_k_iter(x: torch.Tensor, k: int):
    """Exact top-k over the last axis by k masked-argmax rounds."""
    vals, idxs = [], []
    for _ in range(k):
        i = torch.argmax(x, dim=-1, keepdim=True)
        vals.append(torch.gather(x, -1, i)[..., 0])
        idxs.append(i[..., 0].to(torch.int32))
        x = x.scatter(-1, i, NEG_INF)
    return torch.stack(vals, dim=-1), torch.stack(idxs, dim=-1)


def top_k_vocab(x: torch.Tensor, k: int, chunk: int = 128):
    """Exact top-k over a vocab-sized last axis (two-level, see module
    docstring).  Small axes, or k >= the chunk count, take the direct
    :func:`top_k_iter` path, as the JAX version does."""
    V = x.shape[-1]
    G = (V + chunk - 1) // chunk
    if V <= 8 * chunk or k >= G:
        return top_k_iter(x, k)
    pad = G * chunk - V
    if pad:
        x = F.pad(x, (0, pad), value=NEG_INF)
    lead = x.shape[:-1]
    xc = x.reshape(*lead, G, chunk)
    _, gidx = top_k_iter(xc.amax(dim=-1), k)           # (..., k) chunk ids
    # ascending chunk ids => position order is global index order; sorting
    # integers, so equal keys are equal values and the order is fixed
    gidx = torch.sort(gidx.long(), dim=-1).values
    sel = torch.gather(xc, -2, gidx[..., None].expand(*lead, k, chunk))
    vals, loc = top_k_iter(sel.reshape(*lead, k * chunk), k)
    loc = loc.long()
    chunk_of = torch.gather(gidx, -1, loc // chunk)
    return vals, (chunk_of * chunk + loc % chunk).to(torch.int32)


def stable_top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: value descending, ties to the
    lower index, every index at most once.  O(n^2) pairwise ranks."""
    n = x.shape[-1]
    pos = torch.arange(n, device=x.device)
    xj, xi = x[..., :, None], x[..., None, :]
    before = (xj > xi) | ((xj == xi) & (pos[:, None] < pos[None, :]))
    rank = before.sum(dim=-2)                           # (..., n) in 0..n-1
    order = torch.empty_like(rank).scatter_(
        -1, rank, pos.expand_as(rank).contiguous())
    top = order[..., :k]
    return torch.gather(x, -1, top), top
