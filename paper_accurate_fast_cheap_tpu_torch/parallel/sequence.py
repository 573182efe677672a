"""Sequence parallelism for the WKV6 and SSD recurrences (port of the JAX
``parallel/sequence.py``).

The WKV state recurrence ``S_t = diag(d_t) S_{t-1} + k_t v_t^T`` is
associative in (decay product, state) pairs, so a T-shard is summarized by

    A_i = the product of its per-step decays   (B, H, N)
    B_i = its final state from a zero state     (B, H, N, N)

and the true incoming state of shard i is the exclusive fold of the pairs
of the shards before it.  Each rank of the sequence axis:

  1. summary pass: K1 on its shard from the zero state with the state out
     (``ops/wkv6_cuda.wkv6_cuda``); A_i from w with K1's decay clamp
     (``W_CLAMP = log(160/18)``);
  2. all-gathers the (A, B) pairs and folds the same exclusive prefix
     (n is small and static), taking its own entry S_i;
  3. replay: K1 on its shard from S_i.

So K1 runs twice a direction per block on every rank, and only the
(N, N) summaries cross between ranks: n * B * H * N * (N + 1) floats.
The ``*_body`` functions run on this rank's T-shard inside an active mesh
with the axis (the JAX bodies' ``shard_map``); the standalone wrappers
take the whole arrays on every rank, run the body on this rank's shard
and gather the output, which every rank then holds alike (their gradients
are the whole inputs' on every rank).  Every rank walks the same fold and
selects its own entry with ``collectives.where_rank``, so every rank's
autograd graph holds the same collectives in the same order.  The
parameters (``u``, ``A``, ``D``) are replicated; in the bodies their
gradients are this rank's share.
"""
from __future__ import annotations

from typing import Optional

import torch

from paper_accurate_fast_cheap_tpu_torch.ops import ssd as ssd_ops
from paper_accurate_fast_cheap_tpu_torch.ops.wkv6_cuda import (
    W_CLAMP, wkv6_cuda)
from paper_accurate_fast_cheap_tpu_torch.parallel import collectives as cc


def _check_divisible(T: int, axis: str) -> int:
    n = cc.axis_size(axis)
    if T % n:
        raise ValueError(f"T={T} not divisible by mesh axis {axis}={n}")
    return n


def _exclusive_fold(decay_all, S_all, state, axis: str, expand):
    """(S_mine, the state after the last shard): S after shard j =
    decay_j (expanded by ``expand``) * S before + S_all[j]."""
    S_in = state
    S_mine = S_in
    for j in range(cc.axis_size(axis)):
        S_in = expand(decay_all[j]) * S_in + S_all[j]
        S_mine = cc.where_rank(j < cc.axis_index(axis), S_in, S_mine)
    return S_mine, S_in


def _final_state(S_fin: torch.Tensor, axis: str) -> torch.Tensor:
    """The global final state, held alike by every rank: the last rank's
    fold through a psum."""
    last = cc.axis_index(axis) == cc.axis_size(axis) - 1
    return cc.psum(cc.where_rank(last, S_fin, torch.zeros_like(S_fin)), axis)


def wkv6_sp_body(r, k, v, w, u, axis: str, state=None,
                 return_state: bool = False):
    """The sequence-parallel WKV6 on this rank's T-shard (r, k, v, w (B,
    T_local, H, N)); ``u`` (H, N) and ``state`` (B, H, N, N) f32 are
    replicated.  Returns this shard's y (and the global final state)."""
    Bs, _, H, N = r.shape
    if state is None:
        state = r.new_zeros((Bs, H, N, N), dtype=torch.float32)
    else:
        state = cc.pvary(state.float(), axis)
    # 1. summary pass from the zero state (state=None)
    _, B_loc = wkv6_cuda(r, k, v, w, u, return_state=True)
    A_loc = torch.exp(-torch.sum(torch.exp(
        torch.clamp(w.float(), max=W_CLAMP)), dim=1))      # (B, H, N)
    # 2. gather the pairs, fold the exclusive prefix
    A_all = cc.all_gather(A_loc, axis)                     # (n, B, H, N)
    B_all = cc.all_gather(B_loc, axis)                     # (n, B, H, N, N)
    S_mine, S_fin = _exclusive_fold(A_all, B_all, state, axis,
                                    lambda a: a[..., None])
    # 3. replay from the true incoming state
    y = wkv6_cuda(r, k, v, w, u, state=S_mine)
    return (y, _final_state(S_fin, axis)) if return_state else y


def _shard(x: torch.Tensor, axis: str, dim: int = 1) -> torch.Tensor:
    """This rank's T-shard of a tensor every rank holds whole."""
    n, i = cc.axis_size(axis), cc.axis_index(axis)
    size = x.shape[dim] // n
    return cc.pvary(x, axis).narrow(dim, i * size, size)


def wkv6_sequence_parallel(r, k, v, w, u, mesh, axis: str = "seq",
                           state: Optional[torch.Tensor] = None,
                           return_state: bool = False):
    """WKV6 with T sharded over ``mesh`` axis ``axis``: every rank passes
    the whole (B, T, H, N) inputs (T divisible by the axis size), runs the
    body on its shard and gets the whole y (and the final state)."""
    with mesh:
        _check_divisible(r.shape[1], axis)
        out = wkv6_sp_body(*(_shard(t, axis) for t in (r, k, v, w)),
                           cc.pvary(u, axis), axis, state=state,
                           return_state=return_state)
        y = out[0] if return_state else out
        y = cc.gather_replicated(y, axis, dim=1)
    return (y, out[1]) if return_state else y


def halo_exchange(x: torch.Tensor, axis: str, left: int, right: int,
                  time_axis: int = 1) -> torch.Tensor:
    """``x`` extended with ``left`` frames from the previous shard and
    ``right`` from the next (zeros at the sequence ends): the conv
    module's (k - 1) / 2 each side, the token shift's 1 on the left, the
    ds4 subsampling's 6 on the right."""
    n, idx = cc.axis_size(axis), cc.axis_index(axis)
    T = x.shape[time_axis]
    parts = []
    if left:
        tail = x.narrow(time_axis, T - left, left)
        prev = cc.ppermute(tail, axis, [(i, (i + 1) % n) for i in range(n)])
        parts.append(cc.where_rank(idx != 0, prev, torch.zeros_like(prev)))
    parts.append(x)
    if right:
        head = x.narrow(time_axis, 0, right)
        nxt = cc.ppermute(head, axis, [(i, (i - 1) % n) for i in range(n)])
        parts.append(cc.where_rank(idx != n - 1, nxt, torch.zeros_like(nxt)))
    return torch.cat(parts, dim=time_axis)


def flip_sharded(x: torch.Tensor, axis: str,
                 time_axis: int = 1) -> torch.Tensor:
    """Time-reverse a T-sharded tensor: the shard order reversed by one
    ppermute (i -> n - 1 - i), then a local flip."""
    n = cc.axis_size(axis)
    rev = cc.ppermute(x, axis, [(i, n - 1 - i) for i in range(n)])
    return torch.flip(rev, (time_axis,))


def ssd_sp_body(x, dt, A, B, C, D, axis: str, state=None,
                chunk_size: int = 64, return_state: bool = False):
    """The sequence-parallel Mamba-2 SSD on this rank's T-shard: the same
    summary algebra with the scalar decay exp(A * sum dt) per (batch,
    head).  Arguments as ``ops/ssd.ssd_chunked`` (x (Bt, T_local, H, P), dt
    after softplus); ``A``, ``D`` and ``state`` (Bt, H, N, P) replicated."""
    Bt, _, H, P = x.shape
    N = B.shape[3]
    if state is None:
        state = x.new_zeros((Bt, H, N, P), dtype=torch.float32)
    else:
        state = cc.pvary(state.float(), axis)
    # the summary's y is discarded: the plain chunked form under autograd
    _, S_loc = ssd_ops.ssd_chunked(x, dt, A, B, C, None,
                                   chunk_size=chunk_size, return_state=True)
    a_loc = torch.exp(A.float()[None] * torch.sum(dt.float(), dim=1))
    a_all = cc.all_gather(a_loc, axis)                    # (n, Bt, H)
    S_all = cc.all_gather(S_loc, axis)                    # (n, Bt, H, N, P)
    S_mine, S_fin = _exclusive_fold(a_all, S_all, state, axis,
                                    lambda a: a[..., None, None])
    y = ssd_ops.ssd_chunked_vjp(x, dt, A, B, C, D, state=S_mine,
                                chunk_size=chunk_size)
    return (y, _final_state(S_fin, axis)) if return_state else y


def ssd_sequence_parallel(x, dt, A, B, C, D, mesh, axis: str = "seq",
                          state=None, chunk_size: int = 64,
                          return_state: bool = False):
    """Standalone wrapper around :func:`ssd_sp_body`: whole arrays in on
    every rank, the whole y (and the final state) out."""
    with mesh:
        _check_divisible(x.shape[1], axis)
        out = ssd_sp_body(*(_shard(t, axis) for t in (x, dt)),
                          cc.pvary(A, axis),
                          *(_shard(t, axis) for t in (B, C)),
                          None if D is None else cc.pvary(D, axis), axis,
                          state=state, chunk_size=chunk_size,
                          return_state=return_state)
        y = out[0] if return_state else out
        y = cc.gather_replicated(y, axis, dim=1)
    return (y, out[1]) if return_state else y
