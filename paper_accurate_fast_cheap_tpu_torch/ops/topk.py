"""Exact top-k selections with fixed tie rules (no ``torch.topk``/``sort``,
whose tie order is unspecified).

* :func:`top_k_iter` -- k rounds of masked argmax: value descending, lowest
  index among equal values (``torch.argmax`` returns the first maximum).
* :func:`top_k_vocab` -- K5, the two-level vocab selection of the JAX
  package's ``decode/rnnt_search.py:top_k_vocab`` as a hand-written CUDA
  kernel (``csrc/topk.cu``, port of the TPU kernel
  ``ops/topk_pallas.py:_topk_kernel`` via ``top_k_vocab_pallas``): 128-wide
  chunk maxima, the top-k chunks (lowest chunk id on ties), then the top-k
  of the k*128 survivors gathered in ascending chunk order (lowest global
  index on ties).  The kernel selects by a threshold filter
  (``csrc/topk_filter.cuh``, shared with K4) whose result is bit-identical.
  For a CPU tensor it runs :func:`top_k_vocab_plain`, which is also the
  plain version of K2's and K4's selections.
* :func:`stable_top_k` -- ``jax.lax.top_k`` order (value descending, index
  ascending, no repeats) by pairwise ranks, for small last axes.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from paper_accurate_fast_cheap_tpu_torch.ops import cuda_lib

NEG_INF = float("-inf")
LANES = 128
# dynamic shared memory a selection block may take: the H100's 227 KB per
# block less 1 KB for the kernels' static shared arrays
SMEM_BYTES = 232448 - 1024
_ARGTYPES = ([ctypes.c_int] * 4 + [ctypes.c_void_p, ctypes.c_longlong]
             + [ctypes.c_void_p] * 3)


def top_k_iter(x: torch.Tensor, k: int):
    """Exact top-k over the last axis by k masked-argmax rounds."""
    vals, idxs = [], []
    for _ in range(k):
        i = torch.argmax(x, dim=-1, keepdim=True)
        vals.append(torch.gather(x, -1, i)[..., 0])
        idxs.append(i[..., 0].to(torch.int32))
        x = x.scatter(-1, i, NEG_INF)
    return torch.stack(vals, dim=-1), torch.stack(idxs, dim=-1)


def top_k_vocab_plain(x: torch.Tensor, k: int, chunk: int = 128):
    """Exact top-k over a vocab-sized last axis (two-level, see module
    docstring), in ``x``'s dtype.  Small axes, or k >= the chunk count,
    take the direct :func:`top_k_iter` path, as the JAX version does."""
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


def filter_capacity(V: int, k: int) -> int:
    """Most candidates the threshold filter of K4 and K5 gathers for a row
    (``csrc/topk_filter.cuh``): the columns of k thread groups, each 4 of
    every chunk its warp owns (8 warps), and never more than V."""
    G = -(-V // LANES)
    return min(V, k * 4 * -(-G // 8))


def select_smem_bytes(V: int, k: int) -> int:
    """Shared memory the two-level block selection takes for a row of V
    scores and k picks (``csrc/topk_select.cuh``: select_smem_floats; K2
    for k > 32): the row padded to Vp, the chunk maxima or the k*128
    survivors, then k picks (value, position) and k chunk ids."""
    Vp = -(-V // LANES) * LANES
    return 4 * (Vp + max(Vp // LANES, k * LANES) + 3 * k)


def filter_smem_bytes(V: int, k: int) -> int:
    """Shared memory K4 and K5 take (``csrc/topk_filter.cuh``:
    filter_smem_floats): the two-level selection's, which their rows short
    of k finite chunks run, or the row and the filter's candidate keys (8
    bytes each), whichever is larger."""
    Vp = -(-V // LANES) * LANES
    return max(select_smem_bytes(V, k), 4 * Vp + 8 * filter_capacity(V, k))


def check_select(what: str, V: int, k: int, smem=select_smem_bytes) -> None:
    """Raise unless a CUDA selection takes a row of V scores and k picks:
    1 <= k <= V, and ``smem(V, k)`` bytes (the row plus its scratch) fit
    shared memory."""
    if not 0 < k <= V:
        raise ValueError(f"{what}: k={k} outside 1..V={V}")
    if smem(V, k) > SMEM_BYTES:
        raise ValueError(f"{what}: a row of V={V} with k={k} does not fit "
                         f"the selection's {SMEM_BYTES} bytes of shared "
                         f"memory")


def top_k_vocab(x: torch.Tensor, k: int):
    """K5: exact top-k over the last axis of ``x`` (..., V), f32 or bf16.

    Returns ((..., k) f32 values, (..., k) int32 indices) with the
    selection and tie rules of :func:`top_k_vocab_plain`.  A CUDA tensor
    launches ``csrc/topk.cu`` (rows flattened, selected in f32) or raises;
    a CPU tensor runs :func:`top_k_vocab_plain`.
    """
    if x.device.type != "cuda":
        return top_k_vocab_plain(x, k)
    lead, V = x.shape[:-1], x.shape[-1]
    check_select("top_k_vocab", V, k, filter_smem_bytes)
    code = cuda_lib.dtype_code(x.dtype)
    xr = x.reshape(-1, V)
    if xr.stride(1) != 1:
        xr = xr.contiguous()
    R = xr.shape[0]
    vals = torch.empty(R, k, device=x.device, dtype=torch.float32)
    idx = torch.empty(R, k, device=x.device, dtype=torch.int32)
    fn = cuda_lib.entry("topk", "pafc_topk", _ARGTYPES)
    err = fn(code, R, V, k, xr.data_ptr(), xr.stride(0), vals.data_ptr(),
             idx.data_ptr(), cuda_lib.stream_ptr(x.device))
    cuda_lib.check(err, "topk")
    top_k_vocab.launches += 1
    return vals.reshape(*lead, k), idx.reshape(*lead, k)


top_k_vocab.launches = 0


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
