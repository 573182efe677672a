"""The collectives of the port's parallel forms, differentiable, on
``torch.distributed``: the one place where tensors cross between ranks.

The JAX package writes its parallel bodies inside ``shard_map`` with
``jax.lax.all_gather``, ``ppermute`` and ``psum``; here each rank runs the
body on its own shard and these functions stand in for those ops.  An axis
is named, as in JAX: :class:`Axis` holds its size, this rank's index on it,
the global ranks along it and their process group, and the innermost
active mesh (``parallel/mesh.Mesh`` as a context manager) resolves a name
when the op runs; its backward keeps that axis.

Gradients follow one convention: the global objective is the sum of the
ranks' own objectives, where a value every rank holds alike (the result of
:func:`psum`) enters once.  Each op is a ``torch.autograd.Function`` whose
backward is its transpose under that convention:

* :func:`all_gather`: every rank receives every shard; the transpose sums,
  over the ranks, each rank's cotangent of this rank's slice (a psum, then
  the own slice: a reduce-scatter).
* :func:`ppermute`: a static permutation of (source, destination) axis
  indices, sent with ``dist.batch_isend_irecv``; a rank that receives
  nothing gets zeros; the transpose is the inverse permutation.
* :func:`psum`: the sum over the axis, which every rank then holds alike;
  the transpose is the identity (each rank's cotangent of the shared sum is
  the whole cotangent).
* :func:`pvary`: the identity on a value every rank holds alike that enters
  a computation that differs by rank (JAX's cast to varying); the transpose
  is a psum.

Backends: ``nccl`` moves CUDA tensors in place.  ``gloo`` has no CUDA path
for send and receive, so under gloo every collective on a CUDA tensor
copies it to the host, runs there and copies the result back; the copy is
chosen by the backend, never by catching an error, and is counted.

``COUNTS`` holds plain integers per op: calls and the bytes of this rank's
payload (the local tensor for all_gather and psum, what it sends for
ppermute, backward calls included), and under gloo the host copies and
their bytes (both directions).  :func:`reset_counts` zeroes them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

COUNTS: Dict[str, Dict[str, int]] = {
    op: {"calls": 0, "bytes": 0}
    for op in ("all_gather", "ppermute", "psum", "host_copy")}

# the active meshes, innermost last (parallel/mesh.Mesh pushes itself)
_ACTIVE: List = []


def reset_counts() -> None:
    for c in COUNTS.values():
        c["calls"] = c["bytes"] = 0


def read_counts() -> Dict[str, Dict[str, int]]:
    return {op: dict(c) for op, c in COUNTS.items()}


@dataclass(frozen=True)
class Axis:
    """One named mesh axis as this rank sees it: ``ranks`` are the global
    ranks along the axis (index order), ``group`` their process group
    (None for an axis of size 1, where every op is local)."""
    name: str
    size: int
    index: int
    ranks: Tuple[int, ...]
    group: Optional[object]
    backend: Optional[str]


def axis(name: str) -> Axis:
    """The axis ``name`` of the innermost active mesh that has it."""
    for mesh in reversed(_ACTIVE):
        if name in mesh.axes:
            return mesh.axes[name]
    raise ValueError(f"no active mesh has an axis {name!r} (enter a "
                     "parallel.mesh.Mesh first)")


def axis_size(name: str) -> int:
    return axis(name).size


def axis_index(name: str) -> int:
    return axis(name).index


def _count(op: str, t: torch.Tensor) -> None:
    COUNTS[op]["calls"] += 1
    COUNTS[op]["bytes"] += t.numel() * t.element_size()


def _staged(ax: Axis, t: torch.Tensor) -> bool:
    """Whether a collective on ``t`` runs on a host copy: gloo and a CUDA
    tensor."""
    return ax.backend == "gloo" and t.is_cuda


def _to_host(ax: Axis, t: torch.Tensor) -> torch.Tensor:
    if not _staged(ax, t):
        return t.contiguous()
    _count("host_copy", t)
    return t.detach().cpu()


def _back(ax: Axis, t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if not _staged(ax, like):
        return t
    _count("host_copy", t)
    return t.to(like.device)


def _psum(ax: Axis, x: torch.Tensor) -> torch.Tensor:
    _count("psum", x)
    if ax.size == 1:
        return x.clone()
    h = _to_host(ax, x) if _staged(ax, x) else x.detach().clone()
    dist.all_reduce(h, op=dist.ReduceOp.SUM, group=ax.group)
    return _back(ax, h, x)


def _gather(ax: Axis, x: torch.Tensor) -> torch.Tensor:
    """(n, *x.shape): every rank's ``x`` in axis order."""
    _count("all_gather", x)
    if ax.size == 1:
        return x[None].clone()
    h = _to_host(ax, x)
    parts = [torch.empty_like(h) for _ in range(ax.size)]
    dist.all_gather(parts, h, group=ax.group)
    return _back(ax, torch.stack(parts), x)


def _permute(ax: Axis, x: torch.Tensor,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    me = ax.index
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    h = _to_host(ax, x)
    out = torch.zeros_like(h)
    ops = []
    if dst:
        _count("ppermute", x)
        if dst[0] == me:
            out.copy_(h)
        else:
            ops.append(dist.P2POp(dist.isend, h, ax.ranks[dst[0]],
                                  ax.group))
    if src and src[0] != me:
        ops.append(dist.P2POp(dist.irecv, out, ax.ranks[src[0]], ax.group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return _back(ax, out, x)


def _check_perm(perm, n: int) -> Tuple[Tuple[int, int], ...]:
    perm = tuple((int(s), int(d)) for s, d in perm)
    srcs, dsts = [s for s, _ in perm], [d for _, d in perm]
    if (len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts)
            or not all(0 <= i < n for i in srcs + dsts)):
        raise ValueError(f"ppermute: {perm} is not a permutation of axis "
                         f"indices 0..{n - 1}")
    return perm


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, name):
        ctx.ax = axis(name)
        return _gather(ctx.ax, x)

    @staticmethod
    def backward(ctx, g):
        return _psum(ctx.ax, g.contiguous())[ctx.ax.index], None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, name, perm):
        ctx.ax, ctx.perm = axis(name), perm
        return _permute(ctx.ax, x, perm)

    @staticmethod
    def backward(ctx, g):
        inverse = tuple((d, s) for s, d in ctx.perm)
        return _permute(ctx.ax, g.contiguous(), inverse), None, None


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, name):
        return _psum(axis(name), x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _PVary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, name):
        ctx.ax = axis(name)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _psum(ctx.ax, g.contiguous()), None


def all_gather(x: torch.Tensor, name: str, dim: int = 0,
               tiled: bool = False) -> torch.Tensor:
    """Every rank's ``x`` along axis ``name``: stacked on a new ``dim``
    (JAX's default) or, with ``tiled``, concatenated along ``dim``."""
    y = _AllGather.apply(x, name)                 # (n, *x.shape)
    if tiled:
        y = torch.cat(y.unbind(0), dim=dim)
    elif dim:
        y = torch.movedim(y, 0, dim)
    return y


def ppermute(x: torch.Tensor, name: str,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """``x`` sent from axis index s to d for each (s, d) in ``perm``;
    zeros where no one sends."""
    return _PPermute.apply(x, name, _check_perm(perm, axis_size(name)))


def where_rank(cond: bool, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a`` where this rank's ``cond`` holds, else ``b``, both kept in the
    autograd graph: a branch on the rank would leave a collective out of
    some ranks' backward, and a collective every rank does not reach
    hangs the others."""
    return torch.where(torch.tensor(cond, device=a.device), a, b)


def gather_replicated(x: torch.Tensor, name: str, dim: int = -1
                      ) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim``, for a consumer that
    every rank repeats alike (a vocab head's logits under tp): each rank
    places its slice in its slot of zeros and one :func:`psum` fills the
    rest, so the transpose hands each rank its own slot's cotangent."""
    slots = [torch.zeros_like(x)] * axis_size(name)
    slots[axis_index(name)] = x
    return psum(torch.cat(slots, dim=dim), name)


def psum(x: torch.Tensor, name: str) -> torch.Tensor:
    return _PSum.apply(x, name)


def psum_tree(tensors: Dict[str, torch.Tensor], name: str
              ) -> Dict[str, torch.Tensor]:
    """:func:`psum` of many tensors of one dtype through one flat buffer
    (gradients between the ranks of a data or stage axis)."""
    names = list(tensors)
    flat = psum(torch.cat([tensors[n].reshape(-1) for n in names]), name)
    out, i = {}, 0
    for n in names:
        t = tensors[n]
        out[n] = flat[i:i + t.numel()].view_as(t)
        i += t.numel()
    return out


def pvary(x: torch.Tensor, name: str) -> torch.Tensor:
    return _PVary.apply(x, name)
