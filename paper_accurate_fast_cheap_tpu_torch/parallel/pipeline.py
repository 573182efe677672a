"""Pipeline parallelism: the GPipe microbatched stage pipeline (port of the
JAX ``parallel/pipeline.py``).

Stage s of the mesh axis runs its slice of a homogeneous layer stack; M
microbatches flow stage to stage over M + S - 1 ticks with one ppermute
forward a tick (none after the last, whose result no stage would read),
and the last stage's output reaches every rank through a
psum at each tick it emits (a drop-in for the sequential stack; the bubble
is (S - 1) / (M + S - 1)).  Each rank passes only its own stage's
parameters (JAX passes the stacked tree sharded over the axis;
:func:`own_stage` takes a rank's slice from a :func:`stack_stage_params`
tree).

Differentiable end to end: the ppermute's transpose is the inverse
permutation and the psum's the identity, and the replicated input enters
through ``pvary`` (its gradient is summed over the stages), so autograd
through :func:`pipeline_apply` is the GPipe backward schedule.  Every rank
selects its input and emission with ``collectives.where_rank``, so every
rank's graph holds the same collectives.  Exactness contract: equals the
sequential ``for s: x = fn(params[s], x)`` loop.
"""
from __future__ import annotations

import torch

from paper_accurate_fast_cheap_tpu_torch.parallel import collectives as cc


def _tree_map(fn, *trees):
    """``fn`` over the tensor leaves of nested dicts, lists and tuples."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(_tree_map(fn, *xs) for xs in zip(*trees))
    return None if t0 is None else fn(*trees)


def stack_stage_params(param_list):
    """Stack a list of per-stage parameter trees on a new leading axis."""
    return _tree_map(lambda *xs: torch.stack(xs), *param_list)


def own_stage(stacked, axis: str = "stage"):
    """This rank's stage slice of a :func:`stack_stage_params` tree."""
    i = cc.axis_index(axis)
    return _tree_map(lambda a: a[i], stacked)


def pipeline_apply(fn, stage_params, x: torch.Tensor, mesh,
                   axis: str = "stage", n_microbatches: int = None,
                   extra=None) -> torch.Tensor:
    """Run ``x`` through the S stages of ``fn`` pipelined over ``mesh``'s
    axis ``axis``.

    fn: (this stage's params, x_mb[, extra_mb]) -> y_mb of x_mb's shape.
    stage_params: this rank's stage's parameters (anything ``fn`` takes).
    x: (B, ...), the same on every rank; split into M microbatches on the
        leading axis (M = ``n_microbatches``, default S).
    extra: optional tree of per-sample side inputs (masks, lengths: leaves
        with leading dim B), microbatched beside ``x`` and handed to each
        stage for the microbatch it works on.
    Returns the (B, ...) output, the same on every rank."""
    with mesh:
        S = cc.axis_size(axis)
        idx = cc.axis_index(axis)
        M = n_microbatches or S
        B = x.shape[0]
        if B % M:
            raise ValueError(f"batch {B} not divisible by {M} microbatches")
        mb = B // M
        x_mb = cc.pvary(x, axis).reshape((M, mb) + x.shape[1:])
        extra_mb = _tree_map(lambda a: a.reshape((M, mb) + a.shape[1:]),
                             extra)
        fwd = [(i, (i + 1) % S) for i in range(S)]
        recv = torch.zeros_like(x_mb[0])
        outs = []
        for t in range(M + S - 1):
            # stage 0 ingests microbatch t (clamped); stage s works on
            # microbatch t - s, whose side inputs it selects (clamped)
            inp = cc.where_rank(idx == 0, x_mb[min(t, M - 1)], recv)
            if extra is None:
                out = fn(stage_params, inp)
            else:
                mb_id = min(max(t - idx, 0), M - 1)
                out = fn(stage_params, inp,
                         _tree_map(lambda a: a[mb_id], extra_mb))
            # the last stage emits microbatch t - (S - 1) at tick t
            if t >= S - 1:
                outs.append(cc.psum(
                    cc.where_rank(idx == S - 1, out, torch.zeros_like(out)),
                    axis))
            if t < M + S - 2:
                recv = cc.ppermute(out, axis, fwd)
    return torch.stack(outs).reshape((B,) + x.shape[1:])
