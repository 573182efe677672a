"""Training step: loss, gradients, clip and update (port of the JAX
``train/train_step.py``).

The optimizer is optax's chain written as plain functions on tensors:
``clip_by_global_norm`` -> ``scale_by_adam`` (eps outside the square root,
bias-corrected) -> ``add_decayed_weights`` (decoupled) ->
``scale_by_learning_rate`` (the schedule read at the optimizer's own count,
from 0).  ``torch.optim.Adam`` couples its weight decay into the gradient,
so it is not used.  Parameters are a dict of named tensors (a module's
``named_parameters``, bound into the module by ``bind_params``); the
step is functional: it returns new parameter and optimizer-state dicts.
A loss function binds its parameters into the model with ``bind_params``:
they stay in the module through the backward, where the checkpointed
recomputations (the RNN-T loss's joint chunks, the encoder's
``gradient_checkpointing``) read them; ``torch.func.functional_call``
restores the module's own tensors when the forward returns, so those
recomputations would read stale weights.

The skip rule keeps the parameters and the whole optimizer state, count
included, when the gradient norm is not finite or exceeds
``clip_hard_maxvalue``.  The decision reads the norm on the host (one
synchronisation per step), where the jitted JAX step selects on the device.
"""
from __future__ import annotations

import math
import re
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

Params = Dict[str, torch.Tensor]


class TrainState(NamedTuple):
    step: int
    params: Params
    opt_state: Dict[str, Any]


class Optimizer(NamedTuple):
    """optax's ``GradientTransformation``: ``init(params) -> state`` and
    ``update(grads, state, params) -> (updates, state)``."""
    init: Callable[[Params], Dict[str, Any]]
    update: Callable[..., Any]


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


def make_optimizer(optim: str = "adam", lr_schedule=None,
                   weight_decay: float = 0.0, grad_clip: float = 5.0,
                   betas=(0.9, 0.999), eps: float = 1e-8) -> Optimizer:
    """``adam`` (decoupled weight decay only when ``weight_decay``) or
    ``adamw`` (weight decay 0.01 unless given).  ``lr_schedule``: a float
    or a function of the optimizer's count."""
    if optim == "adam":
        wd = weight_decay
    elif optim == "adamw":
        wd = weight_decay if weight_decay else 0.01
    else:
        raise ValueError(f"unknown optimizer {optim!r}")
    if lr_schedule is None:
        raise ValueError("make_optimizer needs a learning rate or schedule")
    b1, b2 = betas

    def init(params: Params) -> Dict[str, Any]:
        zeros = lambda: {n: torch.zeros_like(p)  # noqa: E731
                         for n, p in params.items()}
        return {"count": 0, "mu": zeros(), "nu": zeros()}

    def update(grads: Params, state: Dict[str, Any], params: Params):
        names = list(grads)
        g = [grads[n] for n in names]
        if grad_clip and grad_clip > 0:
            gn = global_norm(g)
            factor = torch.where(gn < grad_clip, torch.ones_like(gn),
                                 grad_clip / gn)
            g = torch._foreach_mul(g, factor)
        count = state["count"] + 1
        mu = torch._foreach_mul([state["mu"][n] for n in names], b1)
        torch._foreach_add_(mu, g, alpha=1.0 - b1)
        nu = torch._foreach_mul([state["nu"][n] for n in names], b2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - b2)
        den = torch._foreach_sqrt(torch._foreach_div(nu, 1.0 - b2 ** count))
        torch._foreach_add_(den, eps)
        u = torch._foreach_div(torch._foreach_div(mu, 1.0 - b1 ** count), den)
        if wd:
            torch._foreach_add_(u, [params[n] for n in names], alpha=wd)
        lr = (lr_schedule(state["count"]) if callable(lr_schedule)
              else lr_schedule)
        torch._foreach_mul_(u, -lr)
        return dict(zip(names, u)), {
            "count": count, "mu": dict(zip(names, mu)),
            "nu": dict(zip(names, nu))}

    return Optimizer(init, update)


def bind_params(module: torch.nn.Module, params: Params) -> None:
    """Install ``params`` (parameter name -> tensor) in ``module``'s
    parameter slots in place of its own, until the next call."""
    for name, t in params.items():
        path, _, leaf = name.rpartition(".")
        (module.get_submodule(path) if path else module)._parameters[leaf] = t


def apply_updates(params: Params, updates: Params) -> Params:
    names = list(params)
    new = torch._foreach_add([params[n] for n in names],
                             [updates[n] for n in names])
    return dict(zip(names, new))


def restrict_learning_mask(names, exclude: Optional[str] = None,
                           include: Optional[str] = None) -> Dict[str, bool]:
    """Regex freezing over the port's parameter names: a parameter trains
    unless ``exclude`` matches it, or when ``include`` matches it."""
    mask = {}
    for name in names:
        train = True
        if exclude and re.search(exclude, name):
            train = False
        if include and re.search(include, name):
            train = True
        mask[name] = train
    return mask


def wrap_mixed_precision(loss_fn: Callable,
                         compute_dtype=torch.bfloat16) -> Callable:
    """bf16-compute mixed precision around ``loss_fn``: the f32 master
    weights are cast to ``compute_dtype`` for the forward and backward, so
    the gradients come back in f32 through the cast; the loss is upcast."""

    def mixed(params: Params, batch, seed: int):
        low = {n: p.to(compute_dtype) if p.dtype == torch.float32 else p
               for n, p in params.items()}
        loss, metrics = loss_fn(low, batch, seed)
        return loss.float(), metrics

    return mixed


def make_train_step(loss_fn: Callable, optimizer: Optimizer,
                    accum_steps: int = 1, clip_hard_maxvalue: float = 0.0,
                    trainable_mask: Optional[Dict[str, bool]] = None,
                    grad_sync: Optional[Callable] = None):
    """``loss_fn(params, batch, seed) -> (loss, metrics)``; with
    ``accum_steps > 1`` every batch tensor has a leading microbatch axis of
    that size, microbatch j gets the seed ``seed * accum_steps + j`` and the
    gradients are averaged.  ``grad_sync(grads, loss, metrics) -> (grads,
    loss, metrics)``, when given, combines the ranks' results before the
    skip rule, the clip and the update (``parallel/mesh.dp_sync``,
    ``parallel/pp_encoder.pp_grad_sync``), so every rank takes the same
    step.  Returns ``step(state, batch, seed, mark=None) -> (state, loss,
    metrics)``; ``mark(name)``, when given, is called after the forward
    (``"forward"``) and the backward (``"backward"``) of each microbatch and
    after the update (``"optimizer"``)."""

    def compute_grads(params: Params, batch, seed: int, mark):
        leaves = {n: p.detach().requires_grad_(True)
                  for n, p in params.items()}
        micro = ([batch] if accum_steps == 1 else
                 [tuple(x[j] for x in batch) for j in range(accum_steps)])
        total, losses, metrics = None, [], []
        for j, mb in enumerate(micro):
            loss, m = loss_fn(leaves, mb, seed * accum_steps + j)
            if mark:
                mark("forward")
            gs = torch.autograd.grad(loss, list(leaves.values()),
                                     allow_unused=True)
            gs = [torch.zeros_like(p) if g is None else g
                  for g, p in zip(gs, leaves.values())]
            total = gs if total is None else torch._foreach_add(total, gs)
            if mark:
                mark("backward")
            losses.append(loss.detach())
            metrics.append(m)
        if accum_steps > 1:
            torch._foreach_div_(total, float(accum_steps))
        metrics = {k: torch.stack([torch.as_tensor(m[k]) for m in metrics])
                   .float().mean() for k in metrics[0]}
        return (torch.stack(losses).mean(), metrics,
                dict(zip(leaves, total)))

    def step(state: TrainState, batch, seed: int, mark=None):
        loss, metrics, grads = compute_grads(state.params, batch, seed, mark)
        if grad_sync is not None:
            grads, loss, metrics = grad_sync(grads, loss, metrics)
        if trainable_mask is not None:
            grads = {n: g * float(trainable_mask[n]) for n, g in grads.items()}
        gnorm = global_norm(grads.values())
        g = float(gnorm)
        skip = not math.isfinite(g) or 0 < clip_hard_maxvalue < g
        if skip:
            params, opt_state = state.params, state.opt_state
        else:
            updates, opt_state = optimizer.update(grads, state.opt_state,
                                                  state.params)
            params = apply_updates(state.params, updates)
        if mark:
            mark("optimizer")
        metrics = dict(metrics, grad_norm=gnorm,
                       skipped=torch.tensor(float(skip)))
        return TrainState(state.step + 1, params, opt_state), loss, metrics

    return step


def init_train_state(params: Params, optimizer: Optimizer) -> TrainState:
    return TrainState(0, dict(params), optimizer.init(params))
