"""flax-like layer calls and initializers shared by the port's modules.

flax's ``Dense``/``Conv``/``LayerNorm`` compute in the promoted dtype of
their input and parameters (bf16 input with f32 weights runs in f32);
PyTorch's modules require one dtype.  :func:`dense`, :func:`conv` and
:func:`layer_norm` reproduce flax's promotion.  The initializers take an
explicit ``torch.Generator`` and follow flax's defaults (``lecun_normal``
kernels, zero biases, unit LayerNorm scales).
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


def _promote(x: torch.Tensor, w: torch.Tensor) -> torch.dtype:
    return torch.promote_types(x.dtype, w.dtype)


def dense(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``lin`` on ``x`` in the promoted dtype; a subclass of ``nn.Linear``
    with a forward of its own runs that."""
    if type(lin).forward is not nn.Linear.forward:
        return lin(x)
    dt = _promote(x, lin.weight)
    b = None if lin.bias is None else lin.bias.to(dt)
    return F.linear(x.to(dt), lin.weight.to(dt), b)


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    dt = _promote(x, ln.weight)
    return F.layer_norm(x.to(dt), ln.normalized_shape, ln.weight.to(dt),
                        ln.bias.to(dt), ln.eps)


def conv(c: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Apply an nn.Conv1d/Conv2d in the promoted dtype."""
    dt = _promote(x, c.weight)
    b = None if c.bias is None else c.bias.to(dt)
    fn = F.conv2d if isinstance(c, nn.Conv2d) else F.conv1d
    return fn(x.to(dt), c.weight.to(dt), b, c.stride, c.padding, c.dilation,
              c.groups)


def lecun_normal_(t: torch.Tensor, fan_in: int, g: torch.Generator):
    """flax ``lecun_normal``: truncated normal at +-2 std, variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    with torch.no_grad():
        u = torch.empty(t.shape).uniform_(2 * lo - 1, 1 - 2 * lo, generator=g)
        t.copy_(torch.erfinv(u) * (std * math.sqrt(2.0)))
    return t


def uniform_(t: torch.Tensor, lo: float, hi: float, g: torch.Generator):
    with torch.no_grad():
        t.copy_(torch.empty(t.shape).uniform_(lo, hi, generator=g))
    return t


def xavier_uniform_(t: torch.Tensor, g: torch.Generator):
    """flax ``xavier_uniform`` of a 2-D (fan_in, fan_out) parameter."""
    lim = math.sqrt(6.0 / (t.shape[0] + t.shape[1]))
    return uniform_(t, -lim, lim, g)


def normal_(t: torch.Tensor, std: float, g: torch.Generator):
    with torch.no_grad():
        t.copy_(torch.empty(t.shape).normal_(0.0, std, generator=g))
    return t


def orthogonal_(t: torch.Tensor, g: torch.Generator):
    """A (rows, cols) matrix with orthonormal rows or columns (QR of a
    Gaussian), as flax's ``orthogonal`` initializer."""
    rows, cols = t.shape
    a = torch.empty(max(rows, cols), min(rows, cols)).normal_(generator=g)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))[None, :]
    with torch.no_grad():
        t.copy_(q if rows >= cols else q.T)
    return t


def init_default(module: nn.Module, g: torch.Generator) -> None:
    """flax default init for the standard modules inside ``module``."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            lecun_normal_(m.weight, m.in_features, g)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, (nn.Conv1d, nn.Conv2d)):
            fan_in = m.weight.shape[1] * math.prod(m.weight.shape[2:])
            lecun_normal_(m.weight, fan_in, g)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
        elif isinstance(m, nn.Embedding):
            normal_(m.weight, 1.0 / math.sqrt(m.embedding_dim), g)
        reset = getattr(m, "reset_parameters_from", None)
        if reset is not None:
            reset(g)
