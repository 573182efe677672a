"""Mamba-2 block and its attention-signature wrapper (port of the JAX
``models/mamba.py``).

``Mamba2Block`` (expand 2, one group, d_conv 4: the JAX block's fields):
``in_proj`` (no bias) -> [z, x, B, C, dt]; one depthwise
causal ``conv1d`` (with bias) over (x, B, C) jointly, left-padded by
``d_conv - 1``, then silu; ``dt = softplus(dt + dt_bias)`` in f32; the SSD
(``ops/ssd.py``) with ``A = -exp(A_log)`` and the D skip; ``GatedRMSNorm``;
``out_proj`` (no bias).  dt and A are cast to the block input's dtype before
the SSD lifts them to f32, where the JAX block casts them.  The streaming
form carries ``{"conv": the last d_conv - 1 pre-activation conv inputs,
"ssd": the (B, H, N, P) SSD state}``.

``MambaAttention``: ``uni`` (one block, ``mamba_fwd``) or ``bi`` (the
average of ``mamba_fwd`` and ``mamba_bwd`` run on the valid-prefix-reversed
input, ``flip_padded``); streaming state for ``uni`` only.  The
initialisation draws from a ``torch.Generator`` with the JAX formulas
(``dt_bias`` so that softplus spans [dt_min, dt_max], ``A_log`` = log of a
uniform draw in [1, 16]); parity with JAX is held through converted
weights, not through the draws.

``spmd_axis`` (sequence parallelism, ``parallel/sequence.py``): on this
rank's T-shard the causal conv's ``d_conv - 1`` left frames come from the
previous shard (``halo_exchange``), the SSD runs through ``ssd_sp_body``
and ``bi``'s backward block through ``flip_sharded``; streaming state and
``lengths`` are refused, as in JAX.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from paper_accurate_fast_cheap_tpu_torch.models.layers import conv, dense
from paper_accurate_fast_cheap_tpu_torch.models.rwkv import flip_padded
from paper_accurate_fast_cheap_tpu_torch.ops import ssd as ssd_ops
from paper_accurate_fast_cheap_tpu_torch.parallel.sequence import (
    flip_sharded, halo_exchange, ssd_sp_body)


class GatedRMSNorm(nn.Module):
    """RMSNorm(x * silu(z)): the gate in x's dtype, the variance in f32,
    its rsqrt cast back to x's dtype, then the scale."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        x = x * F.silu(z)
        var = x.float().square().mean(dim=-1, keepdim=True)
        return (x * torch.rsqrt(var + self.eps).to(x.dtype)
                ) * self.weight.to(x.dtype)


# the JAX block's fixed fields (every YAML and caller uses these)
EXPAND, NGROUPS, D_CONV = 2, 1, 4
DT_MIN, DT_MAX, A_INIT_RANGE = 0.001, 0.1, (1.0, 16.0)


class Mamba2Block(nn.Module):
    def __init__(self, d_model: int, d_state: int = 128, headdim: int = 64,
                 chunk_size: int = 64, spmd_axis: Optional[str] = None):
        super().__init__()
        self.spmd_axis = spmd_axis
        self.d_inner = EXPAND * d_model
        self.headdim = headdim
        self.nheads = self.d_inner // headdim
        self.d_state, self.chunk_size = d_state, chunk_size
        gn = NGROUPS * d_state
        self.in_proj = nn.Linear(d_model, 2 * self.d_inner + 2 * gn
                                 + self.nheads, bias=False)
        conv_dim = self.d_inner + 2 * gn
        self.conv1d = nn.Conv1d(conv_dim, conv_dim, D_CONV, groups=conv_dim)
        H = self.nheads
        self.dt_bias = nn.Parameter(torch.zeros(H))
        self.A_log = nn.Parameter(torch.zeros(H))
        self.D = nn.Parameter(torch.ones(H))
        self.norm = GatedRMSNorm(self.d_inner)
        self.out_proj = nn.Linear(self.d_inner, d_model, bias=False)

    def reset_parameters_from(self, g: torch.Generator) -> None:
        H = self.nheads
        with torch.no_grad():
            u = torch.empty(H).uniform_(0.0, 1.0, generator=g)
            v = torch.exp(u * (math.log(DT_MAX) - math.log(DT_MIN))
                          + math.log(DT_MIN)).clamp(min=1e-4)
            self.dt_bias.copy_(v + torch.log(-torch.expm1(-v)))
            self.A_log.copy_(torch.log(torch.empty(H).uniform_(
                *A_INIT_RANGE, generator=g)))

    def forward(self, x: torch.Tensor, state: Optional[dict] = None,
                return_state: bool = False):
        """x: (B, T, d_model).  With ``return_state`` (or a ``state``) the
        conv takes the carried inputs in place of its left pad (zeros when
        ``state`` is None) and the SSD the carried state; returns (out,
        {"conv", "ssd"}) then."""
        Di, G, N, H = self.d_inner, NGROUPS, self.d_state, self.nheads
        Bt, T, _ = x.shape
        dt = x.dtype
        zxbcdt = dense(self.in_proj, x)
        z, xs, Bc, Cc, dtr = torch.split(
            zxbcdt, [Di, Di, G * N, G * N, H], dim=-1)

        conv_in = torch.cat([xs, Bc, Cc], dim=-1)
        streaming = return_state or state is not None
        new_state = {}
        K = D_CONV - 1
        if streaming and self.spmd_axis:
            raise ValueError("streaming state is per-chunk sequential: "
                             "incompatible with sequence parallelism")
        if self.spmd_axis:
            full = halo_exchange(conv_in, self.spmd_axis, K, 0)
        elif streaming:
            cache = (state["conv"].to(conv_in.dtype) if state is not None
                     else conv_in.new_zeros(Bt, K, conv_in.shape[-1]))
            full = torch.cat([cache, conv_in], dim=1)
            new_state["conv"] = full[:, full.shape[1] - K:]
        else:
            full = F.pad(conv_in, (0, 0, K, 0))
        c = F.silu(conv(self.conv1d, full.transpose(1, 2)).transpose(1, 2))
        xs, Bc, Cc = torch.split(c, [Di, G * N, G * N], dim=-1)

        dtv = dtr.float() + self.dt_bias
        dtv = torch.logaddexp(dtv, torch.zeros((), dtype=dtv.dtype,
                                               device=dtv.device))
        A = -torch.exp(self.A_log.float())
        args = (xs.reshape(Bt, T, H, self.headdim), dtv.to(dt), A.to(dt),
                Bc.reshape(Bt, T, G, N), Cc.reshape(Bt, T, G, N),
                self.D.to(dt))
        if self.spmd_axis:
            y = ssd_sp_body(*args, self.spmd_axis,
                            chunk_size=self.chunk_size)
        elif streaming:
            y, new_state["ssd"] = ssd_ops.ssd(
                *args, state=None if state is None else state["ssd"],
                chunk_size=self.chunk_size, return_state=True)
        else:
            y = ssd_ops.ssd(*args, chunk_size=self.chunk_size)
        y = self.norm(y.reshape(Bt, T, Di), z)
        out = dense(self.out_proj, y)
        return (out, new_state) if return_state else out


class MambaAttention(nn.Module):
    """Attention-signature wrapper: ``uni`` or ``bi`` Mamba-2."""

    def __init__(self, head_size: int, d_model: int, direction: str = "bi",
                 d_state: int = 128, chunk_size: int = 64,
                 spmd_axis: Optional[str] = None):
        super().__init__()
        if direction not in ("uni", "bi"):
            raise ValueError(f"unknown mamba direction {direction!r}")
        self.direction = direction
        self.spmd_axis = spmd_axis
        mk = lambda: Mamba2Block(d_model, d_state, head_size,  # noqa: E731
                                 chunk_size, spmd_axis)
        self.mamba_fwd = mk()
        if direction == "bi":
            self.mamba_bwd = mk()

    def forward(self, x: torch.Tensor, lengths=None, state=None,
                return_state: bool = False):
        if return_state or state is not None:
            if self.direction != "uni":
                raise ValueError("streaming state requires a causal (uni) "
                                 "mamba direction")
            return self.mamba_fwd(x, state=state, return_state=True)
        if self.direction == "uni":
            return self.mamba_fwd(x)
        if self.spmd_axis:
            if lengths is not None:
                raise ValueError("spmd_axis (sequence parallelism) requires "
                                 "full-length sequences (lengths=None)")
            flip = lambda t: flip_sharded(t, self.spmd_axis)  # noqa: E731
            return (self.mamba_fwd(x) + flip(self.mamba_bwd(flip(x)))) / 2
        y_rev = flip_padded(self.mamba_bwd(flip_padded(x, lengths)), lengths)
        return (self.mamba_fwd(x) + y_rev) / 2
