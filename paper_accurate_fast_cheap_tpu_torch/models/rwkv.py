"""RWKV-6 time-mix "recurrent attention" (port of the JAX ``models/rwkv.py``).

``RWKVTimeMix``: token-shift delta, data-dependent LoRA mixing (D_MIX=32)
for r/k/v/w, per-channel decay ``w = time_decay + tanh(w @ w1) @ w2``
(D_DECAY=64), bonus ``u = time_faaaa``, bias-free r/k/v projections, the
WKV recurrence (K1, ``ops/wkv6_cuda.py``), LayerNorm(dim_att) and the
output projection.  The layer-dependent init ramps are exact.

``RWKVAttention``: directions ``uni``, ``bi``, ``dirdrop`` and
``dirdrop_both``.  ``bi`` runs a second time-mix on the valid-prefix-reversed
input (``flip_padded``) and averages.  The direction-dropout variants drop
the R2L pass (``dirdrop``) or one random direction (``dirdrop_both``) in
``.train()``, one draw per call for the whole batch; in ``.eval()`` they
average both unless ``alt_decoding`` (even layers L2R, odd layers R2L) or
``bidirectional_layers`` (L2R alone outside the listed layers) says
otherwise.  ``wkv_impl`` and
``wkv_version`` are accepted so configs load, and do nothing: the kernel
wrapper always runs (its plain version on the CPU).

``spmd_axis`` (sequence parallelism, ``parallel/sequence.py``): the module
runs on this rank's T-shard inside an active mesh with that axis.  The
token shift's lead row comes from a 1-frame left halo, the WKV runs through
``wkv6_sp_body`` (K1's summary and replay passes) and the backward
direction through ``flip_sharded``; ``lengths`` are refused (full-length
sequences only), as in JAX.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from paper_accurate_fast_cheap_tpu_torch.models.layers import (
    dense, layer_norm, uniform_)
from paper_accurate_fast_cheap_tpu_torch.ops.wkv6_cuda import wkv6_cuda
from paper_accurate_fast_cheap_tpu_torch.parallel.sequence import (
    flip_sharded, halo_exchange, wkv6_sp_body)

D_MIX_LORA = 32
D_DECAY_LORA = 64
# direction dropout: P(drop R2L) for dirdrop, P(keep both) for dirdrop_both
DROP_PROB = 0.2
KEEP_BOTH_PROB = 0.8


def _tmix_ramps(layer_id: int, n_layers: int, n_embd: int, dim_att: int,
                n_head: int, head_size: int):
    """Layer-position-dependent init constants."""
    r01 = layer_id / max(n_layers - 1, 1)          # 0 -> 1
    r1a0 = 1.0 - layer_id / n_layers               # 1 -> ~0
    ddd = np.arange(n_embd, dtype=np.float64) / n_embd
    maa_x = 1.0 - np.power(ddd, r1a0)
    maa_r = 1.0 - np.power(ddd, 0.5 * r1a0)
    maa_k = 1.0 - np.power(ddd, r1a0)
    maa_v = 1.0 - (np.power(ddd, r1a0) + 0.3 * r01)
    maa_w = 1.0 - np.power(ddd, r1a0)
    n = np.arange(dim_att, dtype=np.float64)
    decay_speed = -6.0 + 5.0 * (n / (dim_att - 1)) ** (0.7 + 1.3 * r01)
    zigzag = ((n + 1) % 3 - 1) * 0.1
    faaaa = (r01 * (1.0 - n / (dim_att - 1)) + zigzag).reshape(
        n_head, head_size)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    return {
        "maa_x": f32(maa_x), "maa_r": f32(maa_r), "maa_k": f32(maa_k),
        "maa_v": f32(maa_v), "maa_w": f32(maa_w),
        "decay_speed": f32(decay_speed), "faaaa": f32(faaaa),
    }


class RWKVTimeMix(nn.Module):
    """RWKV-6c time-mix block: (B, T, C) -> (B, T, C)."""

    def __init__(self, head_size: int, n_layers: int, n_embd: int,
                 dim_att: int, layer_id: int = 0,
                 spmd_axis: Optional[str] = None):
        super().__init__()
        C, A = n_embd, dim_att
        self.spmd_axis = spmd_axis
        self.head_size = head_size
        self.n_head = A // head_size
        self._ramps = (layer_id, n_layers, C, A)
        P = lambda *s: nn.Parameter(torch.zeros(*s))  # noqa: E731
        self.time_maa_x, self.time_maa_r = P(C), P(C)
        self.time_maa_k, self.time_maa_v, self.time_maa_w = P(C), P(C), P(C)
        self.time_maa_rkvw_w1 = P(C, D_MIX_LORA * 4)
        self.time_maa_rkvw_w2 = P(4, D_MIX_LORA, C)
        self.time_decay = P(A)
        self.time_decay_w1 = P(C, D_DECAY_LORA)
        self.time_decay_w2 = P(D_DECAY_LORA, A)
        self.time_faaaa = P(self.n_head, head_size)
        self.receptance = nn.Linear(C, A, bias=False)
        self.key = nn.Linear(C, A, bias=False)
        self.value = nn.Linear(C, A, bias=False)
        self.ln_x = nn.LayerNorm(A, eps=1e-5)
        self.output = nn.Linear(A, C, bias=False)

    def reset_parameters_from(self, g: torch.Generator) -> None:
        layer_id, n_layers, C, A = self._ramps
        ramps = _tmix_ramps(layer_id, n_layers, C, A, self.n_head,
                            self.head_size)
        with torch.no_grad():
            for name in ("x", "r", "k", "v", "w"):
                getattr(self, f"time_maa_{name}").copy_(ramps[f"maa_{name}"])
            self.time_decay.copy_(ramps["decay_speed"])
            self.time_faaaa.copy_(ramps["faaaa"])
            self.time_maa_rkvw_w1.zero_()
            self.time_decay_w1.zero_()
        uniform_(self.time_maa_rkvw_w2, -0.01, 0.01, g)
        uniform_(self.time_decay_w2, -0.01, 0.01, g)

    def forward(self, x: torch.Tensor, state=None,
                return_state: bool = False):
        """x (B, T, C).  ``state`` (streaming): (x_prev (B, 1, C), the f32
        WKV state (B, H, N, N)); x_prev takes the token shift's zero row.
        With ``return_state`` returns (y, (x[:, -1:], the new WKV
        state)), the WKV state carried through K1."""
        B, T, _ = x.shape
        dt = x.dtype
        # token shift: xx_t = x_{t-1} - x_t (zero or carried at t=0)
        if state is not None:
            lead, wkv_state = state[0].to(dt), state[1]
        elif self.spmd_axis:
            lead = halo_exchange(x, self.spmd_axis, 1, 0)[:, :1]
            wkv_state = None
        else:
            lead, wkv_state = x.new_zeros(B, 1, x.shape[-1]), None
        xx = torch.cat([lead, x[:, :-1]], dim=1) - x
        xxx = x + xx * self.time_maa_x.to(dt)
        mix = torch.tanh(xxx @ self.time_maa_rkvw_w1.to(dt))
        mix = mix.reshape(B, T, 4, D_MIX_LORA)
        mr, mk, mv, mw = torch.einsum("btfm,fmc->fbtc", mix,
                                      self.time_maa_rkvw_w2.to(dt))
        xr = x + xx * (self.time_maa_r.to(dt) + mr)
        xk = x + xx * (self.time_maa_k.to(dt) + mk)
        xv = x + xx * (self.time_maa_v.to(dt) + mv)
        xw = x + xx * (self.time_maa_w.to(dt) + mw)
        r = dense(self.receptance, xr)
        k = dense(self.key, xk)
        v = dense(self.value, xv)
        w = self.time_decay.to(dt) + (
            torch.tanh(xw @ self.time_decay_w1.to(dt))
            @ self.time_decay_w2.to(dt))
        shp = (B, T, self.n_head, self.head_size)
        wkv = (functools.partial(wkv6_sp_body, axis=self.spmd_axis)
               if self.spmd_axis else wkv6_cuda)
        y = wkv(r.reshape(shp), k.reshape(shp), v.reshape(shp),
                w.to(r.dtype).reshape(shp), self.time_faaaa.to(r.dtype),
                state=wkv_state, return_state=return_state)
        if return_state:
            y, new_wkv = y
        y = layer_norm(self.ln_x, y.reshape(B, T, -1))
        y = dense(self.output, y)
        return (y, (x[:, -1:], new_wkv)) if return_state else y


def flip_padded(x: torch.Tensor, lengths: Optional[torch.Tensor]):
    """Reverse the valid prefix of each sequence; pad positions stay put."""
    if lengths is None:
        return torch.flip(x, (1,))
    T = x.shape[1]
    t = torch.arange(T, device=x.device)[None, :]
    ln = lengths.to(x.device)[:, None]
    idx = torch.where(t < ln, ln - 1 - t, t)
    return torch.gather(x, 1, idx[..., None].expand_as(x))


class RWKVAttention(nn.Module):
    """Directional wrapper: ``uni``, ``bi`` (average of the L2R pass and
    the R2L pass over the valid prefix), ``dirdrop`` or ``dirdrop_both``.

    Direction dropout draws from torch's default generator on the host (a
    Bernoulli shared by the batch: keep R2L with 1 - ``DROP_PROB``, or keep
    both with ``KEEP_BOTH_PROB`` and else a fair coin for the direction),
    so only the kept passes run; a dropped pass's parameters get no
    gradient (the training step counts them as zero)."""

    def __init__(self, head_size: int, dim_att: int, n_layers: int,
                 direction: str = "bi", layer_id: int = 0,
                 do_bfloat16: bool = True,
                 bidirectional_layers: Optional[Sequence[int]] = None,
                 alt_decoding: bool = False,
                 spmd_axis: Optional[str] = None):
        super().__init__()
        if direction not in ("uni", "bi", "dirdrop", "dirdrop_both"):
            raise ValueError(f"unknown rwkv direction: {direction!r}")
        self.direction = direction
        self.spmd_axis = spmd_axis
        self.layer_id = layer_id
        self.do_bfloat16 = do_bfloat16
        self.bidirectional_layers = (None if bidirectional_layers is None
                                     else tuple(bidirectional_layers))
        self.alt_decoding = alt_decoding
        mk = lambda: RWKVTimeMix(head_size, n_layers, dim_att, dim_att,  # noqa
                                 layer_id, spmd_axis)
        self.tmix = mk()
        if direction != "uni":
            self.tmix_rev = mk()

    def _passes(self):
        """Which passes run: (L2R, R2L)."""
        if self.direction == "bi":
            return True, True
        if self.training:
            if self.direction == "dirdrop":
                return True, bool(torch.rand(()) < 1.0 - DROP_PROB)
            if bool(torch.rand(()) < KEEP_BOTH_PROB):
                return True, True
            pick_fwd = bool(torch.rand(()) < 0.5)
            return pick_fwd, not pick_fwd
        if self.alt_decoding:
            return self.layer_id % 2 == 0, self.layer_id % 2 == 1
        if (self.bidirectional_layers is not None
                and self.layer_id not in self.bidirectional_layers):
            return True, False
        return True, True

    def forward(self, x: torch.Tensor, lengths=None, state=None,
                return_state: bool = False):
        """With ``return_state`` (``uni`` only: the other directions need
        the future) returns (y, the time-mix's streaming state)."""
        in_dtype = x.dtype
        if self.do_bfloat16:
            x = x.to(torch.bfloat16)
        if self.direction == "uni":
            if return_state:
                y, new_state = self.tmix(x, state=state, return_state=True)
                return y.to(in_dtype), new_state
            return self.tmix(x).to(in_dtype)
        if return_state:
            raise ValueError("streaming state requires direction='uni' "
                             "(bidirectional attention needs the full "
                             "future context)")
        l2r, r2l = self._passes()
        if l2r:
            y = self.tmix(x)
        if r2l and self.spmd_axis:
            if lengths is not None:
                raise ValueError("spmd_axis (sequence parallelism) requires "
                                 "full-length sequences (lengths=None)")
            flip = functools.partial(flip_sharded, axis=self.spmd_axis)
            y_rev = flip(self.tmix_rev(flip(x)))
            y = (y + y_rev) / 2 if l2r else y_rev
        elif r2l:
            y_rev = flip_padded(self.tmix_rev(flip_padded(x, lengths)),
                                lengths)
            y = (y + y_rev) / 2 if l2r else y_rev
        return y.to(in_dtype)
