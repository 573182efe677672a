"""Mamba-2 SSD (state-space dual): the chunked scan and its analytic
backward (port of the JAX ``ops/ssd.py``).

Recurrence per (batch, head), state ``S in R^{N x P}`` (N = d_state, P =
headdim), a_t = exp(dt_t * A) scalar per head-step (dt already softplus-ed,
A < 0 per head):

    S_t = a_t * S_{t-1} + dt_t b_t x_t^T
    y_t = C_t^T S_t + D * x_t

The JAX package computes it as XLA products over chunks (``lax.scan`` over
the chunks, no Pallas kernel), so the port's SSD is plain tensor ops: the
intra-chunk decay matrix ``exp(segsum)`` is exact at (L, L) because the decay
is scalar per (head, t), and a Python loop carries the state across chunks.
A hand-written chunked kernel is ``perf_opt`` work (ROADMAP Queue 1b).

``ssd(impl=)``: ``ref`` (the sequential oracle), ``chunked_ad`` (the chunked
form under autograd) and ``chunked`` (the default: the chunked form with the
analytic backward ``ssd_backward``, which saves the primal inputs only).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from paper_accurate_fast_cheap_tpu_torch.ops.common import as_f32, revcumsum


def _zeros_state(Bt, H, N, P, device):
    return torch.zeros(Bt, H, N, P, dtype=torch.float32, device=device)


def ssd_ref(x, dt, A, B, C, D=None, state=None, return_state=False):
    """Sequential oracle.  x: (Bt, T, H, P); dt: (Bt, T, H) (post-softplus);
    A: (H,) negative; B, C: (Bt, T, G, N), heads split evenly over the G
    groups; D: (H,) skip or None; state: (Bt, H, N, P)."""
    Bt, T, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    out_dtype = x.dtype
    xf, dtf, Af, Bf, Cf = as_f32(x, dt, A, B, C)
    rep = H // G
    Bh = torch.repeat_interleave(Bf, rep, dim=2)
    Ch = torch.repeat_interleave(Cf, rep, dim=2)
    a = torch.exp(dtf * Af[None, None, :])
    S = (_zeros_state(Bt, H, N, P, x.device) if state is None
         else state.to(torch.float32))
    ys = []
    for t in range(T):
        S = a[:, t, :, None, None] * S + torch.einsum(
            "bhn,bhp->bhnp", Bh[:, t] * dtf[:, t, :, None], xf[:, t])
        ys.append(torch.einsum("bhn,bhnp->bhp", Ch[:, t], S))
    y = (torch.stack(ys, 1) if ys
         else xf.new_zeros(Bt, 0, H, P))
    if D is not None:
        y = y + xf * D.to(torch.float32)[None, None, :, None]
    y = y.to(out_dtype)
    return (y, S) if return_state else y


def _segsum(la: torch.Tensor) -> torch.Tensor:
    """la: (..., L) per-step log decays -> (..., L, L) segment sums
    out[t, s] = sum_{tau=s+1..t} la_tau for t >= s, -inf above the diagonal
    (the cumulative-sum difference, as the JAX package computes it)."""
    L = la.shape[-1]
    cs = torch.cumsum(la, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones(L, L, dtype=torch.bool, device=la.device))
    return diff.masked_fill(~mask, float("-inf"))


def _pad_t(z: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero-pad axis 1 of a (B, T, ...) tensor by ``pad`` steps."""
    return F.pad(z, (0, 0) * (z.ndim - 2) + (0, pad)) if pad else z


def _chunks(z: torch.Tensor, NC: int, L: int) -> torch.Tensor:
    """(Bt, NC*L, H, d) -> (Bt, H, NC, L, d)."""
    Bt, _, H, d = z.shape
    return z.reshape(Bt, NC, L, H, d).permute(0, 3, 1, 2, 4)


def ssd_chunked(x, dt, A, B, C, D=None, state=None, chunk_size: int = 64,
                return_state: bool = False):
    """Chunked (matmul) SSD, the semantics of :func:`ssd_ref`.  T is padded
    to a multiple of the chunk with dt = 0, so a pad step neither decays
    the state nor feeds it."""
    Bt, T, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    out_dtype = x.dtype
    L = int(chunk_size)
    pad = (-T) % L
    xf, dtf, Af, Bf, Cf = as_f32(x, dt, A, B, C)
    xf, dtf, Bf, Cf = (_pad_t(z, pad) for z in (xf, dtf, Bf, Cf))
    NC = (T + pad) // L
    rep = H // G
    Bh = torch.repeat_interleave(Bf, rep, dim=2)
    Ch = torch.repeat_interleave(Cf, rep, dim=2)

    xc, bc, cc = _chunks(xf, NC, L), _chunks(Bh, NC, L), _chunks(Ch, NC, L)
    dtc = dtf.reshape(Bt, NC, L, H).permute(0, 3, 1, 2)    # (Bt,H,NC,L)
    la = dtc * Af[None, :, None, None]                      # log decay <= 0
    xdt = xc * dtc[..., None]                               # discretized in

    decay = torch.exp(_segsum(la))                          # (Bt,H,NC,L,L)
    cb = torch.einsum("bhctn,bhcsn->bhcts", cc, bc)
    y_intra = torch.einsum("bhcts,bhcsp->bhctp", cb * decay, xdt)

    Lcum = torch.cumsum(la, dim=-1)                         # inclusive
    c_in = cc * torch.exp(Lcum)[..., None]                  # decay from start
    b_tail = bc * torch.exp(Lcum[..., -1:] - Lcum)[..., None]
    S = (_zeros_state(Bt, H, N, P, x.device) if state is None
         else state.to(torch.float32))
    y_cross = []
    for c in range(NC):
        y_cross.append(torch.einsum("bhtn,bhnp->bhtp", c_in[:, :, c], S))
        S = torch.exp(Lcum[:, :, c, -1])[..., None, None] * S + torch.einsum(
            "bhsn,bhsp->bhnp", b_tail[:, :, c], xdt[:, :, c])
    y = y_intra + torch.stack(y_cross, 2)
    y = y.permute(0, 2, 3, 1, 4).reshape(Bt, T + pad, H, P)[:, :T]
    if D is not None:
        y = y + xf[:, :T] * D.to(torch.float32)[None, None, :, None]
    y = y.to(out_dtype)
    return (y, S) if return_state else y


# ---------------------------------------------------------------------------
# The analytic backward (the JAX package's derivation).  With u_t = dt_t b_t
# the recurrence is S_t = a_t S_{t-1} + u_t x_t^T and y_t = S_t^T c_t + D x_t
# (the post-update state).  The adjoint Ghat_t = a_{t+1} Ghat_{t+1} + c_t
# ybar_t^T decays on the next index, so under time reversal it is the same
# forward form with the decay sequence flipped and shifted by one.  The
# gradients are per-step contractions of S_t or Ghat_t:
#     cbar_t = S_t ybar_t     ubar_t = Ghat_t x_t     xbar_t = Ghat_t^T u_t
# and the log-decay gradient telescopes:
#     dla_tau = revcumsum(P - Q)_tau + P_fin,
#     P_t = <c_t, cbar_t>, Q_s = <u_s, ubar_s>, P_fin = <Sbar_T, S_T>_F.
# Both passes run through one dual core; the residuals are the primal inputs.
# ---------------------------------------------------------------------------


def _ssd_dual(u, x, la, q, p, S0, chunk_size):
    """Chunked evaluation of both post-update state contractions of
    S_t = exp(la_t) S_{t-1} + u_t x_t^T, S_0 = S0:
      yA[t, p'] = sum_n q_t[n] S_t[n, p'],  yB[t, n] = sum_p' S_t[n, p']
      p_t[p'], and S_fin.
    u, q: (Bt, T, H, N) f32 (heads group-repeated); x, p: (Bt, T, H, P);
    la: (Bt, T, H); S0: (Bt, H, N, P)."""
    Bt, T, H, P = x.shape
    N = u.shape[-1]
    L = int(chunk_size)
    pad = (-T) % L
    u, x, q, p, la = (_pad_t(z, pad) for z in (u, x, q, p, la))
    Tp = T + pad
    NC = Tp // L
    uc, xc, qc, pc = (_chunks(z, NC, L) for z in (u, x, q, p))
    lac = la.reshape(Bt, NC, L, H).permute(0, 3, 1, 2)     # (Bt,H,NC,L)

    decay = torch.exp(_segsum(lac))
    qu = torch.einsum("bhctn,bhcsn->bhcts", qc, uc)
    yA = torch.einsum("bhcts,bhcsp->bhctp", qu * decay, xc)
    px = torch.einsum("bhctp,bhcsp->bhcts", pc, xc)
    yB = torch.einsum("bhcts,bhcsn->bhctn", px * decay, uc)

    Lcum = torch.cumsum(lac, dim=-1)
    efrom = torch.exp(Lcum)[..., None]
    q_in = qc * efrom
    p_in = pc * efrom
    u_tail = uc * torch.exp(Lcum[..., -1:] - Lcum)[..., None]
    S = S0
    yA_cross, yB_cross = [], []
    for c in range(NC):
        yA_cross.append(torch.einsum("bhtn,bhnp->bhtp", q_in[:, :, c], S))
        yB_cross.append(torch.einsum("bhnp,bhtp->bhtn", S, p_in[:, :, c]))
        S = torch.exp(Lcum[:, :, c, -1])[..., None, None] * S + torch.einsum(
            "bhsn,bhsp->bhnp", u_tail[:, :, c], xc[:, :, c])
    yA = yA + torch.stack(yA_cross, 2)
    yB = yB + torch.stack(yB_cross, 2)

    def unb(z, d):
        return z.permute(0, 2, 3, 1, 4).reshape(Bt, Tp, H, d)[:, :T]

    return unb(yA, P), unb(yB, N), S


def ssd_backward(x, dt, A, B, C, D, state, yb, Gbar, chunk_size=64):
    """Analytic gradients of :func:`ssd_chunked`.  yb: the cotangent of y
    (Bt, T, H, P); Gbar: that of the final state (Bt, H, N, P) or None.
    Returns (dx, ddt, dA, dB, dC, dD, dstate), dD and dstate None when the
    primal D and state were None."""
    Bt, T, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = H // G
    xf, dtf, Af, Bf, Cf, ybf = as_f32(x, dt, A, B, C, yb)
    Bh = torch.repeat_interleave(Bf, rep, dim=2)
    Ch = torch.repeat_interleave(Cf, rep, dim=2)
    la = dtf * Af[None, None, :]
    u = Bh * dtf[..., None]
    S0 = (_zeros_state(Bt, H, N, P, x.device) if state is None
          else state.to(torch.float32))
    G_T = (_zeros_state(Bt, H, N, P, x.device) if Gbar is None
           else Gbar.to(torch.float32))

    # the straight pass: cbar_t = S_t ybar_t, and S_T
    _, cbar, S_T = _ssd_dual(u, xf, la, Ch, ybf, S0, chunk_size)
    # the flipped pass: the adjoint states; xbar comes out as the yA probe
    # (q = flip(u)), ubar as the yB probe (p = flip(x))
    def fl(z):
        return torch.flip(z, (1,))

    la_hat = torch.cat([torch.zeros_like(la[:, :1]), fl(la)[:, :-1]], dim=1)
    xbar_f, ubar_f, F_T = _ssd_dual(fl(Ch), fl(ybf), la_hat, fl(u), fl(xf),
                                    G_T, chunk_size)
    xbar_s = fl(xbar_f)
    ubar = fl(ubar_f)

    dx = xbar_s if D is None else (
        xbar_s + ybf * D.to(torch.float32)[None, None, :, None])
    dB = (ubar * dtf[..., None]).reshape(Bt, T, G, rep, N).sum(dim=3)
    dC = cbar.reshape(Bt, T, G, rep, N).sum(dim=3)

    P_t = torch.einsum("bthn,bthn->bth", Ch, cbar)
    Q_t = torch.einsum("bthn,bthn->bth", u, ubar)
    P_fin = torch.einsum("bhnp,bhnp->bh", G_T, S_T)
    dla = revcumsum(P_t - Q_t, dim=1) + P_fin[:, None]
    ddt = torch.einsum("bthn,bthn->bth", Bh, ubar) + dla * Af[None, None, :]
    dA = torch.sum(dla * dtf, dim=(0, 1))
    dD = (None if D is None
          else torch.einsum("bthp,bthp->h", ybf, xf).to(D.dtype))
    # Ghat_0 = a_1 Ghat_1; the flipped pass's final state is Ghat_1
    dstate = (None if state is None else
              (torch.exp(la[:, 0])[..., None, None] * F_T).to(state.dtype))
    return (dx.to(x.dtype), ddt.to(dt.dtype), dA.to(A.dtype),
            dB.to(B.dtype), dC.to(C.dtype), dD, dstate)


class _SSD(torch.autograd.Function):
    """Forward: :func:`ssd_chunked`; backward: :func:`ssd_backward` from the
    saved primal inputs."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D, state, chunk_size, return_state):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, B, C, D, state)
        ctx.chunk_size = chunk_size
        out = ssd_chunked(x, dt, A, B, C, D, state, chunk_size, return_state)
        return out if return_state else (out,)

    @staticmethod
    def backward(ctx, yb, Gbar=None):
        x, dt, A, B, C, D, state = ctx.saved_tensors
        if yb is None:
            yb = torch.zeros_like(x)
        grads = ssd_backward(x, dt, A, B, C, D, state, yb, Gbar,
                             chunk_size=ctx.chunk_size)
        return (*grads, None, None)


def ssd_chunked_vjp(x, dt, A, B, C, D=None, state=None, chunk_size: int = 64,
                    return_state: bool = False):
    """:func:`ssd_chunked` with the analytic backward attached (the
    training path)."""
    out = _SSD.apply(x, dt, A, B, C, D, state, chunk_size, return_state)
    return out if return_state else out[0]


def ssd(x, dt, A, B, C, D=None, state: Optional[torch.Tensor] = None,
        chunk_size: int = 64, return_state: bool = False,
        impl: str = "chunked"):
    if impl == "ref":
        return ssd_ref(x, dt, A, B, C, D, state, return_state)
    if impl == "chunked_ad":
        return ssd_chunked(x, dt, A, B, C, D, state, chunk_size,
                           return_state)
    if impl != "chunked":
        raise ValueError(f"unknown ssd impl: {impl!r}")
    return ssd_chunked_vjp(x, dt, A, B, C, D, state, chunk_size,
                           return_state)
