"""RWKV-6 "WKV" linear recurrence: the plain PyTorch versions.

Per (batch, head) with head size N and state ``S in R^{N x N}`` (rows = key
channel j, cols = value channel i):

    y_t[i] = sum_j r_t[j] * (u[j] * k_t[j] * v_t[i] + S_{t-1}[j, i])
    S_t[j, i] = decay_t[j] * S_{t-1}[j, i] + k_t[j] * v_t[i]

with ``decay_t = exp(-exp(w_t))``.

* ``wkv6_ref``     -- the sequential recurrence (semantic oracle, no clamp).
* ``wkv6_chunked`` -- the two-level chunked form of the JAX package
  (inner blocks of 16 steps with midpoint-recentred factors, block states
  inside an outer chunk, a carried state across chunks).  It clamps
  ``w <= log(160 / 18)``, as the TPU kernels do, and is the plain version
  of the CUDA kernel in ``ops/wkv6_cuda.py``, whose ``wkv6_cuda`` is the
  one entry the model calls.
* ``wkv6_backward`` -- the analytic gradients of ``wkv6_chunked``: two
  calls of one chunked core (``_chunked_dual``) plus elementwise algebra,
  as the JAX package's XLA backward.  ``wkv6_cuda``'s autograd rule calls
  it.

Both take (B, T, H, N) tensors, accumulate in f32 and return y in the dtype
of ``r`` (and the final (B, H, N, N) f32 state when ``return_state``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from paper_accurate_fast_cheap_tpu_torch.ops.common import as_f32, revcumsum


def _mm(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum with f32 accumulation and an f32 result from either dtype (the
    JAX version's ``preferred_element_type=f32``)."""
    return torch.einsum(eq, a.float(), b.float())


def wkv6_ref(r, k, v, w, u, state: Optional[torch.Tensor] = None,
             return_state: bool = False):
    """Naive sequential WKV6 (no decay clamp)."""
    B, T, H, N = r.shape
    out_dtype = r.dtype
    rf, kf, vf, wf, uf = as_f32(r, k, v, w, u)
    decay = torch.exp(-torch.exp(wf))
    S = (torch.zeros(B, H, N, N, device=r.device) if state is None
         else state.float())
    ys = []
    for t in range(T):
        r_t, k_t, v_t, d_t = rf[:, t], kf[:, t], vf[:, t], decay[:, t]
        ruk = torch.sum(r_t * uf[None] * k_t, dim=-1, keepdim=True)
        ys.append(ruk * v_t + torch.einsum("bhj,bhji->bhi", r_t, S))
        S = d_t[..., None] * S + k_t[..., None] * v_t[..., None, :]
    y = (torch.stack(ys, dim=1) if ys else rf.new_zeros(B, 0, H, N)
         ).to(out_dtype)
    return (y, S) if return_state else y


def wkv6_chunked(r, k, v, w, u, state: Optional[torch.Tensor] = None,
                 chunk_size: int = 256, inner_size: int = 16,
                 return_state: bool = False):
    """Two-level chunked WKV6; same signature and semantics as
    :func:`wkv6_ref` apart from the decay clamp.  T is padded to a multiple
    of ``chunk_size`` (a multiple of ``inner_size``) with zero r/k/v and
    w = -inf, so pad steps leave the carried state undecayed."""
    B, T, H, N = r.shape
    out_dtype = r.dtype
    L = int(chunk_size)
    S_ = min(int(inner_size), L)
    if L % S_:
        raise ValueError(f"chunk_size {L} not a multiple of inner {S_}")
    nb = L // S_
    pad = (-T) % L
    rf, kf, vf, wf, uf = as_f32(r, k, v, w, u)
    if pad:
        tpad = (0, 0, 0, 0, 0, pad)
        rf, kf, vf = F.pad(rf, tpad), F.pad(kf, tpad), F.pad(vf, tpad)
        wf = F.pad(wf, tpad, value=-float("inf"))
    Tp = T + pad
    C = Tp // L

    # guards exp() overflow inside an inner block's midpoint factorization
    wf = torch.clamp(wf, max=float(np.log(160.0 / (S_ + 2))))

    shp = (B, C, nb, S_, H, N)
    perm = (0, 4, 1, 2, 3, 5)  # -> (B, H, C, nb, S, N)
    rc, kc, vc, wc = (x.reshape(shp).permute(perm) for x in (rf, kf, vf, wf))

    lw = -torch.exp(wc)
    Bi = torch.cumsum(lw, dim=-2)
    Be = Bi - lw
    total = Bi[..., -1, :]
    pfx_incl = torch.cumsum(total, dim=-2)
    pfx_excl = pfx_incl - total

    cd = torch.bfloat16 if out_dtype == torch.bfloat16 else torch.float32
    vc_c = vc.to(cd)

    # intra (within inner block), midpoint-recentred
    m = Bi[..., S_ // 2: S_ // 2 + 1, :]
    q_mid = (rc * torch.exp(Be - m)).to(cd)
    k_mid = (kc * torch.exp(m - Bi)).to(cd)
    A = _mm("...tn,...sn->...ts", q_mid, k_mid)
    tri = torch.tril(torch.ones(S_, S_, dtype=torch.bool, device=r.device),
                     diagonal=-1)
    A = torch.where(tri, A, torch.zeros((), device=r.device))
    diag = torch.sum(rc * uf[None, :, None, None, None, :] * kc, dim=-1)
    y_intra = _mm("...ts,...sn->...tn", A, vc_c) + diag[..., None] * vc

    # between inner blocks of one outer chunk: block states + transfer
    q2 = rc * torch.exp(Be)
    k2 = kc * torch.exp(total[..., None, :] - Bi)
    KV = _mm("...sn,...sp->...np", k2.to(cd), vc_c)
    D = torch.exp(torch.clamp(
        pfx_excl[..., :, None, :] - pfx_incl[..., None, :, :], max=0.0))
    blk_tri = torch.tril(torch.ones(nb, nb, dtype=torch.bool,
                                    device=r.device), diagonal=-1)
    D = torch.where(blk_tri[..., None], D, torch.zeros((), device=r.device))
    M = _mm("...ijn,...jnp->...inp", D, KV)
    y_between = _mm("...isn,...inp->...isp", q2.to(cd), M)

    # across outer chunks: a loop carrying the (N, N) state
    q_glob = q2 * torch.exp(pfx_excl)[..., None, :]
    outer_total = pfx_incl[..., -1, :]                       # (B,H,C,N)
    k_tail = k2 * torch.exp(
        outer_total[..., None, None, :] - pfx_incl[..., None, :])
    q_glob_f, k_tail_f, v_f = (x.to(cd).reshape(B, H, C, L, N)
                               for x in (q_glob, k_tail, vc))
    S = (torch.zeros(B, H, N, N, device=r.device) if state is None
         else state.float())
    y_cross = []
    for c in range(C):
        y_cross.append(_mm("bhtj,bhji->bhti", q_glob_f[:, :, c], S.to(cd)))
        S = torch.exp(outer_total[:, :, c])[..., None] * S + _mm(
            "bhsj,bhsi->bhji", k_tail_f[:, :, c], v_f[:, :, c])
    y_cross = torch.stack(y_cross, dim=2).reshape(B, H, C, nb, S_, N)

    y = (y_intra + y_between + y_cross).permute(0, 2, 3, 4, 1, 5)
    y = y.reshape(B, Tp, H, N)[:, :T].to(out_dtype)
    return (y, S) if return_state else y



# ---------------------------------------------------------------------------
# Analytic backward of the chunked form (the training path).
#
# The adjoint of S_t = diag(l_t) S_{t-1} + k_t v_t^T runs backwards in time
# in the same form, Ghat_{t-1} = diag(l_t) Ghat_t + r_t ybar_t^T, so the
# adjoint states come from the same chunked machinery on time-flipped
# inputs (k-role <- r, v-role <- ybar).  Every input gradient contracts
# either S_{t-1} or Ghat_t:
#     rbar_t = S_{t-1} ybar_t + (u*k_t) <ybar_t, v_t>
#     kbar_t = Ghat_t v_t    + (u*r_t) <ybar_t, v_t>
#     vbar_t = Ghat_t^T k_t  + <r_t, u*k_t> ybar_t
# and with g_t = -exp(w_t), P_t = r_t * (S_{t-1} ybar_t),
# Q_t = k_t * (Ghat_t v_t), P_fin = rowsum(Gbar_T * S_T):
#     dL/dg = revcumsum(P - Q) - P + P_fin.
# ---------------------------------------------------------------------------


def _chunked_dual(rf, kf, vf, ybf, wf, S0, chunk_size, inner_size, cd):
    """Two-level chunked evaluation of both contractions of the running
    state.  Inputs f32 (B, T, H, N); S0 the (B, H, N, N) initial state.
    Returns (y_nb, z, S_fin) with y_nb[t, i] = sum_j r_t[j] S_{t-1}[j, i],
    z[t, j] = sum_i S_{t-1}[j, i] ybar_t[i] and S_fin = S_T.  ``cd`` is the
    dtype of the product operands (bf16 for bf16 inputs); sums are f32."""
    B, T, H, N = rf.shape
    L = int(chunk_size)
    S_ = min(int(inner_size), L)
    nb = L // S_
    pad = (-T) % L
    if pad:
        tpad = (0, 0, 0, 0, 0, pad)
        rf, kf, vf, ybf = (F.pad(x, tpad) for x in (rf, kf, vf, ybf))
        wf = F.pad(wf, tpad, value=-float("inf"))
    Tp = T + pad
    C = Tp // L
    wf = torch.clamp(wf, max=float(np.log(160.0 / (S_ + 2))))

    shp = (B, C, nb, S_, H, N)
    perm = (0, 4, 1, 2, 3, 5)  # -> (B, H, C, nb, S, N)
    rc, kc, vc, yc, wc = (x.reshape(shp).permute(perm)
                          for x in (rf, kf, vf, ybf, wf))

    lw = -torch.exp(wc)
    Bi = torch.cumsum(lw, dim=-2)
    Be = Bi - lw
    total = Bi[..., -1, :]
    pfx_incl = torch.cumsum(total, dim=-2)
    pfx_excl = pfx_incl - total

    vc_c, yc_c = vc.to(cd), yc.to(cd)
    zero = torch.zeros((), device=rf.device)
    tri = torch.tril(torch.ones(S_, S_, dtype=torch.bool, device=rf.device),
                     diagonal=-1)

    # intra (within an inner block), midpoint-recentred
    m = Bi[..., S_ // 2: S_ // 2 + 1, :]
    eq = torch.exp(Be - m)
    q_mid = (rc * eq).to(cd)
    k_mid = (kc * torch.exp(m - Bi)).to(cd)
    A = torch.where(tri, _mm("...tn,...sn->...ts", q_mid, k_mid), zero)
    y_intra = _mm("...ts,...sn->...tn", A.to(cd), vc_c)
    Bm = torch.where(tri, _mm("...tp,...sp->...ts", yc_c, vc_c), zero)
    z_intra = eq * _mm("...ts,...sn->...tn", Bm.to(cd), k_mid)

    # between inner blocks of one outer chunk
    e2 = torch.exp(Be)
    q2 = rc * e2
    k2 = kc * torch.exp(total[..., None, :] - Bi)
    KV = _mm("...sn,...sp->...np", k2.to(cd), vc_c)
    D = torch.exp(torch.clamp(
        pfx_excl[..., :, None, :] - pfx_incl[..., None, :, :], max=0.0))
    blk_tri = torch.tril(torch.ones(nb, nb, dtype=torch.bool,
                                    device=rf.device), diagonal=-1)
    D = torch.where(blk_tri[..., None], D, zero)
    M = _mm("...ijn,...jnp->...inp", D, KV)
    y_between = _mm("...isn,...inp->...isp", q2.to(cd), M.to(cd))
    z_between = e2 * _mm("...inp,...isp->...isn", M.to(cd), yc_c)

    # across outer chunks: a loop carrying the (N, N) state
    eg = e2 * torch.exp(pfx_excl)[..., None, :]
    outer_total = pfx_incl[..., -1, :]                       # (B,H,C,N)
    k_tail = k2 * torch.exp(
        outer_total[..., None, None, :] - pfx_incl[..., None, :])
    flat = lambda x, d: x.to(d).reshape(B, H, C, L, N)  # noqa: E731
    q_glob_f, k_tail_f, v_f, yb_f = (flat(x, cd) for x in
                                     (rc * eg, k_tail, vc, yc))
    eg_f = flat(eg, torch.float32)
    S = S0
    y_cross, z_cross = [], []
    for c in range(C):
        Sc = S.to(cd)
        y_cross.append(_mm("bhtj,bhji->bhti", q_glob_f[:, :, c], Sc))
        z_cross.append(eg_f[:, :, c] * _mm("bhjp,bhtp->bhtj", Sc,
                                           yb_f[:, :, c]))
        S = torch.exp(outer_total[:, :, c])[..., None] * S + _mm(
            "bhsj,bhsi->bhji", k_tail_f[:, :, c], v_f[:, :, c])
    y_cross = torch.stack(y_cross, dim=2).reshape(B, H, C, nb, S_, N)
    z_cross = torch.stack(z_cross, dim=2).reshape(B, H, C, nb, S_, N)

    def unblock(x):
        return x.permute(0, 2, 3, 4, 1, 5).reshape(B, Tp, H, N)[:, :T]

    return (unblock(y_intra + y_between + y_cross),
            unblock(z_intra + z_between + z_cross), S)


def wkv6_backward(r, k, v, w, u, state, yb, Gbar, chunk_size: int = 256,
                  inner_size: int = 16):
    """Analytic gradients of :func:`wkv6_chunked`.

    ``yb``: the cotangent of y (B, T, H, N); ``Gbar``: that of the final
    state (B, H, N, N), or None.  Returns (dr, dk, dv, dw, du, dstate) in
    the input dtypes, with ``dstate`` None when ``state`` is None.  The
    sums are f32; the chunk products take bf16 operands when r is bf16.
    ``dw`` is 0 where the forward's decay clamp binds.
    """
    B, T, H, N = r.shape
    rf, kf, vf, wf, uf, ybf = as_f32(r, k, v, w, u, yb)
    cd = torch.bfloat16 if r.dtype == torch.bfloat16 else torch.float32
    S0 = (torch.zeros(B, H, N, N, device=r.device) if state is None
          else state.float())
    G_T = (torch.zeros(B, H, N, N, device=r.device) if Gbar is None
           else Gbar.float())

    # straight pass: z_t = S_{t-1} ybar_t, and S_T
    _, z, S_T = _chunked_dual(rf, kf, vf, ybf, wf, S0, chunk_size,
                              inner_size, cd)
    # flipped pass: the adjoint states; b_t = Ghat_t^T k_t comes out as the
    # y-contraction, a_t = Ghat_t v_t as the z-contraction
    fl = lambda x: torch.flip(x, (1,))  # noqa: E731
    b_f, a_f, G0 = _chunked_dual(fl(kf), fl(rf), fl(ybf), fl(vf), fl(wf),
                                 G_T, chunk_size, inner_size, cd)
    b, a = fl(b_f), fl(a_f)

    dyv = torch.sum(ybf * vf, dim=-1, keepdim=True)        # <ybar_t, v_t>
    ub = uf[None, None]
    dr = z + ub * kf * dyv
    dk = a + ub * rf * dyv
    dv = b + torch.sum(rf * ub * kf, dim=-1, keepdim=True) * ybf
    du = torch.sum(rf * kf * dyv, dim=(0, 1))

    P = rf * z
    Q = kf * a
    P_fin = torch.sum(G_T * S_T, dim=-1)                   # (B, H, N)
    dg = revcumsum(P - Q, 1) - P + P_fin[:, None]
    w_clamp = float(np.log(160.0 / (min(inner_size, chunk_size) + 2)))
    dw = torch.where(wf <= w_clamp, dg * (-torch.exp(wf)),
                     torch.zeros((), device=r.device))

    dstate = None if state is None else G0.to(state.dtype)
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw.to(w.dtype),
            du.to(u.dtype), dstate)
