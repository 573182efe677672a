"""RNN-T (transducer) loss: the forward algorithm over T-chunked joint
log-probs (port of the JAX ``ops/rnnt.py``).

The joint's (B, T, U+1, V) logits never exist whole: they are computed in
T-chunks under ``torch.utils.checkpoint`` (recomputed in the backward) and
reduced at once to the two numbers per lattice node the recursion needs,
the label and the blank log-probability.

Forward recursion (log space):
    alpha[0, 0] = 0
    alpha[t, u] = logaddexp(alpha[t-1, u] + blank[t-1, u],
                            alpha[t, u-1] + label[t, u-1])
    -log P = -(alpha[T-1, U] + blank[T-1, U])
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

NEG_INF = -1e30


def _log_linear_scan(a: torch.Tensor, c: torch.Tensor,
                     open_: torch.Tensor) -> torch.Tensor:
    """x_u = logaddexp(a_u, c_u + x_{u-1}) along the last axis, x_{-1} =
    -inf, for the lattice's rows: ``c_u`` is finite where ``open_`` (1 <= u
    <= U_b) and NEG_INF elsewhere, where the JAX recursion gives x_u = a_u
    exactly.

    Closed form: x_u = C_u + logcumsumexp(a - C)_u with C the cumulative
    sum of c over the open positions (C is a sum of at most U log-probs, so
    nothing large is subtracted; the NEG_INF entries stay in ``a``, which
    only the max-shifted logcumsumexp sees)."""
    C = torch.cumsum(torch.where(open_, c, torch.zeros((), device=c.device)),
                     dim=-1)
    x = C + torch.logcumsumexp(a - C, dim=-1)
    return torch.where(open_, x, a)


def rnnt_forward(label_logp: torch.Tensor, blank_logp: torch.Tensor,
                 t_lens: torch.Tensor, u_lens: torch.Tensor) -> torch.Tensor:
    """label_logp[b, t, u] = log P(label_{u+1} | t, u) and blank_logp, both
    (B, T, U+1) f32; t_lens, u_lens (B,).  Returns the per-sequence negative
    log-likelihood (B,)."""
    B, T, U1 = label_logp.shape
    dev = label_logp.device
    u_idx = torch.arange(U1, device=dev)[None, :]
    u_lens = u_lens.to(dev).long()
    # emitting a label is only allowed for u < U_b
    label_ok = u_idx < u_lens[:, None]
    lab = torch.where(label_ok[:, None, :], label_logp,
                      torch.full((), NEG_INF, device=dev))
    # c_u = lab[u - 1]: open for 1 <= u <= U_b
    c_all = F.pad(lab, (1, 0))[..., :U1]
    open_ = (u_idx >= 1) & (u_idx <= u_lens[:, None])
    alpha = torch.where(u_idx == 0, 0.0, NEG_INF).expand(B, U1).float()
    alphas = []
    for t in range(T):
        a = alpha if t == 0 else alpha + blank_logp[:, t - 1]
        alpha = _log_linear_scan(a, c_all[:, t], open_)
        alphas.append(alpha)
    all_alpha = torch.stack(alphas, dim=1)                  # (B, T, U1)
    # terminal: alpha[T_b - 1, U_b] + blank[T_b - 1, U_b]
    b_idx = torch.arange(B, device=dev)
    t_last = torch.clamp(t_lens.to(dev).long() - 1, 0, T - 1)
    return -(all_alpha[b_idx, t_last, u_lens]
             + blank_logp[b_idx, t_last, u_lens])


def gather_rnnt_logprobs_chunked(
        enc_proj: torch.Tensor, pred_proj: torch.Tensor,
        labels: torch.Tensor, joint_fn: Callable, blank_id: int = 0,
        t_chunk: int = 16) -> Tuple[torch.Tensor, torch.Tensor]:
    """(label_logp, blank_logp), each (B, T, U+1) f32, from the projected
    encoder (B, T, J) and predictor (B, U+1, J) outputs without the full
    (B, T, U+1, V) joint output: ``joint_fn(enc (B, Tc, 1, J), pred (B, 1,
    U+1, J))`` gives one chunk's logits, which the backward recomputes."""
    B, T, J = enc_proj.shape
    labels_ext = F.pad(labels.long(), (0, 1))  # the label at u = U is unused
    idx = labels_ext[:, None, :, None]

    def one_chunk(enc_c, pred_p):
        logits = joint_fn(enc_c[:, :, None, :], pred_p[:, None, :, :])
        logp = torch.log_softmax(logits.float(), dim=-1)
        lab = torch.gather(logp, -1, idx.expand(*logp.shape[:3], 1))[..., 0]
        return lab, logp[..., blank_id]

    labs, blanks = [], []
    for t0 in range(0, T, t_chunk):
        lab, blank = checkpoint(one_chunk, enc_proj[:, t0:t0 + t_chunk],
                                pred_proj, use_reentrant=False)
        labs.append(lab)
        blanks.append(blank)
    return torch.cat(labs, dim=1), torch.cat(blanks, dim=1)


def rnnt_loss_dense(logits: torch.Tensor, labels: torch.Tensor,
                    t_lens: torch.Tensor, u_lens: torch.Tensor,
                    blank_id: int = 0) -> torch.Tensor:
    """The oracle: the loss from full (B, T, U+1, V) logits (small inputs
    only).  Returns (B,)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    idx = F.pad(labels.long(), (0, 1))[:, None, :, None]
    lab = torch.gather(logp, -1, idx.expand(*logp.shape[:3], 1))[..., 0]
    return rnnt_forward(lab, logp[..., blank_id], t_lens, u_lens)
