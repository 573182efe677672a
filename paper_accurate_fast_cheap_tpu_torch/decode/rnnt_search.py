"""Transducer searches (port of the JAX ``decode/rnnt_search.py``): the
frame-synchronous greedy search (``basic_greedy_search``, up to ``n_steps``
emissions a frame) and the prefix beam search with CTC shallow fusion, on
the device (``impl="device"``, the pairwise or the sort merge, optionally
with the top hypothesis's CTC Viterbi path packed beside the beam) or as
the host-loop parity oracle (``impl="host"``).

Per frame, per beam: predictor state after the beam's last token, the
joint with enc[t], fusion ``log(tw * exp(trans) + cw * exp(ctc[t]))``, the
top-k expansion (blank keeps the prefix and state, a token extends both),
log-add merge of identical prefixes (two wrapping 32-bit polynomial hashes
+ length), prune to the beam.  Fixed beam, fixed shapes: the frame loop is
a Python loop of tensor ops on the device.  Each frame runs K3
(``ops/lstm_step.py``) for the predictor and one of the JAX beam's three
top-k routes (``topk_impl``):

* ``pallas_joint`` -- K2 (``ops/joint_topk.py``): joint head + log-softmax
  + fusion + top-k in one kernel, from the joint's split form (the encoder
  side projected once per batch, the CTC log-probs lane-padded with -inf
  once);
* ``pallas`` -- ``joint_step`` per frame, then K4 (``ops/fused_topk.py``):
  fusion + top-k in one kernel (the route of a joint with no split form,
  e.g. HAT);
* ``xla`` -- ``joint_step``, ``torch.logaddexp``, then K5
  (``ops/topk.top_k_vocab``).

``auto`` takes ``pallas_joint`` where the joint has the split form, else
``pallas``, on the card and on the CPU alike.  The initial blank step is
taken before the loop.

Ties never go through ``torch.topk``: the vocab selection follows
``ops/topk.top_k_vocab_plain`` and the final prune ``ops/topk.stable_top_k``
(``jax.lax.top_k`` order); the sort merge walks a stable sort of the
candidate scores, as JAX's does.

The host oracle walks the candidates in numpy exactly as JAX's does: the
fused row reaches numpy in float32 (``np.argsort(-lp)`` is an unstable
sort, so the dtype decides how ties order), the scores are float64, and
duplicates log-add into the earlier occurrence.  Its predictor reorder and
step run on the device (K3 on the card).  The greedy searches pick the
first maximum (``torch.argmax``), as ``jnp.argmax`` does.
"""
from __future__ import annotations

import math
from typing import Callable, List

import numpy as np
import torch
import torch.nn.functional as F

from paper_accurate_fast_cheap_tpu_torch.decode.search import DecodeResult
from paper_accurate_fast_cheap_tpu_torch.ops import ctc_utils
from paper_accurate_fast_cheap_tpu_torch.ops.fused_topk import (
    fused_top_k_vocab)
from paper_accurate_fast_cheap_tpu_torch.ops.joint_topk import (
    joint_top_k_vocab)
from paper_accurate_fast_cheap_tpu_torch.ops.topk import (
    LANES, stable_top_k, top_k_vocab)

P1 = 2654435761
P2 = 2246822519
_M32 = 0xFFFFFFFF


def _mul_u32(a: torch.Tensor, p: int) -> torch.Tensor:
    """(a * p) mod 2**32 for int64 ``a`` in [0, 2**32), without int64
    overflow: the high and low 16-bit halves of ``a`` are multiplied apart."""
    hi = ((a >> 16) * p) & 0xFFFF
    return ((hi << 16) + (a & 0xFFFF) * p) & _M32


def make_transducer_step_fns(model):
    """(predictor_step, joint_step, init_state_fn) for the searches.

    Where the joint has an ``ffn_out`` head (not HAT), ``joint_step``
    carries the split form the ``pallas_joint`` route needs: ``enc_proj``
    (batched encoder projection), ``preact`` (the activation before the
    vocab head) and ``head`` (the ``ffn_out`` weight and bias, which K2
    applies inside the kernel).  A predictor without a step (``embedding``,
    ``conv``) raises NotImplementedError.
    """
    model.check_steppable()

    def predictor_step(tokens, state):
        return model.predictor_step(tokens, state)

    def joint_step(enc_t, pred):
        return model.joint_step(enc_t, pred)

    if hasattr(model.joint, "ffn_out"):
        joint_step.enc_proj = model.joint_enc_proj
        joint_step.preact = model.joint_preact
        joint_step.head = lambda: (model.joint.ffn_out.weight,  # noqa: E731
                                   model.joint.ffn_out.bias)
    return predictor_step, joint_step, model.predictor_init_state


def _select_rows(mask: torch.Tensor, new: torch.Tensor,
                 old: torch.Tensor) -> torch.Tensor:
    """Per-row select on a predictor-state leaf: (L, n, ...) for ndim >= 3,
    (n, D) for ndim 2, (n,) for ndim 1."""
    if new.ndim >= 3:
        m = mask.reshape((1, -1) + (1,) * (new.ndim - 2))
    elif new.ndim == 2:
        m = mask[:, None]
    else:
        m = mask
    return torch.where(m, new, old)


def _select_state(mask, new, old):
    return tuple(_select_rows(mask, n, o) for n, o in zip(new, old))


def _gather_state(state, sel: torch.Tensor):
    """Gather predictor-state rows by flat index (the same convention)."""
    return tuple(s[:, sel] if s.ndim >= 3 else s[sel] for s in state)


def basic_greedy_search(predictor_step: Callable, joint_step: Callable,
                        init_state, enc_out: torch.Tensor,
                        enc_lens: torch.Tensor, blank_id: int = 0,
                        n_steps: int = 1) -> List[DecodeResult]:
    """Frame-synchronous greedy search, up to ``n_steps`` symbols a frame
    (a frame's emitting stops at its first blank; with ``n_steps`` 1 this
    is JAX's one-step form, with more its ``_greedy_multi``).

    ``init_state`` is the predictor state for B rows.  As in JAX, the
    predictor output of a leading blank starts the loop while the state
    carried into it is ``init_state`` itself (the blank step's state is
    not kept, in both forms)."""
    B, T, _ = enc_out.shape
    dev = enc_out.device
    with torch.no_grad():
        tokens = torch.full((B,), blank_id, dtype=torch.int32, device=dev)
        pred_out, _ = predictor_step(tokens, init_state)
        state = tuple(init_state)
        frames = []
        for t in range(T):
            enc_t = enc_out[:, t]
            active = torch.ones(B, dtype=torch.bool, device=dev)
            out = []
            for _ in range(n_steps):
                logp = joint_step(enc_t, pred_out)
                best = torch.argmax(logp, dim=-1).to(torch.int32)
                emitted = (best != blank_id) & active
                active = emitted
                out.append(torch.where(emitted, best, blank_id))
                tokens = torch.where(emitted, best, tokens)
                cand_out, cand_state = predictor_step(tokens, state)
                pred_out = torch.where(emitted[:, None], cand_out, pred_out)
                state = _select_state(emitted, cand_state, state)
            frames.append(torch.stack(out, dim=-1))
        emits = (torch.stack(frames, dim=1).cpu().numpy() if frames
                 else np.zeros((B, 0, n_steps), np.int32))
    lens = enc_lens.cpu().numpy()
    results = []
    for b in range(B):
        toks = []
        for t in range(lens[b]):
            for x in emits[b, t]:
                if x == blank_id:
                    break
                toks.append(int(x))
        results.append(DecodeResult(tokens=toks))
    return results


def rnnt_beam_search(predictor_step: Callable, joint_step: Callable,
                     init_state_fn: Callable, enc_out: torch.Tensor,
                     enc_lens: torch.Tensor, ctc_probs: torch.Tensor,
                     beam_size: int = 8, blank_id: int = 0,
                     ctc_weight: float = 0.3, transducer_weight: float = 0.7,
                     impl: str = "device", defer: bool = False,
                     merge: str = "pairwise", topk_impl: str = "auto",
                     align_pack: int = 0):
    """Batched prefix beam search with CTC shallow fusion.

    enc_out (B, T, De), enc_lens (B,), ctc_probs (B, T, V) log-probs.
    ``impl="device"``: the beam on the device, ``merge`` ``pairwise`` or
    ``sort``, ``topk_impl`` ``auto``, ``pallas_joint``, ``pallas`` or
    ``xla`` (module docstring; ``pallas_joint`` without the split form
    takes ``pallas``, as in JAX).  Returns a list of DecodeResult, or with
    ``defer=True`` the final carry (for ``pack_device_beam`` /
    ``finalize_device_beam``).  ``align_pack=Lmax`` runs the CTC Viterbi
    of each row's top hypothesis (its first Lmax tokens) after the beam
    and returns, deferred, one int32 buffer of beam, path, ok and lengths
    (``finalize_device_beam_aligned``).  ``impl="host"``: the host-loop
    oracle (its own module docstring paragraph).
    """
    if impl == "host":
        return _rnnt_beam_search_host(
            predictor_step, joint_step, init_state_fn, enc_out, enc_lens,
            ctc_probs, beam_size, blank_id, ctc_weight, transducer_weight)
    if impl != "device":
        raise ValueError(f"unknown impl {impl!r}")
    if merge not in ("pairwise", "sort"):
        raise ValueError(f"unknown merge {merge!r}")
    if topk_impl not in ("auto", "pallas_joint", "pallas", "xla"):
        raise ValueError(f"unknown topk_impl {topk_impl!r}")
    if topk_impl in ("auto", "pallas_joint"):
        topk_impl = ("pallas_joint" if hasattr(joint_step, "preact")
                     else "pallas")
    with torch.no_grad():
        out = _rnnt_beam_search_device(
            predictor_step, joint_step, init_state_fn, enc_out, enc_lens,
            ctc_probs, beam_size, blank_id, ctc_weight, transducer_weight,
            topk_impl, merge)
        if align_pack > 0:
            path, ok = ctc_utils.force_align_device_tokens(
                ctc_probs, enc_lens, out["hyps"][:, 0, :align_pack],
                out["hyp_len"][:, 0], blank_id=blank_id)
            out = pack_device_beam_aligned(out, path, ok, enc_lens)
    if defer:
        return out
    if align_pack > 0:
        return finalize_device_beam_aligned(out, beam=beam_size)[0]
    return finalize_device_beam(out)


def _rnnt_beam_search_device(predictor_step, joint_step, init_state_fn,
                             enc_out, enc_lens, ctc_probs, beam_size,
                             blank_id, ctc_weight, transducer_weight,
                             topk_impl, merge="pairwise"):
    dev = enc_out.device
    B, T, _ = enc_out.shape
    N = beam_size
    NK = N * N
    L = T  # at most one emission per frame
    neg = float("-inf")
    log_tw = math.log(transducer_weight) if transducer_weight > 0 else neg
    log_cw = math.log(ctc_weight) if ctc_weight > 0 else neg
    lens = enc_lens.to(dev)
    ctc = ctc_probs
    if topk_impl == "pallas_joint":
        w_out, b_out = joint_step.head()
        # hoisted once per batch: the joint's encoder projection, and the
        # CTC log-probs lane-padded with -inf (kept in their dtype)
        enc_out = joint_step.enc_proj(enc_out)
        V = ctc_probs.shape[-1]
        Vp = -(-V // LANES) * LANES
        if Vp != V:
            ctc = F.pad(ctc_probs, (0, Vp - V), value=neg)

    # the carry holds the state AFTER each beam's last token (the leading
    # blank here), so emissions step the predictor from the right state
    state = init_state_fn(B * N)
    pred_out, state = predictor_step(
        torch.full((B * N,), blank_id, dtype=torch.int32, device=dev), state)

    i32 = dict(dtype=torch.int32, device=dev)
    hyps = torch.zeros(B, N, L, **i32)
    hyp_len = torch.zeros(B, N, **i32)
    scores = torch.full((B, N), neg, device=dev)
    scores[:, 0] = 0.0
    h1 = torch.zeros(B, N, dtype=torch.int64, device=dev)
    h2 = torch.zeros(B, N, dtype=torch.int64, device=dev)
    last = torch.full((B, N), blank_id, **i32)

    jidx = torch.arange(NK, device=dev)
    j_lt_i = (jidx[:, None] < jidx[None, :])[None]
    j_le_i = (jidx[None, :] <= jidx[:, None])[None]
    row0 = (torch.arange(B, device=dev) * N)[:, None]

    for t in range(T):
        active = t < lens                                  # (B,)
        enc_rep = enc_out[:, t].repeat_interleave(N, dim=0)  # (B*N, De|J)
        if topk_impl == "pallas_joint":
            x_act = joint_step.preact(enc_rep, pred_out)
            vals, toks = joint_top_k_vocab(x_act, w_out, b_out, ctc[:, t],
                                           N, log_tw, log_cw)  # (B, N, N)
        elif topk_impl == "pallas":
            logp = joint_step(enc_rep, pred_out)
            vals, toks = fused_top_k_vocab(logp, ctc[:, t], N, log_tw,
                                           log_cw)
        else:
            logp = joint_step(enc_rep, pred_out)
            fused = torch.logaddexp(
                log_tw + logp,
                log_cw + ctc[:, t].repeat_interleave(N, dim=0))
            vals, toks = top_k_vocab(fused.reshape(B, N, -1), N)
        c_score = (scores[:, :, None] + vals).reshape(B, NK)
        c_tok = toks.reshape(B, NK)
        c_adv = c_tok != blank_id
        tk = c_tok.to(torch.int64) + 1
        src_h1 = h1.repeat_interleave(N, dim=1)
        src_h2 = h2.repeat_interleave(N, dim=1)
        c_h1 = torch.where(c_adv, (_mul_u32(src_h1, P1) + tk) & _M32, src_h1)
        c_h2 = torch.where(c_adv, (_mul_u32(src_h2, P2) + tk * P1) & _M32,
                           src_h2)
        c_len = hyp_len.repeat_interleave(N, dim=1) + c_adv.to(torch.int32)

        if merge == "pairwise":
            # sort-free walk: candidate j precedes i iff its score is
            # higher, or equal with a lower index (stable argsort of -score)
            eq = ((c_h1[:, :, None] == c_h1[:, None, :])
                  & (c_h2[:, :, None] == c_h2[:, None, :])
                  & (c_len[:, :, None] == c_len[:, None, :]))
            sc_j, sc_i = c_score[:, :, None], c_score[:, None, :]
            before = (sc_j > sc_i) | ((sc_j == sc_i) & j_lt_i)
            is_first = ~torch.any(eq & before, dim=1)
            firsts_before = torch.sum(is_first[:, :, None] & before, dim=1)
            # the walk stops once N distinct prefixes exist
            in_win = firsts_before < N
            contrib = torch.where(eq & in_win[:, None, :],
                                  c_score[:, None, :], neg)
            merged = torch.logsumexp(contrib, dim=-1)
            final = torch.where(is_first & in_win, merged, neg)
            top_scores, top_pos = stable_top_k(final, N)     # (B, N)
        else:
            # walk the candidates in a stable descending sort of the score
            order = torch.sort(-c_score, dim=-1, stable=True).indices
            s_score = torch.gather(c_score, 1, order)
            s_h1 = torch.gather(c_h1, 1, order)
            s_h2 = torch.gather(c_h2, 1, order)
            s_len = torch.gather(c_len, 1, order)
            eq = ((s_h1[:, :, None] == s_h1[:, None, :])
                  & (s_h2[:, :, None] == s_h2[:, None, :])
                  & (s_len[:, :, None] == s_len[:, None, :]))
            # the first equal position at or before each position
            first_idx = torch.argmax((eq & j_le_i).to(torch.int8), dim=-1)
            is_first = first_idx == jidx[None, :]
            urank = torch.cumsum(is_first.to(torch.int32), dim=-1)
            reached = urank >= N
            p_pos = torch.where(torch.any(reached, dim=-1),
                                torch.argmax(reached.to(torch.int8), dim=-1),
                                NK - 1)
            in_win = jidx[None, :] <= p_pos[:, None]
            contrib = torch.where(eq & in_win[:, None, :],
                                  s_score[:, None, :], neg)
            merged = torch.logsumexp(contrib, dim=-1)
            final = torch.where(is_first & in_win, merged, neg)
            top_scores, top_pos = stable_top_k(final, N)     # (B, N)
            # the winners' positions among the unsorted candidates
            top_pos = torch.gather(order, 1, top_pos)
        ok = top_scores > neg
        n_src = top_pos // N
        n_tok = torch.gather(c_tok, 1, top_pos)
        n_h1 = torch.gather(c_h1, 1, top_pos)
        n_h2 = torch.gather(c_h2, 1, top_pos)
        n_len = torch.gather(c_len, 1, top_pos)
        n_adv = (n_tok != blank_id) & ok

        new_hyps = torch.gather(hyps, 1, n_src[:, :, None].expand(B, N, L))
        # write the new token at position len-1 (rewrite in place where no
        # token was emitted)
        wpos = (n_len - n_adv.to(torch.int32)).clamp(0, L - 1)[..., None]
        wpos = wpos.long()
        cur = torch.gather(new_hyps, 2, wpos)
        new_hyps.scatter_(2, wpos, torch.where(n_adv[..., None],
                                               n_tok[..., None], cur))
        new_last = torch.where(n_adv, n_tok, torch.gather(last, 1, n_src))

        # predictor reorder + step (advance only where a token was emitted)
        sel = (row0 + n_src).reshape(-1)
        adv = n_adv.reshape(-1)
        state_g = _gather_state(state, sel)
        pred_g = pred_out[sel]
        cand_out, cand_state = predictor_step(new_last.reshape(-1), state_g)
        pred_new = torch.where(adv[:, None], cand_out, pred_g)
        state_new = _select_state(adv, cand_state, state_g)

        # frozen where the utterance already ended
        am = active[:, None]
        amn = active.repeat_interleave(N)
        hyps = torch.where(am[..., None], new_hyps, hyps)
        hyp_len = torch.where(am, n_len, hyp_len)
        scores = torch.where(am, top_scores, scores)
        h1 = torch.where(am, n_h1, h1)
        h2 = torch.where(am, n_h2, h2)
        last = torch.where(am, new_last, last)
        pred_out = torch.where(amn[:, None], pred_new, pred_out)
        state = _select_state(amn, state_new, state)

    return dict(hyps=hyps, hyp_len=hyp_len, scores=scores, h1=h1, h2=h2,
                last=last, pred_out=pred_out, state=state)


def pack_device_beam(out) -> torch.Tensor:
    """Flatten a deferred beam carry into ONE int32 (B, N*L + 2N) tensor:
    hyps, hyp_len, scores (f32 bits).  Recover with
    ``finalize_device_beam(packed, beam=N)``."""
    hyps = out["hyps"]
    B, N, L = hyps.shape
    return torch.cat([
        hyps.reshape(B, N * L).to(torch.int32),
        out["hyp_len"].to(torch.int32),
        out["scores"].to(torch.float32).contiguous().view(torch.int32),
    ], dim=1)


def finalize_device_beam(out, beam: int = 0) -> List[DecodeResult]:
    """Materialise a deferred carry (dict) or a ``pack_device_beam`` buffer
    (with ``beam=N``) into DecodeResults: the n-best with finite scores,
    best first."""
    if not isinstance(out, dict):
        if beam <= 0:
            raise ValueError("packed finalize needs beam=N")
        arr = out.cpu().numpy()
        B, W = arr.shape
        N = beam
        L = W // N - 2
        hyps = arr[:, : N * L].reshape(B, N, L)
        hyp_len = arr[:, N * L: N * L + N]
        scores = np.ascontiguousarray(arr[:, N * L + N:]).view(np.float32)
    else:
        hyps = out["hyps"].cpu().numpy()
        hyp_len = out["hyp_len"].cpu().numpy()
        scores = out["scores"].cpu().numpy()
    B, N = scores.shape
    results = []
    for b in range(B):
        nbest, nscores = [], []
        for j in range(N):
            if not np.isfinite(scores[b, j]):
                continue
            nbest.append([int(x) for x in hyps[b, j, : hyp_len[b, j]]])
            nscores.append(float(scores[b, j]))
        results.append(DecodeResult(
            tokens=nbest[0] if nbest else [],
            score=nscores[0] if nscores else 0.0,
            nbest=nbest, nbest_scores=nscores))
    return results


def pack_device_beam_aligned(out, path: torch.Tensor, ok: torch.Tensor,
                             lens) -> torch.Tensor:
    """``pack_device_beam`` + the top hypothesis's Viterbi path + its ok
    flag + the encoder lengths in ONE int32 tensor, so one copy brings the
    beam, its alignment and the lengths to the host.

    Row layout: [hyps N*L | hyp_len N | scores N (f32 bits) | path L | ok 1
    | len 1], L the frame count T.  Recover with
    ``finalize_device_beam_aligned(buf, beam=N)``."""
    B, N, L = out["hyps"].shape
    if tuple(path.shape) != (B, L):
        raise ValueError(f"path shape {tuple(path.shape)} != {(B, L)}")
    dev = out["hyps"].device
    return torch.cat([
        pack_device_beam(out),
        path.to(torch.int32),
        ok.to(torch.int32)[:, None],
        torch.as_tensor(lens, device=dev).to(torch.int32)[:, None],
    ], dim=1)


def finalize_device_beam_aligned(buf, beam: int):
    """Materialise a ``pack_device_beam_aligned`` buffer in one copy.
    Returns (results, path (B, T) int32, ok (B,) bool, lens (B,)) as
    numpy."""
    arr = buf.cpu().numpy() if isinstance(buf, torch.Tensor) \
        else np.asarray(buf)
    B, W = arr.shape
    N = beam
    L = (W - 2 * N - 2) // (N + 1)
    if N * L + 2 * N + L + 2 != W:
        raise ValueError(f"buffer width {W} does not fit beam {N}")
    beam_w = N * L + 2 * N
    results = finalize_device_beam(torch.from_numpy(arr[:, :beam_w]),
                                   beam=N)
    path = arr[:, beam_w: beam_w + L]
    ok = arr[:, beam_w + L].astype(bool)
    lens = arr[:, beam_w + L + 1]
    return results, path, ok, lens


def _rnnt_beam_search_host(predictor_step, joint_step, init_state_fn,
                           enc_out, enc_lens, ctc_probs, beam_size=8,
                           blank_id=0, ctc_weight=0.3,
                           transducer_weight=0.7) -> List[DecodeResult]:
    """Host-loop prefix beam search, the parity oracle of the device beam:
    per utterance and frame, walk every beam's top-N expansions in
    descending score, log-add duplicate prefixes into the earlier
    occurrence, stop at N distinct prefixes."""
    B, T, _ = enc_out.shape
    N = beam_size
    dev = enc_out.device
    lens = enc_lens.cpu().numpy()
    f32 = dict(dtype=torch.float32, device=dev)
    # jnp.log of the weights, in float32
    log_tw = torch.log(torch.tensor(transducer_weight, **f32))
    log_cw = torch.log(torch.tensor(ctc_weight, **f32))

    def reorder_and_step(state, pred_out, sel, new_tokens, advance):
        state_g = _gather_state(state, sel)
        pred_g = pred_out[sel]
        cand_out, cand_state = predictor_step(new_tokens, state_g)
        return (torch.where(advance[:, None], cand_out, pred_g),
                _select_state(advance, cand_state, state_g))

    with torch.no_grad():
        state = init_state_fn(B * N)
        pred_out, state = predictor_step(
            torch.full((B * N,), blank_id, dtype=torch.int32, device=dev),
            state)
        hyps = [[(blank_id,)] + [None] * (N - 1) for _ in range(B)]
        scores = np.full((B, N), -np.inf)
        scores[:, 0] = 0.0
        for t in range(int(lens.max()) if B else 0):
            enc_t = enc_out[:, t].repeat_interleave(N, dim=0)
            logp = joint_step(enc_t, pred_out)
            fused = torch.logaddexp(
                log_tw + logp,
                log_cw + ctc_probs[:, t].repeat_interleave(N, dim=0))
            fused = fused.float().cpu().numpy()        # float32 rows
            sel = np.zeros((B * N,), np.int64)
            new_tok = np.zeros((B * N,), np.int32)
            advance = np.zeros((B * N,), bool)
            for b in range(B):
                if t >= lens[b]:
                    sel[b * N: (b + 1) * N] = b * N + np.arange(N)
                    continue
                cands = []  # (score, src, adv, tok, hyp)
                for j in range(N):
                    if hyps[b][j] is None:
                        continue
                    base = scores[b, j]
                    lp = fused[b * N + j]
                    for u in np.argsort(-lp)[:N]:
                        s = base + lp[u]
                        if u == blank_id:
                            cands.append((s, j, False, int(u), hyps[b][j]))
                        else:
                            cands.append((s, j, True, int(u),
                                          hyps[b][j] + (int(u),)))
                cands.sort(key=lambda c: -c[0])
                best, seen = [], {}
                for s, src, adv, u, hyp in cands:
                    if hyp in seen:
                        e = best[seen[hyp]]
                        e[1] = np.logaddexp(e[1], s)
                    else:
                        seen[hyp] = len(best)
                        best.append([hyp, s, src, adv, u])
                        if len(best) >= N:
                            break
                best.sort(key=lambda e: -e[1])
                new_hyps = [None] * N
                for j, (hyp, s, src, adv, u) in enumerate(best):
                    new_hyps[j] = hyp
                    scores[b, j] = s
                    sel[b * N + j] = b * N + src
                    new_tok[b * N + j] = u if adv else hyp[-1]
                    advance[b * N + j] = adv
                for j in range(len(best), N):
                    scores[b, j] = -np.inf
                    sel[b * N + j] = b * N
                hyps[b] = new_hyps
            pred_out, state = reorder_and_step(
                state, pred_out, torch.from_numpy(sel).to(dev),
                torch.from_numpy(new_tok).to(dev),
                torch.from_numpy(advance).to(dev))
    results = []
    for b in range(B):
        nbest, nscores = [], []
        for j in np.argsort(-scores[b]):
            if hyps[b][j] is None:
                continue
            nbest.append(list(hyps[b][j][1:]))  # strip the leading blank
            nscores.append(float(scores[b, j]))
        results.append(DecodeResult(
            tokens=nbest[0] if nbest else [],
            score=nscores[0] if nscores else 0.0,
            nbest=nbest, nbest_scores=nscores))
    return results
