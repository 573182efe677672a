"""CTC and attention decoding on the host (port of the JAX
``decode/search.py``: ``DecodeResult``, ``remove_duplicates_and_blank``,
``ctc_greedy_search``, ``ctc_prefix_beam_search`` with optional keyword
biasing through a ``decode/context_graph.ContextGraph``,
``attention_rescoring_scores``, ``attention_rescoring``, the
autoregressive ``attention_beam_search`` with the GNMT length and coverage
scorers, and ``make_gnmt_step_fn``).

The CTC searches run in numpy over the (B, T, V) CTC log-posteriors, which
are brought to the host once per batch as float32 (a bf16 tensor widens
exactly), as the JAX package does with its device arrays.  The attention
beam search runs the decoder on the device once a step over (B * beam, u)
prefixes and keeps the beam on the host: each step's log-probs reach numpy
as float32 and are ranked by ``np.argsort``, as in JAX, so ties order the
same.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class DecodeResult:
    tokens: List[int]
    score: float = 0.0
    confidence: float = 0.0
    tokens_confidence: List[float] = dataclasses.field(default_factory=list)
    times: List[int] = dataclasses.field(default_factory=list)
    nbest: List[List[int]] = dataclasses.field(default_factory=list)
    nbest_scores: List[float] = dataclasses.field(default_factory=list)
    nbest_times: List[List[int]] = dataclasses.field(default_factory=list)


def log_add(a, b):
    """Numerically stable log(exp(a) + exp(b))."""
    return np.logaddexp(a, b)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


def remove_duplicates_and_blank(tokens: Sequence[int],
                                blank_id: int = 0) -> List[int]:
    out, prev = [], None
    for t in tokens:
        if t != prev and t != blank_id:
            out.append(int(t))
        prev = t
    return out


def ctc_greedy_search(ctc_probs, lengths,
                      blank_id: int = 0) -> List[DecodeResult]:
    """ctc_probs: (B, T, V) log-probs (a tensor or an array)."""
    ctc_probs = _host(ctc_probs)
    lengths = _host(lengths)
    results = []
    for b in range(ctc_probs.shape[0]):
        T = int(lengths[b])
        ids = ctc_probs[b, :T].argmax(axis=-1)
        maxp = ctc_probs[b, np.arange(T), ids]
        tokens, times, confs = [], [], []
        prev = None
        for t, (i, p) in enumerate(zip(ids, maxp)):
            if i != prev and i != blank_id:
                tokens.append(int(i))
                times.append(t)
                confs.append(float(np.exp(p)))
            prev = i
        conf = float(np.mean(confs)) if confs else 0.0
        results.append(DecodeResult(tokens=tokens, score=float(maxp.sum()),
                                    confidence=conf, tokens_confidence=confs,
                                    times=times))
    return results


@dataclasses.dataclass
class _Prefix:
    """CTC prefix state: blank/non-blank ending scores and their Viterbi
    twins with per-token peak times, and the keyword-biasing state and
    boost (ranked by ``total_score``)."""

    s: float = -np.inf           # blank-ending score
    ns: float = -np.inf          # non-blank-ending score
    v_s: float = -np.inf         # viterbi blank score
    v_ns: float = -np.inf        # viterbi non-blank score
    cur_token_prob: float = -np.inf
    times_s: tuple = ()
    times_ns: tuple = ()
    context_state: object = None
    context_score: float = 0.0

    def score(self):
        return log_add(self.s, self.ns)

    def total_score(self):
        return self.score() + self.context_score

    def viterbi_score(self):
        return max(self.v_s, self.v_ns)

    def times(self):
        return self.times_s if self.v_s > self.v_ns else self.times_ns


def ctc_prefix_beam_search(ctc_probs, lengths, beam_size: int = 10,
                           blank_id: int = 0,
                           context_graph=None) -> List[DecodeResult]:
    """Standard CTC prefix beam search with per-token peak times; the
    top-``beam_size`` tokens of each frame are expanded.  With a
    ``context_graph``, a prefix's score carries the graph's boost
    (``_Prefix.total_score`` ranks the beam), and at the end a partial
    phrase's boost is taken back before the final ranking."""
    ctc_probs = _host(ctc_probs)
    lengths = _host(lengths)
    results = []
    for b in range(ctc_probs.shape[0]):
        T = int(lengths[b])
        root_cs = context_graph.root if context_graph is not None else None
        cur: Dict[tuple, _Prefix] = {(): _Prefix(s=0.0, ns=-np.inf,
                                                 v_s=0.0, v_ns=0.0,
                                                 context_state=root_cs)}
        for t in range(T):
            logp = ctc_probs[b, t]
            top = np.argsort(logp)[-beam_size:]
            nxt: Dict[tuple, _Prefix] = defaultdict(_Prefix)
            for prefix, ps in cur.items():
                for u in top:
                    p = float(logp[u])
                    if u == blank_id:
                        n = nxt[prefix]
                        n.s = log_add(n.s, ps.score() + p)
                        n.context_state = ps.context_state
                        n.context_score = ps.context_score
                        if ps.viterbi_score() + p > n.v_s:
                            n.v_s = ps.viterbi_score() + p
                            n.times_s = ps.times()
                    elif prefix and u == prefix[-1]:
                        # repeat: extend non-blank of same prefix
                        n = nxt[prefix]
                        n.ns = log_add(n.ns, ps.ns + p)
                        n.context_state = ps.context_state
                        n.context_score = ps.context_score
                        if ps.v_ns + p > n.v_ns:
                            n.v_ns = ps.v_ns + p
                            if p > ps.cur_token_prob:
                                n.cur_token_prob = p
                                n.times_ns = ps.times_ns[:-1] + (t,)
                            else:
                                n.cur_token_prob = ps.cur_token_prob
                                n.times_ns = ps.times_ns
                        # and new token after blank
                        np_ = nxt[prefix + (int(u),)]
                        np_.ns = log_add(np_.ns, ps.s + p)
                        _bias(context_graph, np_, ps, u)
                        if ps.v_s + p > np_.v_ns:
                            np_.v_ns = ps.v_s + p
                            np_.cur_token_prob = p
                            np_.times_ns = ps.times_s + (t,)
                    else:
                        np_ = nxt[prefix + (int(u),)]
                        np_.ns = log_add(np_.ns, ps.score() + p)
                        _bias(context_graph, np_, ps, u)
                        if ps.viterbi_score() + p > np_.v_ns:
                            np_.v_ns = ps.viterbi_score() + p
                            np_.cur_token_prob = p
                            np_.times_ns = ps.times() + (t,)
            cur = dict(sorted(nxt.items(),
                              key=lambda kv: kv[1].total_score(),
                              reverse=True)[:beam_size])
        if context_graph is not None:
            for ps in cur.values():
                ps.context_score += context_graph.finalize(ps.context_state)
            cur = dict(sorted(cur.items(),
                              key=lambda kv: kv[1].total_score(),
                              reverse=True))
        nbest = [list(p) for p in cur.keys()]
        scores = [float(ps.total_score()) for ps in cur.values()]
        times = [list(ps.times()) for ps in cur.values()]
        results.append(DecodeResult(
            tokens=nbest[0] if nbest else [],
            score=scores[0] if scores else 0.0,
            times=times[0] if times else [],
            nbest=nbest, nbest_scores=scores, nbest_times=times,
        ))
    return results


def _bias(context_graph, new: _Prefix, src: _Prefix, token) -> None:
    """The first source to reach a new prefix sets its biasing state."""
    if context_graph is not None and new.context_state is None:
        delta, new.context_state = context_graph.forward_one_step(
            src.context_state, int(token))
        new.context_score = src.context_score + delta


def gnmt_length_wu(cur_len: int, alpha: float) -> float:
    """GNMT length re-ranking divisor ``((5 + len) / 6) ** alpha``."""
    return ((5.0 + cur_len) / 6.0) ** alpha


def gnmt_coverage_wu(cov: np.ndarray, beta: float) -> float:
    """GNMT coverage re-ranking penalty ``beta * -sum(log(min(cov, 1)))``."""
    return float(beta * -np.log(np.minimum(cov, 1.0)).sum())


def attention_beam_search(decoder_one_step, enc_out: torch.Tensor,
                          enc_lens: torch.Tensor, sos: int, eos: int,
                          beam_size: int = 10, max_len: Optional[int] = None,
                          length_penalty: float = 0.0,
                          gnmt_alpha: float = 0.0, gnmt_beta: float = 0.0,
                          decoder_one_step_attn=None) -> List[DecodeResult]:
    """Autoregressive attention-decoder beam search, batched over
    (utterance x beam).

    ``decoder_one_step(enc (N, T, D), enc_lens (N,), ys (N, U), ys_lens
    (N,))`` -> the last position's log-probs (N, V); the decoder re-runs
    over the whole prefix each step (no cache).  A hypothesis ends at
    <eos>; its final score is divided by ``len ** length_penalty``, or with
    the GNMT scorer by ``gnmt_length_wu(len, gnmt_alpha)``, and with
    ``gnmt_beta`` and ``decoder_one_step_attn`` (which also returns the
    step's head-averaged cross-attention over the encoder frames, (N, T):
    ``make_gnmt_step_fn``) the coverage penalty over the utterance's valid
    frames is subtracted.  Unfinished hypotheses at ``max_len`` (default:
    the longest encoder length + 1) compete with the finished ones.
    """
    B, T, _ = enc_out.shape
    N = beam_size
    dev = enc_out.device
    if max_len is None:
        max_len = int(_host(enc_lens).max()) + 1
    enc_rep = enc_out.repeat_interleave(N, dim=0)
    lens_rep = enc_lens.to(dev).repeat_interleave(N, dim=0)

    ys = np.full((B * N, max_len + 1), eos, np.int32)
    ys[:, 0] = sos
    scores = np.full((B, N), -np.inf)
    scores[:, 0] = 0.0
    fin_hyps: List[List[Tuple[float, List[int]]]] = [[] for _ in range(B)]

    use_cov = gnmt_beta > 0.0 and decoder_one_step_attn is not None
    cov = np.zeros((B * N, T), np.float64) if use_cov else None
    enc_valid = _host(enc_lens).astype(np.int64)

    def _final_score(s, u_len, coverage, b):
        if gnmt_alpha or gnmt_beta:
            out = s / gnmt_length_wu(u_len, gnmt_alpha) if gnmt_alpha else s
            if use_cov and coverage is not None:
                out = out - gnmt_coverage_wu(coverage[: enc_valid[b]],
                                             gnmt_beta)
            return out
        return s / (u_len ** length_penalty) if length_penalty else s

    step_fn = decoder_one_step_attn if use_cov else decoder_one_step
    for u in range(max_len):
        with torch.no_grad():
            out = step_fn(enc_rep, lens_rep,
                          torch.from_numpy(ys[:, : u + 1]).to(dev),
                          torch.full((B * N,), u + 1, dtype=torch.int32,
                                     device=dev))
        if use_cov:
            logp, attn = _host(out[0]), _host(out[1])
        else:
            logp = _host(out)                       # (B*N, V) float32
        for b in range(B):
            cand = []
            for j in range(N):
                if not np.isfinite(scores[b, j]):
                    continue
                lp = logp[b * N + j]
                for tok in np.argsort(lp)[-N:]:
                    cand.append((scores[b, j] + lp[tok], j, int(tok)))
            if not cand:
                continue
            cand.sort(reverse=True)
            new_ys = ys[b * N: (b + 1) * N].copy()
            new_scores = np.full(N, -np.inf)
            new_cov = np.zeros((N, T), np.float64) if use_cov else None
            kept = 0
            for s, j, tok in cand:
                if kept >= N:
                    break
                step_cov = (cov[b * N + j] + attn[b * N + j] if use_cov
                            else None)
                if tok == eos:
                    fin_hyps[b].append(
                        (_final_score(s, u + 1, step_cov, b),
                         [int(x) for x in ys[b * N + j, 1: u + 1]]))
                    continue
                new_ys[kept] = ys[b * N + j]
                new_ys[kept, u + 1] = tok
                new_scores[kept] = s
                if use_cov:
                    new_cov[kept] = step_cov
                kept += 1
            ys[b * N: (b + 1) * N] = new_ys
            scores[b] = new_scores
            if use_cov:
                cov[b * N: (b + 1) * N] = new_cov
    results = []
    for b in range(B):
        # the unfinished hypotheses compete too
        for j in range(N):
            if np.isfinite(scores[b, j]):
                fin_hyps[b].append(
                    (_final_score(scores[b, j], max_len,
                                  cov[b * N + j] if use_cov else None, b),
                     [int(x) for x in ys[b * N + j, 1: max_len + 1]
                      if x != eos]))
        fin_hyps[b].sort(key=lambda x: x[0], reverse=True)
        best = fin_hyps[b][0] if fin_hyps[b] else (0.0, [])
        results.append(DecodeResult(tokens=best[1], score=float(best[0])))
    return results


def make_gnmt_step_fn(model):
    """The ``decoder_one_step_attn`` callable of the GNMT coverage scorer
    for a model with an attention decoder (``model.decoder``): (the last
    position's log-probs (N, V), the last decoder layer's cross-attention
    at that position, averaged over heads (N, T_enc)).  The probabilities
    are the ones the decoder's forward computed, after the mask (zeros on
    padded frames)."""
    if getattr(model, "decoder", None) is None:
        raise ValueError("this model has no attention decoder")

    def step(enc, enc_lens, ys, ys_lens):
        return model.decoder.forward_one_step(enc, enc_lens, ys, ys_lens,
                                              return_coverage=True)

    return step


def attention_rescoring_scores(decoder_apply, enc_out: torch.Tensor,
                               enc_len: torch.Tensor, nbest: List[List[int]],
                               sos: int, eos: int,
                               reverse_weight: float = 0.0) -> np.ndarray:
    """Score one utterance's n-best hypotheses with the attention decoder.

    ``decoder_apply(enc, enc_lens, ys_in, ys_lens, r_ys_in, reverse_weight)
    -> (l_logits, r_logits)``; ``enc_out`` (1, T, D) is repeated per
    hypothesis and the hypotheses are padded with <eos>.  Returns (n,)
    float64: each hypothesis' total log-prob, <eos> included.
    """
    n = len(nbest)
    maxu = max((len(h) for h in nbest), default=0) + 1
    ys_in = np.full((n, maxu), eos, np.int64)
    r_ys_in = np.full((n, maxu), eos, np.int64)
    ys_in[:, 0] = sos
    r_ys_in[:, 0] = sos
    ys_lens = np.zeros((n,), np.int64)
    for i, h in enumerate(nbest):
        ys_in[i, 1: 1 + len(h)] = h
        r_ys_in[i, 1: 1 + len(h)] = h[::-1]
        ys_lens[i] = len(h) + 1
    dev = enc_out.device
    l_logits, r_logits = decoder_apply(
        enc_out.repeat_interleave(n, dim=0),
        enc_len.repeat_interleave(n, dim=0), torch.from_numpy(ys_in).to(dev),
        torch.from_numpy(ys_lens).to(dev), torch.from_numpy(r_ys_in).to(dev),
        reverse_weight)
    l_logp = _host(torch.log_softmax(l_logits, dim=-1))
    r_logp = _host(torch.log_softmax(r_logits, dim=-1))
    scores = np.zeros((n,), np.float64)
    for i, h in enumerate(nbest):
        s = sum(l_logp[i, j, tok] for j, tok in enumerate(h))
        s += l_logp[i, len(h), eos]
        if reverse_weight > 0.0:
            rh = h[::-1]
            rs = sum(r_logp[i, j, tok] for j, tok in enumerate(rh))
            rs += r_logp[i, len(h), eos]
            s = (1.0 - reverse_weight) * s + reverse_weight * rs
        scores[i] = s
    return scores


def attention_rescoring(decoder_apply, enc_out: torch.Tensor,
                        enc_lens: torch.Tensor,
                        ctc_results: List[DecodeResult], sos: int, eos: int,
                        ctc_weight: float = 0.3,
                        reverse_weight: float = 0.0) -> List[DecodeResult]:
    """Rescore each utterance's CTC prefix-beam n-best: the best of
    ``att + ctc_weight * nbest_scores``; an empty n-best gives no tokens."""
    out = []
    for b, res in enumerate(ctc_results):
        if not res.nbest:
            out.append(DecodeResult(tokens=[]))
            continue
        att = attention_rescoring_scores(
            decoder_apply, enc_out[b: b + 1], enc_lens[b: b + 1],
            res.nbest, sos, eos, reverse_weight)
        total = att + ctc_weight * np.asarray(res.nbest_scores)
        best = int(np.argmax(total))
        out.append(DecodeResult(
            tokens=res.nbest[best], score=float(total[best]),
            times=res.nbest_times[best] if res.nbest_times else []))
    return out
