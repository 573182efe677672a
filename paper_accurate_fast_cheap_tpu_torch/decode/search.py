"""CTC decoding on the host (port of the JAX ``decode/search.py``:
``DecodeResult``, ``remove_duplicates_and_blank``, ``ctc_greedy_search`` and
``ctc_prefix_beam_search`` without context biasing).

The searches run in numpy over the (B, T, V) CTC log-posteriors, which are
brought to the host once per batch as float32 (a bf16 tensor widens
exactly), as the JAX package does with its device arrays.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Sequence

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
    twins with per-token peak times."""

    s: float = -np.inf           # blank-ending score
    ns: float = -np.inf          # non-blank-ending score
    v_s: float = -np.inf         # viterbi blank score
    v_ns: float = -np.inf        # viterbi non-blank score
    cur_token_prob: float = -np.inf
    times_s: tuple = ()
    times_ns: tuple = ()

    def score(self):
        return log_add(self.s, self.ns)

    def viterbi_score(self):
        return max(self.v_s, self.v_ns)

    def times(self):
        return self.times_s if self.v_s > self.v_ns else self.times_ns


def ctc_prefix_beam_search(ctc_probs, lengths, beam_size: int = 10,
                           blank_id: int = 0) -> List[DecodeResult]:
    """Standard CTC prefix beam search with per-token peak times; the
    top-``beam_size`` tokens of each frame are expanded."""
    ctc_probs = _host(ctc_probs)
    lengths = _host(lengths)
    results = []
    for b in range(ctc_probs.shape[0]):
        T = int(lengths[b])
        cur: Dict[tuple, _Prefix] = {(): _Prefix(s=0.0, ns=-np.inf,
                                                 v_s=0.0, v_ns=0.0)}
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
                        if ps.viterbi_score() + p > n.v_s:
                            n.v_s = ps.viterbi_score() + p
                            n.times_s = ps.times()
                    elif prefix and u == prefix[-1]:
                        # repeat: extend non-blank of same prefix
                        n = nxt[prefix]
                        n.ns = log_add(n.ns, ps.ns + p)
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
                        if ps.v_s + p > np_.v_ns:
                            np_.v_ns = ps.v_s + p
                            np_.cur_token_prob = p
                            np_.times_ns = ps.times_s + (t,)
                    else:
                        np_ = nxt[prefix + (int(u),)]
                        np_.ns = log_add(np_.ns, ps.score() + p)
                        if ps.viterbi_score() + p > np_.v_ns:
                            np_.v_ns = ps.viterbi_score() + p
                            np_.cur_token_prob = p
                            np_.times_ns = ps.times() + (t,)
            cur = dict(sorted(nxt.items(), key=lambda kv: kv[1].score(),
                              reverse=True)[:beam_size])
        nbest = [list(p) for p in cur.keys()]
        scores = [float(ps.score()) for ps in cur.values()]
        times = [list(ps.times()) for ps in cur.values()]
        results.append(DecodeResult(
            tokens=nbest[0] if nbest else [],
            score=scores[0] if scores else 0.0,
            times=times[0] if times else [],
            nbest=nbest, nbest_scores=scores, nbest_times=times,
        ))
    return results
