"""CTC decoding on the host and attention rescoring (port of the JAX
``decode/search.py``: ``DecodeResult``, ``remove_duplicates_and_blank``,
``ctc_greedy_search``, ``ctc_prefix_beam_search`` without context biasing,
``attention_rescoring_scores`` and ``attention_rescoring``; the attention
beam search and the GNMT scorer wait for ROADMAP Queue 1 item 9).

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
