"""Language-model scorers for shallow fusion (port of the JAX
``decode/lm.py``; host code, numpy).

The ESPnet scorer protocol the transducer searches of
``decode/transducer_espnet.py`` consume: ``score(state, token)`` returns a
log-prob vector over the output vocabulary and the new state (``token``
None: no advance), ``batch_score`` does so for a beam, ``advance`` moves a
state by one token.  Only non-blank extensions add ``lm_weight *
lm_scores[token]`` and advance the state; blank keeps both.

- ``NGramLM``: backoff n-gram from an ARPA file, log10 converted to the
  natural log of the searches.
- ``UniformLM``: a constant scorer for plumbing tests.

A state is a tuple of the last ``order - 1`` token ids (hashable; the
host beams carry one per hypothesis).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_LN10 = math.log(10.0)


class UniformLM:
    """log p(w|h) = -log V for every w (plumbing/fusion-math tests)."""

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size
        self._vec = np.full((vocab_size,), -math.log(vocab_size),
                            np.float32)

    def init_state(self):
        return ()

    def advance(self, state, token: int):
        return ()

    def score(self, state, token: Optional[int]):
        new_state = state if token is None else (state + (int(token),))
        return self._vec, new_state

    def batch_score(self, states, tokens):
        outs, news = [], []
        for st, tok in zip(states, tokens):
            v, ns = self.score(st, tok)
            outs.append(v)
            news.append(ns)
        return np.stack(outs), news


class NGramLM:
    """Backoff n-gram LM over token ids.

    ``ngrams[k]`` maps a k-tuple of ids -> (logp, backoff) in natural log
    (backoff 0.0 when absent).  Scoring: standard Katz backoff —
    p(w|h) = p*(h,w) if the n-gram exists, else bow(h) * p(w|h[1:]).
    """

    def __init__(self, ngrams: List[Dict[tuple, Tuple[float, float]]],
                 vocab_size: int, unk_logp: float = -20.0,
                 sos_id: Optional[int] = None):
        self.ngrams = ngrams          # index 0 = unigrams keyed by (w,)
        self.order = len(ngrams)
        self.vocab_size = vocab_size
        self.unk_logp = unk_logp
        # the ESPnet stack scores the leading blank as an LM <sos>
        # surrogate (`beam_search_transducer.py:263,280-283` — the first
        # `lm.score` advances by yseq[-1] == blank); set sos_id=blank_id
        # to reproduce that, or to a real <s> id when the LM has one
        self.sos_id = sos_id
        # dense unigram table
        self._uni = np.full((vocab_size,), unk_logp, np.float32)
        for (w,), (lp, _bo) in ngrams[0].items():
            if 0 <= w < vocab_size:
                self._uni[w] = lp
        # context index: order k -> ctx tuple -> (ids array, logps array)
        self._by_ctx: List[Dict[tuple, Tuple[np.ndarray, np.ndarray]]] = []
        for k in range(1, self.order):
            grouped: Dict[tuple, List[Tuple[int, float]]] = {}
            for key, (lp, _bo) in ngrams[k].items():
                grouped.setdefault(key[:-1], []).append((key[-1], lp))
            self._by_ctx.append({
                ctx: (np.fromiter((w for w, _ in pairs), np.int64),
                      np.fromiter((lp for _, lp in pairs), np.float32))
                for ctx, pairs in grouped.items()
            })

    # -- construction -----------------------------------------------------
    @classmethod
    def from_arpa(cls, path: str, symbol_table: Optional[Dict[str, int]],
                  vocab_size: int) -> "NGramLM":
        """Load an ARPA file.  ``symbol_table`` maps LM words to token
        ids (None = the LM words are already integer ids).  Words not in
        the table are dropped (consistent with building the LM over the
        same sentencepiece units as the model)."""
        def to_id(word: str) -> Optional[int]:
            if symbol_table is None:
                try:
                    return int(word)
                except ValueError:
                    return None
            return symbol_table.get(word)

        ngrams: List[Dict[tuple, Tuple[float, float]]] = []
        cur_order = 0
        section = None
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                if line.startswith("\\") and line.endswith("-grams:"):
                    cur_order = int(line[1:].split("-")[0])
                    while len(ngrams) < cur_order:
                        ngrams.append({})
                    section = "grams"
                    continue
                if line in ("\\data\\", "\\end\\"):
                    section = None
                    continue
                if section != "grams":
                    continue
                parts = line.split("\t")
                if len(parts) == 1:
                    parts = line.split()
                    if len(parts) < cur_order + 1:
                        continue
                    logp = parts[0]
                    words = parts[1:1 + cur_order]
                    backoff = (parts[1 + cur_order]
                               if len(parts) > 1 + cur_order else None)
                else:
                    logp = parts[0]
                    words = parts[1].split()
                    backoff = parts[2] if len(parts) > 2 else None
                ids = tuple(to_id(w) for w in words)
                if any(i is None for i in ids):
                    continue
                lp = float(logp) * _LN10
                bo = float(backoff) * _LN10 if backoff is not None else 0.0
                ngrams[cur_order - 1][ids] = (lp, bo)
        if not ngrams:
            raise ValueError(f"no n-grams parsed from {path}")
        return cls(ngrams, vocab_size)

    # -- scoring ----------------------------------------------------------
    def init_state(self):
        if self.sos_id is None:
            return ()
        s = (int(self.sos_id),)
        return s[-(self.order - 1):] if self.order > 1 else ()

    def advance(self, state: tuple, token: int) -> tuple:
        s = state + (int(token),)
        return s[-(self.order - 1):] if self.order > 1 else ()

    def _logp(self, hist: tuple, w: int) -> float:
        """p(w | hist) with backoff, hist len <= order-1."""
        if hist:
            k = len(hist)
            ent = self.ngrams[k].get(hist + (w,)) if k < self.order else None
            if ent is not None:
                return ent[0]
            bo_ent = self.ngrams[k - 1].get(hist)
            bo = bo_ent[1] if bo_ent is not None else 0.0
            return bo + self._logp(hist[1:], w)
        if not 0 <= w < self.vocab_size:
            return self.unk_logp
        return float(self._uni[w])

    def score(self, state: tuple, token: Optional[int]
              ) -> Tuple[np.ndarray, tuple]:
        """Advance the state with ``token`` (None = no advance), then
        return log p(. | new_state) over the vocab."""
        hist = state if token is None else state + (int(token),)
        hist = hist[-(self.order - 1):] if self.order > 1 else ()
        out = self._uni.copy()
        # overlay higher-order matches: walk suffix contexts short->long so
        # longer contexts override
        for k in range(1, len(hist) + 1):
            ctx = hist[-k:]
            ctx_ent = self.ngrams[k - 1].get(ctx)
            # backoff mass for words WITHOUT a (ctx, w) entry
            if ctx_ent is not None and ctx_ent[1] != 0.0:
                out = out + np.float32(ctx_ent[1])
            if k < self.order:
                hit = self._by_ctx[k - 1].get(ctx)
                if hit is not None:
                    idx, vals = hit
                    keep = idx < self.vocab_size
                    out[idx[keep]] = vals[keep]
        return out, hist

    def batch_score(self, states: Sequence[tuple],
                    tokens: Sequence[Optional[int]]):
        outs, news = [], []
        for st, tok in zip(states, tokens):
            v, ns = self.score(st, tok)
            outs.append(v)
            news.append(ns)
        return np.stack(outs), news

    def sequence_logp(self, tokens: Sequence[int]) -> float:
        """Sum log p over a token sequence (for rescoring/tests)."""
        total = 0.0
        hist: tuple = ()
        for w in tokens:
            total += self._logp(hist, int(w))
            hist = (hist + (int(w),))[-(self.order - 1):] \
                if self.order > 1 else ()
        return total
