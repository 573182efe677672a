"""Minimal WFST stack (port of the JAX ``decode/wfst.py``; host code):
lexicon and grammar FSTs, OpenFst text I/O, an on-the-fly L o G scorer.

- ``arpa_to_g(NGramLM)``: the n-gram acceptor, one state per context, word
  arcs of cost ``-logp`` and epsilon backoff arcs of cost ``-bow`` to the
  shortened context (``arpa2fst``'s structure).
- ``lexicon_to_l(lexicon)``: the L transducer, tokens in and words out,
  star-closed at the root, without disambiguation symbols (the composition
  is on the fly, so homophones are left to the search).
- ``LGScorer``: L o G composed on the fly behind the scorer protocol of
  ``decode/lm.py``, so any beam's ``lm=`` hook decodes lexicon- and
  LM-constrained (the CTC topology is the beam's own blank handling).
- ``write_fst_text``/``read_fst_text``: AT&T text, for hosts with OpenFst
  or k2.

Weights are negative natural-log probabilities (tropical costs).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from paper_accurate_fast_cheap_tpu_torch.decode.lm import NGramLM

EPS = 0  # openfst convention: label 0 is epsilon


@dataclass
class Fst:
    """Simple mutable WFST: arcs[state] = [(ilabel, olabel, cost, dst)]."""

    arcs: List[List[Tuple[int, int, float, int]]] = field(
        default_factory=lambda: [[]])
    finals: Dict[int, float] = field(default_factory=dict)
    start: int = 0

    def add_state(self) -> int:
        self.arcs.append([])
        return len(self.arcs) - 1

    def add_arc(self, src: int, ilabel: int, olabel: int, cost: float,
                dst: int) -> None:
        self.arcs[src].append((ilabel, olabel, cost, dst))

    def set_final(self, state: int, cost: float = 0.0) -> None:
        self.finals[state] = cost

    @property
    def num_states(self) -> int:
        return len(self.arcs)

    @property
    def num_arcs(self) -> int:
        return sum(len(a) for a in self.arcs)


def write_fst_text(fst: Fst, path: str) -> None:
    """AT&T text format (fstcompile-compatible: src dst in out cost)."""
    with open(path, "w", encoding="utf-8") as f:
        for src, arcs in enumerate(fst.arcs):
            for il, ol, w, dst in arcs:
                f.write(f"{src}\t{dst}\t{il}\t{ol}\t{w:.6f}\n")
        for s, w in sorted(fst.finals.items()):
            f.write(f"{s}\t{w:.6f}\n" if w else f"{s}\n")


def read_fst_text(path: str) -> Fst:
    fst = Fst()
    max_state = 0
    rows = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            rows.append(parts)
            max_state = max(max_state, int(parts[0]))
            if len(parts) >= 4:
                max_state = max(max_state, int(parts[1]))
    while fst.num_states <= max_state:
        fst.add_state()
    for parts in rows:
        if len(parts) >= 4:
            fst.add_arc(int(parts[0]), int(parts[2]), int(parts[3]),
                        float(parts[4]) if len(parts) > 4 else 0.0,
                        int(parts[1]))
        else:
            fst.set_final(int(parts[0]),
                          float(parts[1]) if len(parts) > 1 else 0.0)
    return fst


# ------------------------------------------------------------------ G build


def arpa_to_g(lm: NGramLM, word_ids: Optional[Sequence[int]] = None) -> Fst:
    """n-gram ARPA -> grammar acceptor (labels = word ids, cost=-ln p).

    States are contexts; state 0 is the empty context.  Every context
    state has an epsilon backoff arc (cost -bow) to its suffix state,
    mirroring `arpa2fst` (srilm/kaldi) output structure.
    """
    fst = Fst()
    ctx_state: Dict[tuple, int] = {(): 0}

    def state_of(ctx: tuple) -> int:
        if ctx not in ctx_state:
            ctx_state[ctx] = fst.add_state()
        return ctx_state[ctx]

    # materialize states for every context that has continuations/backoff
    for k in range(1, lm.order):
        for key in lm.ngrams[k - 1]:
            state_of(key)
    fst.set_final(0, 0.0)
    for ctx, s in list(ctx_state.items()):
        fst.set_final(s, 0.0)  # any context may end the sentence
        if ctx:
            ent = lm.ngrams[len(ctx) - 1].get(ctx)
            bow = ent[1] if ent else 0.0
            fst.add_arc(s, EPS, EPS, -bow, state_of(ctx[1:]))
    # word arcs: from context state, consuming w -> next context state
    for k in range(1, lm.order + 1):
        for key, (lp, _bo) in lm.ngrams[k - 1].items():
            ctx, w = key[:-1], key[-1]
            if word_ids is not None and w not in word_ids:
                continue
            if ctx not in ctx_state:
                continue
            nxt = (ctx + (w,))[-(lm.order - 1):] if lm.order > 1 else ()
            # next context exists only if it has continuations; else back
            # off to its longest existing suffix
            while nxt and nxt not in ctx_state:
                nxt = nxt[1:]
            fst.add_arc(ctx_state[ctx], w, w, -lp, state_of(nxt))
    return fst


# ------------------------------------------------------------------ L build


def lexicon_to_l(lexicon: Dict[int, List[int]]) -> Fst:
    """{word_id: [token ids]} -> L transducer (tokens in, words out).

    A trie from the root; the word label is emitted on the FIRST token
    arc (early output, like kaldi's make_lexicon_fst with
    pushed labels), and the last token arc returns to the root
    (star closure).
    """
    fst = Fst()
    for word, toks in sorted(lexicon.items()):
        if not toks:
            continue
        cur = 0
        for i, t in enumerate(toks):
            last = i == len(toks) - 1
            out = word if i == 0 else EPS
            if last:
                fst.add_arc(cur, t, out, 0.0, 0)
            else:
                nxt = fst.add_state()
                fst.add_arc(cur, t, out, 0.0, nxt)
                cur = nxt
    fst.set_final(0, 0.0)
    return fst


# ----------------------------------------------------- on-the-fly LG scorer


class LGScorer:
    """Lexicon+grammar-constrained scorer with the `decode/lm.py`
    protocol: ``score(state, token) -> (cost vector over tokens,
    state)`` — plug into any beam's ``lm=`` hook for TLG-style decode.

    State = frozenset of weighted (l_state, g_state) pairs (the on-the-fly
    composition frontier after epsilon/backoff closure), truncated to the
    ``max_frontier`` best.  Token scores are ``max`` (tropical) over the
    frontier; out-of-lexicon tokens get ``oov_logp``.
    """

    def __init__(self, L: Fst, G: Fst, lm_order_hint: int = 3,
                 oov_logp: float = -20.0, max_frontier: int = 16,
                 vocab_size: Optional[int] = None):
        self.L = L
        self.G = G
        self.oov_logp = oov_logp
        self.max_frontier = max_frontier
        # score vectors must cover the MODEL vocab, not just the lexicon's
        # largest token id — beams index vec[tok] for any proposed token
        self.vocab_size = vocab_size
        # per-L-state token arc index
        self._l_index: List[Dict[int, List[Tuple[int, int]]]] = []
        for arcs in L.arcs:
            d: Dict[int, List[Tuple[int, int]]] = {}
            for il, ol, _w, dst in arcs:
                if il != EPS:
                    d.setdefault(il, []).append((ol, dst))
            self._l_index.append(d)
        # per-G-state word arc index (+ backoff closure cache)
        self._g_index: List[Dict[int, Tuple[float, int]]] = []
        self._g_backoff: List[Optional[Tuple[float, int]]] = []
        for arcs in G.arcs:
            d2: Dict[int, Tuple[float, int]] = {}
            bo = None
            for il, _ol, w, dst in arcs:
                if il == EPS:
                    bo = (w, dst)
                else:
                    prev = d2.get(il)
                    if prev is None or w < prev[0]:
                        d2[il] = (w, dst)
            self._g_index.append(d2)
            self._g_backoff.append(bo)
        self._vec_cache: Dict[tuple, np.ndarray] = {}
        self._vec_cache_cap = 8192  # ~20 KB/vector at vocab 5002
        self._n_tokens = max((max(d) for d in self._l_index if d),
                             default=0) + 1

    # -- scorer protocol --------------------------------------------------
    def init_state(self):
        return ((0.0, self.L.start, self.G.start),)

    def _g_word_cost(self, g: int, w: int) -> Optional[Tuple[float, int]]:
        """Cost+dest of consuming word w from G state g (with backoff)."""
        cost = 0.0
        seen = 0
        while True:
            hit = self._g_index[g].get(w)
            if hit is not None:
                return (cost + hit[0], hit[1])
            bo = self._g_backoff[g]
            if bo is None or seen > 8:
                return None
            cost += bo[0]
            g = bo[1]
            seen += 1

    def advance(self, state, token: int):
        frontier: Dict[Tuple[int, int], float] = {}
        for cost, ls, gs in state:
            for ol, ldst in self._l_index[ls].get(int(token), []):
                if ol == EPS:
                    key = (ldst, gs)
                    c = cost
                else:
                    hit = self._g_word_cost(gs, ol)
                    if hit is None:
                        continue
                    key = (ldst, hit[1])
                    c = cost + hit[0]
                if key not in frontier or c < frontier[key]:
                    frontier[key] = c
        if not frontier:
            # OOV escape: restart at the root so decoding can continue
            return self.init_state()
        items = sorted(((c, ls, gs) for (ls, gs), c in frontier.items()))
        best = items[0][0]
        return tuple((c - best, ls, gs)
                     for c, ls, gs in items[: self.max_frontier])

    def score(self, state, token: Optional[int]):
        st = self.advance(state, token) if token is not None else state
        vec = self._vec_cache.get(st)
        if vec is None:
            n_tokens = self._n_tokens
            if self.vocab_size is not None:
                n_tokens = max(n_tokens, self.vocab_size)
            vec = np.full((n_tokens,), self.oov_logp, np.float32)
            for cost, ls, gs in st:
                for tok, pairs in self._l_index[ls].items():
                    for ol, _ldst in pairs:
                        if ol == EPS:
                            lp = -cost  # in-word token: no new G cost
                        else:
                            hit = self._g_word_cost(gs, ol)
                            if hit is None:
                                continue
                            lp = -(cost + hit[0])
                        if lp > vec[tok]:
                            vec[tok] = lp
            self._vec_cache[st] = vec
            if len(self._vec_cache) > self._vec_cache_cap:
                self._vec_cache.pop(next(iter(self._vec_cache)))
        return vec, st


def build_tlg_scorer(lexicon_words: Dict[str, List[int]],
                     word_table: Dict[str, int],
                     lm: NGramLM, **kw) -> LGScorer:
    """Convenience: string lexicon + word table + n-gram -> scorer."""
    lex = {word_table[w]: toks for w, toks in lexicon_words.items()
           if w in word_table}
    return LGScorer(lexicon_to_l(lex), arpa_to_g(lm), **kw)
