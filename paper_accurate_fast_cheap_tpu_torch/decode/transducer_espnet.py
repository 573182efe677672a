"""ESPnet-style transducer searches (port of the JAX
``decode/transducer_espnet.py``): the reference's alternative stack beside
``decode/rnnt_search.py``.

* ``default_beam_search``: Graves 2012 best-first beam;
* ``time_sync_decoding``: TSD, up to ``max_sym_exp`` expansion rounds a
  frame (Saon et al. 2020);
* ``align_length_sync_decoding``: ALSD over i = t + u, ``u_max``;
* ``nsc_beam_search``: N-step constrained (Kim et al. 2020), a prefix
  search a frame and ``nstep`` rounds of constrained expansion;
* ``modified_adaptive_expansion_search``: mAES (Kim & Sung 2020),
  prune-by-value ``_select_k_expansions`` with ``expansion_gamma`` and
  ``expansion_beta``.

LM shallow fusion in all five through ``lm=``/``lm_weight=`` and the
scorer protocol of ``decode/lm.py`` (an ``NGramLM``, a ``UniformLM`` or a
``decode/wfst.LGScorer``), with the reference's mAES final-round stale
``lm_state``, as in JAX.

The searches take the step callables of
``rnnt_search.make_transducer_step_fns``: ``predictor_step(tokens (n,),
state) -> (out (n, D), state)``, the state a tensor or a tuple of tensors
whose rows are on axis 1 for ndim >= 3 and on axis 0 otherwise, and
``joint_step(enc (n, De), pred (n, Dp)) -> log-probs (n, V)``.  A
flagship transducer's predictor step is K3 (``ops/lstm_step.py``) on the
card.  The bookkeeping runs on the host in numpy, as in JAX: each joint's
log-probs come to the host in float32 before any ranking, so JAX's stable
``sorted(..., key=score)``, ``np.argsort(-nb)`` and ``np.argpartition``
orders hold; predictor outputs and states stay on the device, in a state bank
that keeps JAX's row numbering (each predictor call's rows appended).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch

from paper_accurate_fast_cheap_tpu_torch.decode.search import (
    DecodeResult, _host)


def _leaves(state):
    return (state,) if isinstance(state, torch.Tensor) else tuple(state)


@dataclasses.dataclass
class Hypothesis:
    """`beam_search_transducer.py:24-42` (Hypothesis + ExtendedHypothesis).

    ``dec_outs`` is only populated by NSC/mAES: ``dec_outs[k]`` is the
    predictor output after consuming ``yseq[k]`` (the reference's
    ``ExtendedHypothesis.dec_out`` list, used by ``prefix_search``)."""

    score: float
    yseq: List[int]
    pred_out: torch.Tensor        # predictor output after consuming yseq
    state_idx: int                # row into the searcher's state bank
    dec_outs: Optional[List[torch.Tensor]] = None
    lm_state: tuple = ()          # shallow-fusion LM state (`:121-139`)
    lm_scores: Optional[np.ndarray] = None  # cached dist (ExtendedHypothesis)


class _StateBank:
    """Flat predictor-state storage: rows appended in order, gathered by
    index.  JAX concatenates each call's new rows onto the bank; here they
    are written into buffers that double when full, the same rows at the
    same indices without copying the whole bank on every append."""

    def __init__(self, state):
        self._single = isinstance(state, torch.Tensor)
        self._bufs = list(_leaves(state))
        self.n = self._rows(self._bufs[0])

    @staticmethod
    def _rows(leaf):
        return leaf.shape[1] if leaf.ndim >= 3 else leaf.shape[0]

    def gather(self, idxs):
        sel = torch.as_tensor(idxs, dtype=torch.long,
                              device=self._bufs[0].device)
        out = [s[:, sel] if s.ndim >= 3 else s[sel] for s in self._bufs]
        return out[0] if self._single else tuple(out)

    def append_rows(self, new_state):
        n0 = self.n
        new = _leaves(new_state)
        k = self._rows(new[0])
        if n0 + k > self._rows(self._bufs[0]):
            cap = max(2 * (n0 + k), 16)
            grown = []
            for b in self._bufs:
                axis = 1 if b.ndim >= 3 else 0
                shape = list(b.shape)
                shape[axis] = cap
                g = b.new_empty(shape)
                g.narrow(axis, 0, n0).copy_(b.narrow(axis, 0, n0))
                grown.append(g)
            self._bufs = grown
        for b, x in zip(self._bufs, new):
            b.narrow(1 if b.ndim >= 3 else 0, n0, k).copy_(x)
        self.n = n0 + k
        return n0


class BeamSearchTransducer:
    """`beam_search_transducer.py:45-163` surface.

    ``lm``/``lm_weight`` enable shallow fusion (`:121-139`): any scorer
    with ``score(state, token) -> (logp_over_V, state)`` and
    ``advance(state, token) -> state`` (see `decode/lm.py`).  Reference
    semantics (`:280-291,383-397`): only non-blank extensions add
    ``lm_weight * lm_logp[token]`` and advance the LM state; blank keeps
    both untouched."""

    def __init__(
        self,
        predictor_step: Callable,
        joint_step: Callable,
        init_state_fn: Callable,
        beam_size: int = 8,
        blank_id: int = 0,
        search_type: str = "default",
        max_sym_exp: int = 2,
        u_max: int = 50,
        score_norm: bool = True,
        prefix_alpha: int = 1,
        nstep: int = 1,
        expansion_gamma: float = 2.3,
        expansion_beta: int = 2,
        nbest: Optional[int] = None,
        lm=None,
        lm_weight: float = 0.3,
    ):
        self.predictor_step = predictor_step
        self.joint_step = joint_step
        self.init_state_fn = init_state_fn
        self.beam_size = beam_size
        self.blank_id = blank_id
        self.search_type = search_type
        self.max_sym_exp = max_sym_exp
        self.u_max = u_max
        self.score_norm = score_norm
        self.prefix_alpha = prefix_alpha
        # `:112` — mAES needs at least two expansion rounds
        self.nstep = (nstep if nstep > 1 else 2) \
            if search_type == "maes" else nstep
        self.expansion_gamma = expansion_gamma
        self.expansion_beta = expansion_beta
        self.nbest = nbest if nbest is not None else beam_size
        self.lm = lm
        self.lm_weight = lm_weight
        self.use_lm = lm is not None
        self._lm_cache = {}

    # one vocab-sized float32 vector per distinct LM state (~20 KB at
    # vocab 5002); cap the memo so a multi-hour dataset decode through
    # one searcher instance cannot grow RSS unboundedly
    _LM_CACHE_CAP = 8192

    # -- LM shallow fusion helpers (`:121-139`) --------------------------
    def _lm_vec(self, state: tuple) -> np.ndarray:
        v = self._lm_cache.get(state)
        if v is None:
            v, _ = self.lm.score(state, None)
            self._lm_cache[state] = v
            if len(self._lm_cache) > self._LM_CACHE_CAP:
                self._lm_cache.pop(next(iter(self._lm_cache)))
        return v

    def _lm_adv(self, state: tuple, tok: int) -> tuple:
        return self.lm.advance(state, tok)

    # -- public -----------------------------------------------------------
    @torch.no_grad()
    def __call__(self, enc_out: torch.Tensor) -> List[Hypothesis]:
        """enc_out: (T, De) one utterance -> n-best hypotheses."""
        if self.search_type == "default":
            hyps = self.default_beam_search(enc_out)
        elif self.search_type == "tsd":
            hyps = self.time_sync_decoding(enc_out)
        elif self.search_type == "alsd":
            hyps = self.align_length_sync_decoding(enc_out)
        elif self.search_type == "nsc":
            hyps = self.nsc_beam_search(enc_out)
        elif self.search_type == "maes":
            hyps = self.modified_adaptive_expansion_search(enc_out)
        else:
            raise NotImplementedError(
                f"unknown search_type {self.search_type!r}")
        return self.sort_nbest(hyps)

    def decode(self, enc_out) -> DecodeResult:
        hyps = self(enc_out)
        nbest = [h.yseq[1:] for h in hyps]
        scores = [h.score for h in hyps]
        return DecodeResult(tokens=nbest[0] if nbest else [],
                            score=scores[0] if scores else 0.0,
                            nbest=nbest, nbest_scores=scores)

    def sort_nbest(self, hyps: List[Hypothesis]) -> List[Hypothesis]:
        """`:146-163` — normalize by length when score_norm."""
        if self.score_norm:
            hyps.sort(key=lambda x: x.score / max(len(x.yseq), 1),
                      reverse=True)
        else:
            hyps.sort(key=lambda x: x.score, reverse=True)
        return hyps[: self.nbest]

    # -- helpers ----------------------------------------------------------
    def _init_hyp(self, extended: bool = False):
        state = self.init_state_fn(1)
        tok = torch.full((1,), self.blank_id, dtype=torch.int32,
                         device=_leaves(state)[0].device)
        pred, state = self.predictor_step(tok, state)
        bank = _StateBank(state)
        p0 = pred[0]
        lm_state = self.lm.init_state() if self.use_lm else ()
        return Hypothesis(score=0.0, yseq=[self.blank_id], pred_out=p0,
                          state_idx=0,
                          dec_outs=[p0] if extended else None,
                          lm_state=lm_state,
                          lm_scores=(self._lm_vec(lm_state)
                                     if self.use_lm else None)), bank

    def _advance(self, bank: _StateBank, hyps: List[Hypothesis],
                 tokens: List[int]):
        """Predictor step for (hyp, token) pairs; returns (pred_outs,
        new state row indices)."""
        idxs = [h.state_idx for h in hyps]
        st = bank.gather(idxs)
        toks = torch.as_tensor(tokens, dtype=torch.int32,
                               device=_leaves(st)[0].device)
        pred, new_state = self.predictor_step(toks, st)
        base = bank.append_rows(new_state)
        return pred, [base + i for i in range(len(hyps))]

    def _joint(self, enc_t: torch.Tensor, hyps: List[Hypothesis]):
        return self._joint_vecs(enc_t, [h.pred_out for h in hyps])

    def _joint_vecs(self, enc_t: torch.Tensor, preds: List[torch.Tensor]):
        """Joint log-probs for raw predictor-output vectors, (n, V)."""
        pred = torch.stack(preds)
        enc = enc_t[None].expand(len(preds), enc_t.shape[-1])
        return _host(self.joint_step(enc, pred))

    def prefix_search(self, hyps: List[Hypothesis], enc_t: torch.Tensor
                      ) -> List[Hypothesis]:
        """Graves prefix search for NSC/mAES (`:165-199`): fold the
        probability of reaching a hypothesis via any of its kept proper
        prefixes (within ``prefix_alpha`` extra tokens) into its score.

        ``hyps`` must be sorted by len(yseq) descending (callers do)."""
        for j, hyp_j in enumerate(hyps[:-1]):
            for hyp_i in hyps[j + 1:]:
                curr_id, pref_id = len(hyp_j.yseq), len(hyp_i.yseq)
                if not (_is_prefix(hyp_j.yseq, hyp_i.yseq)
                        and curr_id - pref_id <= self.prefix_alpha):
                    continue
                logp = self._joint_vecs(enc_t, [hyp_i.dec_outs[-1]])[0]
                curr_score = hyp_i.score + float(logp[hyp_j.yseq[pref_id]])
                for k in range(pref_id, curr_id - 1):
                    logp = self._joint_vecs(enc_t, [hyp_j.dec_outs[k]])[0]
                    curr_score += float(logp[hyp_j.yseq[k + 1]])
                hyp_j.score = float(np.logaddexp(hyp_j.score, curr_score))
        return hyps

    # -- searches ----------------------------------------------------------
    def default_beam_search(self, enc_out) -> List[Hypothesis]:
        """Graves beam search (`:235-312`): best-first per frame; a frame
        finishes once >= beam kept (blank-extended) hyps outscore every
        pending expansion."""
        beam = self.beam_size
        beam_k = beam
        h0, bank = self._init_hyp()
        kept_hyps = [h0]
        for t in range(enc_out.shape[0]):
            hyps = kept_hyps
            kept_hyps = []
            while True:
                max_hyp = max(hyps, key=lambda x: x.score)
                hyps.remove(max_hyp)
                logp = self._joint(enc_out[t], [max_hyp])[0]
                nb = logp.copy()
                nb[self.blank_id] = -np.inf
                toks = [int(k) for k in
                        np.argsort(-nb)[: min(beam_k, nb.shape[0] - 1)]]
                # blank: hyp survives to the next frame (LM untouched,
                # `:280-291`)
                kept_hyps.append(Hypothesis(
                    score=max_hyp.score + float(logp[self.blank_id]),
                    yseq=max_hyp.yseq[:], pred_out=max_hyp.pred_out,
                    state_idx=max_hyp.state_idx,
                    lm_state=max_hyp.lm_state))
                lm_vec = (self._lm_vec(max_hyp.lm_state)
                          if self.use_lm else None)
                # non-blank expansions compete within this frame
                preds, rows = self._advance(
                    bank, [max_hyp] * len(toks), toks)
                for tok, pr, row in zip(toks, preds, rows):
                    score = max_hyp.score + float(logp[tok])
                    lm_state = max_hyp.lm_state
                    if lm_vec is not None:
                        score += self.lm_weight * float(lm_vec[tok])
                        lm_state = self._lm_adv(lm_state, tok)
                    hyps.append(Hypothesis(
                        score=score,
                        yseq=max_hyp.yseq + [tok],
                        pred_out=pr, state_idx=row, lm_state=lm_state))
                hyps_max = max(h.score for h in hyps)
                kept_most_prob = [h for h in kept_hyps
                                  if h.score > hyps_max]
                if len(kept_most_prob) >= beam:
                    kept_hyps = kept_most_prob
                    break
        return kept_hyps

    def time_sync_decoding(self, enc_out) -> List[Hypothesis]:
        """TSD (`:313-407`): per frame, up to max_sym_exp expansion
        rounds; blank outcomes merge into A by yseq."""
        beam = self.beam_size
        h0, bank = self._init_hyp()
        B = [h0]
        for t in range(enc_out.shape[0]):
            A: List[Hypothesis] = []
            C = B
            for v in range(self.max_sym_exp):
                if not C:
                    break
                logp = self._joint(enc_out[t], C)
                D: List[Hypothesis] = []
                seq_A = [h.yseq for h in A]
                for i, hyp in enumerate(C):
                    new_score = hyp.score + float(logp[i, self.blank_id])
                    if hyp.yseq not in seq_A:
                        A.append(Hypothesis(
                            score=new_score, yseq=hyp.yseq[:],
                            pred_out=hyp.pred_out,
                            state_idx=hyp.state_idx,
                            lm_state=hyp.lm_state))
                        seq_A.append(hyp.yseq)
                    else:
                        pos = seq_A.index(hyp.yseq)
                        A[pos].score = float(np.logaddexp(
                            A[pos].score, new_score))
                if v < self.max_sym_exp - 1:
                    nb = np.asarray(logp[:, 1:]) if self.blank_id == 0 \
                        else logp
                    k = min(beam, nb.shape[1])
                    top = np.argpartition(-nb, k - 1, axis=1)[:, :k]
                    cand_hyps, cand_toks, cand_scores = [], [], []
                    for i, hyp in enumerate(C):
                        lm_vec = (self._lm_vec(hyp.lm_state)
                                  if self.use_lm else None)
                        for kk in top[i]:
                            tok = int(kk) + (1 if self.blank_id == 0
                                             else 0)
                            cand_hyps.append(hyp)
                            cand_toks.append(tok)
                            sc = hyp.score + float(nb[i, kk])
                            if lm_vec is not None:
                                # `:383-397` — LM only on expansions
                                sc += self.lm_weight * float(lm_vec[tok])
                            cand_scores.append(sc)
                    preds, rows = self._advance(bank, cand_hyps, cand_toks)
                    for h, tok, s, pr, row in zip(
                            cand_hyps, cand_toks, cand_scores, preds,
                            rows):
                        D.append(Hypothesis(
                            score=s, yseq=h.yseq + [tok],
                            pred_out=pr, state_idx=row,
                            lm_state=(self._lm_adv(h.lm_state, tok)
                                      if self.use_lm else ())))
                C = sorted(D, key=lambda x: x.score, reverse=True)[:beam]
            B = sorted(A, key=lambda x: x.score, reverse=True)[:beam]
        return B

    def align_length_sync_decoding(self, enc_out) -> List[Hypothesis]:
        """ALSD (`:408-512`): steps over i = t + u; hyps with the same
        yseq recombine; hyps reaching the last frame on blank become
        final."""
        beam = self.beam_size
        t_max = enc_out.shape[0]
        u_max = min(self.u_max, t_max - 1)
        h0, bank = self._init_hyp()
        B = [h0]
        final: List[Hypothesis] = []
        for i in range(t_max + u_max):
            B_, B_t = [], []
            for hyp in B:
                u = len(hyp.yseq) - 1
                t = i - u
                if t > t_max - 1:
                    continue
                B_.append(hyp)
                B_t.append(t)
            if not B_:
                continue
            enc = enc_out[torch.as_tensor(B_t, device=enc_out.device)]
            pred = torch.stack([h.pred_out for h in B_])
            logp = _host(self.joint_step(enc, pred))
            A: List[Hypothesis] = []
            cand_hyps, cand_toks, cand_scores = [], [], []
            for idx, hyp in enumerate(B_):
                new_hyp = Hypothesis(
                    score=hyp.score + float(logp[idx, self.blank_id]),
                    yseq=hyp.yseq[:], pred_out=hyp.pred_out,
                    state_idx=hyp.state_idx, lm_state=hyp.lm_state)
                A.append(new_hyp)
                if B_t[idx] == t_max - 1:
                    final.append(new_hyp)
                lm_vec = (self._lm_vec(hyp.lm_state)
                          if self.use_lm else None)
                nb = logp[idx, 1:] if self.blank_id == 0 else logp[idx]
                k = min(beam, nb.shape[0])
                top = np.argpartition(-nb, k - 1)[:k]
                for kk in top:
                    tok = int(kk) + (1 if self.blank_id == 0 else 0)
                    cand_hyps.append(hyp)
                    cand_toks.append(tok)
                    sc = hyp.score + float(nb[kk])
                    if lm_vec is not None:
                        sc += self.lm_weight * float(lm_vec[tok])
                    cand_scores.append(sc)
            if cand_hyps:
                preds, rows = self._advance(bank, cand_hyps, cand_toks)
                for h, tok, s, pr, row in zip(cand_hyps, cand_toks,
                                              cand_scores, preds, rows):
                    A.append(Hypothesis(
                        score=s, yseq=h.yseq + [tok],
                        pred_out=pr, state_idx=row,
                        lm_state=(self._lm_adv(h.lm_state, tok)
                                  if self.use_lm else ())))
            B = sorted(A, key=lambda x: x.score, reverse=True)[:beam]
            B = _recombine_hyps(B)
        return final if final else B

    def nsc_beam_search(self, enc_out) -> List[Hypothesis]:
        """N-step constrained beam search (`:514-675`, arXiv:2002.03577):
        per frame, prefix-search score folding, then ``nstep`` rounds where
        each round keeps blank-extensions (S) and the best ``beam``
        non-blank expansions (V) not duplicating a parent."""
        beam = self.beam_size
        h0, bank = self._init_hyp(extended=True)
        kept_hyps = [h0]
        beam_k = None
        for t in range(enc_out.shape[0]):
            enc_t = enc_out[t]
            hyps = self.prefix_search(
                sorted(kept_hyps, key=lambda x: len(x.yseq), reverse=True),
                enc_t)
            kept_hyps = []
            S: List[Hypothesis] = []
            Vexp: List[Hypothesis] = []
            for n in range(self.nstep):
                logp = self._joint(enc_t, hyps)
                if beam_k is None:
                    beam_k = min(beam, logp.shape[1] - 1)
                nb = logp.copy()
                nb[:, self.blank_id] = -np.inf
                top = np.argsort(-nb, axis=1)[:, :beam_k]
                for i, hyp in enumerate(hyps):
                    S.append(Hypothesis(
                        score=hyp.score + float(logp[i, self.blank_id]),
                        yseq=hyp.yseq[:], pred_out=hyp.pred_out,
                        state_idx=hyp.state_idx, dec_outs=hyp.dec_outs[:],
                        lm_state=hyp.lm_state))
                    lm_vec = (self._lm_vec(hyp.lm_state)
                              if self.use_lm else None)
                    for k in top[i]:
                        sc = hyp.score + float(nb[i, k])
                        if lm_vec is not None:
                            # `:650-669` — LM on the expansion only
                            sc += self.lm_weight * float(lm_vec[int(k)])
                        Vexp.append(Hypothesis(
                            score=sc,
                            yseq=hyp.yseq + [int(k)],
                            pred_out=hyp.pred_out,
                            state_idx=hyp.state_idx,
                            dec_outs=hyp.dec_outs[:],
                            lm_state=(self._lm_adv(hyp.lm_state, int(k))
                                      if self.use_lm else ())))
                Vexp.sort(key=lambda x: x.score, reverse=True)
                Vexp = _subtract(Vexp, hyps)[:beam]
                if not Vexp:
                    break
                preds, rows = self._advance(
                    bank, Vexp, [v.yseq[-1] for v in Vexp])
                if n < self.nstep - 1:
                    for v, pr, row in zip(Vexp, preds, rows):
                        v.dec_outs.append(pr)
                        v.pred_out = pr
                        v.state_idx = row
                    hyps = Vexp[:]
                else:
                    logp2 = self._joint_vecs(enc_t, list(preds))
                    for i, (v, pr, row) in enumerate(
                            zip(Vexp, preds, rows)):
                        # `:654` — multi-step runs settle the trailing
                        # blank with the advanced predictor output
                        if self.nstep != 1:
                            v.score += float(logp2[i, self.blank_id])
                        v.dec_outs.append(pr)
                        v.pred_out = pr
                        v.state_idx = row
            kept_hyps = sorted(S + Vexp, key=lambda x: x.score,
                               reverse=True)[:beam]
        return kept_hyps

    def modified_adaptive_expansion_search(self, enc_out
                                           ) -> List[Hypothesis]:
        """mAES (`:677-835`, Kim & Sung 2020): prune-by-value expansion
        selection (``expansion_gamma`` logp window, ``expansion_beta``
        extra slots); blank outcomes bank into list_b, non-blank expand
        up to ``nstep`` rounds."""
        beam = self.beam_size
        h0, bank = self._init_hyp(extended=True)
        kept_hyps = [h0]
        for t in range(enc_out.shape[0]):
            enc_t = enc_out[t]
            hyps = self.prefix_search(
                sorted(kept_hyps, key=lambda x: len(x.yseq), reverse=True),
                enc_t)
            kept_hyps = []
            list_b: List[Hypothesis] = []
            for n in range(self.nstep):
                logp = self._joint(enc_t, hyps)
                k_exp = _select_k_expansions(
                    hyps, logp, beam, self.expansion_gamma,
                    self.expansion_beta)
                list_exp: List[Hypothesis] = []
                for i, hyp in enumerate(hyps):
                    for k, new_score in k_exp[i]:
                        new_hyp = Hypothesis(
                            score=new_score, yseq=hyp.yseq[:],
                            pred_out=hyp.pred_out,
                            state_idx=hyp.state_idx,
                            dec_outs=hyp.dec_outs[:],
                            lm_state=hyp.lm_state,
                            lm_scores=hyp.lm_scores)
                        if k == self.blank_id:
                            list_b.append(new_hyp)
                        else:
                            if self.use_lm:
                                # `:773-777` — cached per-hyp dist
                                new_hyp.score += self.lm_weight * float(
                                    hyp.lm_scores[int(k)])
                            new_hyp.yseq.append(int(k))
                            list_exp.append(new_hyp)
                if not list_exp:
                    kept_hyps = sorted(list_b, key=lambda x: x.score,
                                       reverse=True)[:beam]
                    break
                preds, rows = self._advance(
                    bank, list_exp, [h.yseq[-1] for h in list_exp])
                if self.use_lm:
                    # `:800-803` — advance each expansion's LM by its
                    # last label and refresh the cached dist
                    lm_next = [self._lm_adv(h.lm_state, h.yseq[-1])
                               for h in list_exp]
                    lm_vecs = [self._lm_vec(st) for st in lm_next]
                if n < self.nstep - 1:
                    for i, (h, pr, row) in enumerate(
                            zip(list_exp, preds, rows)):
                        h.dec_outs.append(pr)
                        h.pred_out = pr
                        h.state_idx = row
                        if self.use_lm:
                            h.lm_state = lm_next[i]
                            h.lm_scores = lm_vecs[i]
                    hyps = list_exp[:]
                else:
                    logp2 = self._joint_vecs(enc_t, list(preds))
                    for i, (h, pr, row) in enumerate(
                            zip(list_exp, preds, rows)):
                        h.score += float(logp2[i, self.blank_id])
                        h.dec_outs.append(pr)
                        h.pred_out = pr
                        h.state_idx = row
                        if self.use_lm:
                            # reference quirk (`:826-828`): the final
                            # round assigns `lm_states` (a typo), so
                            # lm_state stays STALE while lm_scores is
                            # refreshed — reproduced for exact parity
                            h.lm_scores = lm_vecs[i]
                    kept_hyps = sorted(list_b + list_exp,
                                       key=lambda x: x.score,
                                       reverse=True)[:beam]
        return kept_hyps


def _is_prefix(x: List[int], pref: List[int]) -> bool:
    """`utils2.py:98-115` — strict proper-prefix check."""
    return len(pref) < len(x) and x[: len(pref)] == pref


def _subtract(x: List[Hypothesis], subset: List[Hypothesis]
              ) -> List[Hypothesis]:
    """`utils2.py:118-140` — drop elements of x whose yseq is in subset."""
    return [e for e in x if not any(e.yseq == s.yseq for s in subset)]


def _select_k_expansions(hyps: List[Hypothesis], logps: np.ndarray,
                         beam_size: int, gamma: float, beta: int):
    """`utils2.py:142-179` — per-hyp prune-by-value candidate selection:
    keep candidates within ``gamma`` of the best, top ``beam+beta``.  JAX
    walks the vocabulary in Python; here numpy does, in the same float64
    sums and the same order (a stable descending sort: equal scores keep
    ascending token ids, as Python's ``sorted(..., reverse=True)``)."""
    k_expansions = []
    for i, hyp in enumerate(hyps):
        scores = hyp.score + logps[i].astype(np.float64)
        keep = np.nonzero(scores.max() - gamma <= scores)[0]
        order = keep[np.argsort(-scores[keep], kind="stable")]
        k_expansions.append([(int(k), float(scores[k]))
                             for k in order[: beam_size + beta]])
    return k_expansions


def _recombine_hyps(hyps: List[Hypothesis]) -> List[Hypothesis]:
    """Merge duplicate yseq with log-add (`utils2.py recombine_hyps`)."""
    out: List[Hypothesis] = []
    seen = {}
    for hyp in hyps:
        key = tuple(hyp.yseq)
        if key in seen:
            out[seen[key]].score = float(np.logaddexp(
                out[seen[key]].score, hyp.score))
        else:
            seen[key] = len(out)
            out.append(hyp)
    return out
