"""Time-synchronous joint CTC + attention one-pass decoding (port of the
JAX ``decode/joint_decoding.py``).

The reference's ``BeamSearchTimeSync``: a CTC prefix search, time
synchronous, in which every prefix extension is also scored by the
attention decoder (cached per prefix); the combined score is
``ctc_weight * ctc_prefix + att_weight * att``.  The decoder's one-step
calls are batched over the uncached prefixes of a frame (one call a frame,
on the caller's device); its log-probs and the CTC row come to the host in
float32 before any ranking, so JAX's ``np.argsort`` orders hold.  An
optional lexicon constraint drops prefixes whose last word is neither a
word (at a word boundary) nor a word prefix (mid-word), unless that would
drop all of them (the reference's fallback).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from paper_accurate_fast_cheap_tpu_torch.decode.search import (
    DecodeResult, _host)


def joint_decoding(
    decoder_one_step: Callable,
    enc_out: torch.Tensor,     # (1, T, D) single utterance
    enc_len,
    ctc_probs,                 # (T, V) log-probs
    sos: int,
    eos: int,
    beam_size: int = 10,
    ctc_weight: float = 0.5,
    att_weight: float = 0.5,
    blank_id: int = 0,
    words: Optional[Dict[str, int]] = None,
    word_prefixes: Optional[Dict[str, int]] = None,
    tok_to_str: Optional[Dict[int, str]] = None,
    word_start_char: str = "\u2581",
) -> DecodeResult:
    """Single-utterance time-sync joint search.

    Lexicon constraint (`beam_search_timesync.py:135-139,395-422`): when
    ``words``/``word_prefixes``/``tok_to_str`` are given, candidate
    prefixes whose last (possibly partial) word is neither a valid word
    (at a word boundary) nor a valid word prefix (mid-word) are dropped —
    unless that would drop everything, in which case the unconstrained
    candidates survive (the reference's fallback)."""
    T = int(enc_len[0]) if hasattr(enc_len, "__getitem__") else int(enc_len)
    ctc_probs = _host(ctc_probs)
    # per-prefix CTC scores (blank-ending, nonblank-ending) + cached att
    # log-prob vector over next tokens
    beams: Dict[tuple, List[float]] = {(): [0.0, -np.inf]}
    att_cache: Dict[tuple, np.ndarray] = {}
    att_score: Dict[tuple, float] = {(): 0.0}

    def ensure_att(prefixes: List[tuple]):
        missing = [p for p in prefixes if p not in att_cache]
        if not missing:
            return
        maxu = max(len(p) for p in missing) + 1
        n = len(missing)
        ys = np.full((n, maxu), eos, np.int32)
        ys[:, 0] = sos
        ys_lens = np.zeros((n,), np.int32)
        for i, p in enumerate(missing):
            ys[i, 1 : 1 + len(p)] = p
            ys_lens[i] = len(p) + 1
        dev = enc_out.device
        enc_rep = enc_out.expand(n, -1, -1)
        lens_rep = torch.full((n,), T, dtype=torch.int32, device=dev)
        with torch.no_grad():
            logp = _host(decoder_one_step(
                enc_rep, lens_rep, torch.from_numpy(ys).to(dev),
                torch.from_numpy(ys_lens).to(dev)))
        for i, p in enumerate(missing):
            att_cache[p] = logp[i]

    for t in range(T):
        lp = ctc_probs[t]
        top = np.argsort(lp)[-beam_size:]
        ensure_att(list(beams.keys()))
        nxt: Dict[tuple, List[float]] = {}
        for prefix, (pb, pnb) in beams.items():
            p_tot = np.logaddexp(pb, pnb)
            # blank / repeat keep the prefix
            ent = nxt.setdefault(prefix, [-np.inf, -np.inf])
            ent[0] = np.logaddexp(ent[0], p_tot + lp[blank_id])
            if prefix:
                ent[1] = np.logaddexp(ent[1], pnb + lp[prefix[-1]])
            for u in top:
                u = int(u)
                if u == blank_id:
                    continue
                new = prefix + (u,)
                base = pb if (prefix and u == prefix[-1]) else p_tot
                e2 = nxt.setdefault(new, [-np.inf, -np.inf])
                e2[1] = np.logaddexp(e2[1], base + lp[u])
                if new not in att_score:
                    att_score[new] = att_score[prefix] + float(
                        att_cache[prefix][u]
                    )

        def combined(item):
            prefix, (pb, pnb) = item
            return (ctc_weight * np.logaddexp(pb, pnb)
                    + att_weight * att_score.get(prefix, -np.inf))

        if words is not None and tok_to_str is not None:
            good = {p: v for p, v in nxt.items()
                    if _lexicon_ok(p, words, word_prefixes or {},
                                   tok_to_str, word_start_char)}
            if good:                      # reference fallback: never empty
                nxt = good
        beams = dict(sorted(nxt.items(), key=combined,
                            reverse=True)[:beam_size])

    # final ranking includes the attention eos score
    ensure_att(list(beams.keys()))
    best_prefix, best_score = (), -np.inf
    for prefix, (pb, pnb) in beams.items():
        s = ctc_weight * np.logaddexp(pb, pnb) + att_weight * (
            att_score.get(prefix, -np.inf)
            + float(att_cache[prefix][eos])
        )
        if s > best_score:
            best_prefix, best_score = prefix, s
    return DecodeResult(tokens=list(best_prefix), score=float(best_score))


def _lexicon_ok(prefix: tuple, words: Dict[str, int],
                word_prefixes: Dict[str, int],
                tok_to_str: Dict[int, str], word_start: str) -> bool:
    """`beam_search_timesync.py:395-422`: walk back to the last word-start
    piece; at a boundary the PREVIOUS word must be in `words` (or end in
    a dash), mid-word the partial word must be in `word_prefixes`."""
    if not prefix:
        return True
    last_piece = tok_to_str.get(prefix[-1], "")
    if last_piece.startswith(word_start):
        # new word just started: validate the previous word
        if len(prefix) == 1:
            return True
        prev_piece = tok_to_str.get(prefix[-2], "")
        if prev_piece.endswith("-"):
            return True
        word = ""
        for i in range(2, len(prefix) + 1):
            piece = tok_to_str.get(prefix[-i], "")
            word = piece + word
            if piece.startswith(word_start):
                break
        return word.replace(word_start, "") in words \
            or word in words
    # mid-word: the running partial word must be a valid prefix
    word = ""
    for i in range(1, len(prefix) + 1):
        piece = tok_to_str.get(prefix[-i], "")
        word = piece + word
        if piece.startswith(word_start):
            break
    return word.replace(word_start, "") in word_prefixes \
        or word in word_prefixes
