"""CTC alignment utilities for long-form CTM timing (port of the JAX
``ops/ctc_utils.py``: the host helpers, the host aligner ``force_align``,
``get_blank_id`` and the batched CTC Viterbi on the device).

:func:`viterbi_path_device` is plain PyTorch on the device: a forward loop
over the T frames of (B, S) tensor ops that keeps int8 backpointers, then a
backtrack loop.  It replaces a ``lax.scan`` in the JAX package, not a Pallas
kernel.  Ties keep the source order stay > s-1 > s-2 (the first maximum
wins, as ``jnp.argmax`` does).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch


def insert_blank(labels: Sequence[int], blank_id: int = 0) -> np.ndarray:
    """y -> [blank, y1, blank, y2, ..., blank]."""
    out = np.full(2 * len(labels) + 1, blank_id, np.int64)
    out[1::2] = labels
    return out


def force_align(ctc_probs: np.ndarray, labels: Sequence[int],
                blank_id: int = 0) -> List[int]:
    """Viterbi alignment over the CTC graph on the host, in float64 numpy as
    the JAX package's ``force_align``: ctc_probs (T, V) log-probs, labels
    (U,) -> per-frame token ids (blank or label) of the best path."""
    ctc_probs = np.asarray(ctc_probs)
    T = ctc_probs.shape[0]
    y = insert_blank(list(labels), blank_id)
    S = len(y)
    lp = ctc_probs[:, y]
    allow2 = np.zeros(S, bool)
    allow2[2:] = (y[2:] != blank_id) & (y[2:] != y[:-2])
    neg = -np.inf
    srange = np.arange(S)
    bp = np.tile(srange, (T, 1))
    alpha = np.full(S, neg)
    alpha[0] = lp[0, 0]
    if S > 1:
        alpha[1] = lp[0, 1]
    # ties keep the source priority stay > s-1 > s-2 (first maximum)
    for t in range(1, T):
        c1 = np.full(S, neg)
        c1[1:] = alpha[:-1]
        c2 = np.full(S, neg)
        if S > 2:
            c2[2:] = np.where(allow2[2:], alpha[:-2], neg)
        stack = np.stack((alpha, c1, c2))
        k = np.argmax(stack, axis=0)
        alpha = stack[k, srange] + lp[t]
        bp[t] = srange - k
    s = S - 2 if S > 1 and alpha[S - 2] > alpha[S - 1] else S - 1
    path = np.zeros(T, np.int64)
    for t in range(T - 1, -1, -1):
        path[t] = y[s]
        if t > 0:
            s = bp[t, s]
    return [int(x) for x in path]


def alignment_to_token_spans(
    alignment: Sequence[int], blank_id: int = 0
) -> List[Tuple[int, int, int]]:
    """Collapse a frame alignment into (token, start_frame, end_frame_excl)."""
    spans = []
    prev = blank_id
    start = 0
    for t, a in enumerate(alignment):
        if a != prev:
            if prev != blank_id:
                spans.append((int(prev), start, t))
            start = t
            prev = a
    if prev != blank_id:
        spans.append((int(prev), start, len(alignment)))
    return spans


def gen_timestamps_from_peak(
    peaks: Sequence[int],
    max_duration: float,
    frame_rate: float = 0.04,
    max_token_duration: float = 1.0,
) -> List[Tuple[float, float]]:
    """Token (begin, end) times from CTC peak frames: midpoints between
    neighbouring peaks, capped at max_token_duration."""
    times = []
    half = max_token_duration / 2
    for i, p in enumerate(peaks):
        t = p * frame_rate
        if i == 0:
            start = max(0.0, t - half)
        else:
            start = max((peaks[i - 1] * frame_rate + t) / 2, t - half)
        if i == len(peaks) - 1:
            end = min(max_duration, t + half)
        else:
            end = min((t + peaks[i + 1] * frame_rate) / 2, t + half)
        times.append((round(start, 3), round(end, 3)))
    return times


def get_blank_id(configs: dict, symbol_table: dict) -> int:
    """The CTC blank: ``ctc_conf.ctc_blank_id``, else the symbol table's
    ``<blank>``, else 0."""
    blank_id = configs.get("ctc_conf", {}).get("ctc_blank_id")
    if blank_id is None:
        blank_id = symbol_table.get("<blank>", 0)
    return int(blank_id)


def viterbi_path_device(logp: torch.Tensor, lens: torch.Tensor,
                        y: torch.Tensor, allow2: torch.Tensor,
                        S: torch.Tensor) -> torch.Tensor:
    """Whole-batch CTC Viterbi on ``logp``'s device.

    logp (B, T, V) log-probs; lens, S (B,) int; y (B, Sp) int
    blank-interleaved label sequences; allow2 (B, Sp) bool skip-transition
    mask.  Rows ``t >= lens[b]`` are frozen.  Returns the (B, T) best-path
    token ids (int64).
    """
    neg = float("-inf")
    B, T, _ = logp.shape
    Sp = y.shape[1]
    dev = logp.device
    y = y.long()
    lp = torch.gather(logp.float(), 2, y[:, None, :].expand(B, T, Sp))
    valid = torch.arange(Sp, device=dev)[None, :] < S[:, None]
    lp = lp.masked_fill(~valid[:, None, :], neg)

    alpha = torch.full((B, Sp), neg, device=dev)
    alpha[:, 0] = lp[:, 0, 0]
    if Sp > 1:
        alpha[:, 1] = torch.where(S > 1, lp[:, 0, 1], neg)
    negcol = torch.full((B, 1), neg, device=dev)
    neg2 = torch.full((B, 2), neg, device=dev)
    lens = lens.to(dev)
    ks = torch.zeros(max(T - 1, 0), B, Sp, dtype=torch.int8, device=dev)
    for t in range(1, T):
        c1 = torch.cat([negcol, alpha[:, :-1]], dim=1)
        c2 = torch.cat([neg2, alpha[:, :-2]], dim=1)[:, :Sp]
        c2 = torch.where(allow2, c2, neg)
        # first maximum wins: stay, then s-1, then s-2
        take1 = c1 > alpha
        best = torch.where(take1, c1, alpha)
        take2 = c2 > best
        best = torch.where(take2, c2, best)
        k = torch.where(take2, 2, take1.to(torch.int8)).to(torch.int8)
        act = (t < lens)[:, None]
        alpha = torch.where(act, best + lp[:, t], alpha)
        ks[t - 1] = torch.where(act, k, 0)

    sm1 = (S - 1).long()
    sm2 = (S - 2).clamp(min=0).long()
    a_m1 = torch.gather(alpha, 1, sm1[:, None])[:, 0]
    a_m2 = torch.gather(alpha, 1, sm2[:, None])[:, 0]
    s = torch.where((S > 1) & (a_m2 > a_m1), sm2, sm1)
    path = torch.empty(B, T, dtype=torch.int64, device=dev)
    for t in range(T - 1, 0, -1):
        path[:, t] = torch.gather(y, 1, s[:, None])[:, 0]
        s = s - torch.gather(ks[t - 1], 1, s[:, None])[:, 0].long()
    path[:, 0] = torch.gather(y, 1, s[:, None])[:, 0]
    return path


def force_align_device_tokens(logp: torch.Tensor, lens, tokens: torch.Tensor,
                              tok_len: torch.Tensor, blank_id: int = 0):
    """Forced alignment whose labels are device tensors (the beam's top
    hypothesis), with no trip through the host.

    logp (B, T, V); lens (B,) valid frames; tokens (B, Lmax) ids (garbage
    past tok_len); tok_len (B,).  Returns (path (B, T) int64, ok (B,)
    bool); a row with tok_len == 0 or 2*tok_len+1 > 2*Lmax+1 is not ok and
    its path is all blank.
    """
    B, Lmax = tokens.shape
    dev = logp.device
    Sp = 2 * Lmax + 1
    pos = torch.arange(Sp, device=dev)
    tok_idx = ((pos - 1) // 2).clamp(min=0)
    gathered = tokens.long()[:, tok_idx.clamp(max=Lmax - 1)]
    tok_len = tok_len.to(dev).long()
    is_tok = (pos % 2 == 1)[None, :] & (tok_idx[None, :] < tok_len[:, None])
    y = torch.where(is_tok, gathered, blank_id)
    # skip (s-2) allowed at non-blank states whose label differs from two
    # states back (the previous label)
    y2 = torch.cat([torch.full((B, 2), blank_id, dtype=y.dtype, device=dev),
                    y[:, :-2]], dim=1)
    allow2 = (pos[None, :] >= 2) & (y != blank_id) & (y != y2)
    S = 2 * tok_len + 1
    ok = (tok_len > 0) & (S <= Sp)
    path = viterbi_path_device(logp, torch.as_tensor(lens, device=dev), y,
                               allow2, torch.where(ok, S, 1))
    return torch.where(ok[:, None], path, blank_id), ok


def force_align_batch_device(logp: torch.Tensor, lens, labels_list,
                             blank_id: int = 0, s_bucket: int = 256):
    """Batched forced alignment with the DP on ``logp``'s device.

    logp (B, T, V) log-probs; lens (B,) valid frame counts; labels_list the
    per-row hypothesis token ids.  Returns per-row frame alignments (lists
    of length lens[b]).  The state axis is padded to a multiple of
    ``s_bucket``, as the JAX version does.
    """
    B, T, V = logp.shape
    lens = np.asarray(lens, np.int64)
    S_real = np.asarray([2 * len(lab) + 1 for lab in labels_list], np.int64)
    Sp = max(s_bucket, int(-(-int(S_real.max()) // s_bucket) * s_bucket))
    y = np.full((B, Sp), blank_id, np.int64)
    allow2 = np.zeros((B, Sp), bool)
    for b, labels in enumerate(labels_list):
        yb = insert_blank(list(labels), blank_id)
        y[b, : len(yb)] = yb
        if len(yb) > 2:
            allow2[b, 2: len(yb)] = ((yb[2:] != blank_id)
                                     & (yb[2:] != yb[:-2]))
    dev = logp.device
    path = viterbi_path_device(
        logp, torch.from_numpy(lens).to(dev), torch.from_numpy(y).to(dev),
        torch.from_numpy(allow2).to(dev), torch.from_numpy(S_real).to(dev))
    path = path.cpu().numpy()
    return [[int(x) for x in path[b, : int(lens[b])]] for b in range(B)]
