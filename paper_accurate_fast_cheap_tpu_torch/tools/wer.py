"""WER and CER scoring with the GigaSpeech rules (port of the JAX
``tools/wer.py``): Levenshtein word alignment with uniform costs and its
substitution / deletion / insertion counts, GigaSpeech post-processing
(uppercase, hyphen split, no fillers, ``<UNK>`` or punctuation tags), CER
units, and the long-form macro summary.

``align_words`` takes its counts from the native C++ DP
(``native/pafc_native.cpp: levenshtein_counts``): the long-form scorer
aligns ten-thousand-word episodes.  ``align_words_python`` is its plain
version, the tests' reference, with the same back-pointer rule: on a cost
tie a cell takes the diagonal, then the deletion, then the insertion, so
the counts equal JAX's.
"""
from __future__ import annotations

import dataclasses
import unicodedata
from typing import Dict, List, Sequence, Tuple

import numpy as np

CONVERSATIONAL_FILLERS = [
    "UH", "UHH", "UM", "EH", "MM", "HM", "AH", "HUH", "HA", "ER", "OOF",
    "HEE", "ACH", "EEE", "EW",
]
UNK_TAGS = ["<UNK>", "<unk>"]
GIGASPEECH_PUNCTUATIONS = [
    "<COMMA>", "<PERIOD>", "<QUESTIONMARK>", "<EXCLAMATIONPOINT>",
]
GIGASPEECH_GARBAGE_TAGS = ["<SIL>", "<NOISE>", "<MUSIC>", "<OTHER>"]
NON_SCORING_WORDS = set(
    CONVERSATIONAL_FILLERS + UNK_TAGS + GIGASPEECH_PUNCTUATIONS
    + GIGASPEECH_GARBAGE_TAGS)


def gigaspeech_post_process(text: str) -> str:
    """Uppercase, hyphen -> space, drop the non-scoring words."""
    text = text.upper().replace("-", " ")
    return " ".join(w for w in text.split() if w not in NON_SCORING_WORDS)


@dataclasses.dataclass
class AlignStats:
    ref_len: int = 0
    sub: int = 0
    ins: int = 0
    dele: int = 0

    @property
    def errors(self) -> int:
        return self.sub + self.ins + self.dele

    @property
    def wer(self) -> float:
        return self.errors / max(self.ref_len, 1)

    def __iadd__(self, other: "AlignStats"):
        self.ref_len += other.ref_len
        self.sub += other.sub
        self.ins += other.ins
        self.dele += other.dele
        return self


def align_words(ref: Sequence[str], hyp: Sequence[str]) -> AlignStats:
    """Levenshtein alignment (sub = del = ins = 1) and its op counts, from
    the native DP."""
    from paper_accurate_fast_cheap_tpu_torch import native

    ids: Dict[str, int] = {}
    for w in ref:
        ids.setdefault(w, len(ids))
    for w in hyp:
        ids.setdefault(w, len(ids))
    sub, dele, ins = native.levenshtein_counts(
        np.asarray([ids[w] for w in ref], np.int32),
        np.asarray([ids[w] for w in hyp], np.int32))
    return AlignStats(ref_len=len(ref), sub=sub, ins=ins, dele=dele)


def align_words_python(ref: Sequence[str],
                       hyp: Sequence[str]) -> AlignStats:
    """``align_words`` in Python: the same DP and back-pointer rule."""
    R, H = len(ref), len(hyp)
    # back-pointers: 0 diagonal, 1 deletion (up), 2 insertion (left)
    bp = np.zeros((R + 1, H + 1), np.uint8)
    bp[0, 1:] = 2
    bp[1:, 0] = 1
    prev = list(range(H + 1))
    for i in range(1, R + 1):
        cur = [i] + [0] * H
        r = ref[i - 1]
        row = bp[i]
        for j in range(1, H + 1):
            best, op = prev[j - 1] + (r != hyp[j - 1]), 0
            if prev[j] + 1 < best:
                best, op = prev[j] + 1, 1
            if cur[j - 1] + 1 < best:
                best, op = cur[j - 1] + 1, 2
            cur[j] = best
            row[j] = op
        prev = cur
    st = AlignStats(ref_len=R)
    i, j = R, H
    while i > 0 or j > 0:
        op = bp[i, j]
        if i > 0 and j > 0 and op == 0:
            st.sub += ref[i - 1] != hyp[j - 1]
            i, j = i - 1, j - 1
        elif i > 0 and (op == 1 or j == 0):
            st.dele += 1
            i -= 1
        else:
            st.ins += 1
            j -= 1
    return st


_CER_SPACES = [" ", "\t", "\r", "\n"]
_CER_PUNCTS = [
    "!", ",", "?", "、", "。", "！", "，", "；", "？", "：", "「", "」",
    "︰", "『", "』", "《", "》",
]


def characterize(string: str) -> List[str]:
    """CER units: CJK letters one per unit, ASCII runs as words, ``<...>``
    tags whole, punctuation and space dropped."""
    res: List[str] = []
    i = 0
    while i < len(string):
        char = string[i]
        if char in _CER_PUNCTS:
            i += 1
            continue
        cat1 = unicodedata.category(char)
        if cat1 in ("Zs", "Cn") or char in _CER_SPACES:
            i += 1
            continue
        if cat1 == "Lo":
            res.append(char)
            i += 1
            continue
        sep = ">" if char == "<" else " "
        j = i + 1
        while j < len(string):
            c = string[j]
            if ord(c) >= 128 or c in _CER_SPACES or c == sep:
                break
            j += 1
        if j < len(string) and string[j] == ">":
            j += 1
        res.append(string[i:j])
        i = j
    return res


def read_trn(path: str) -> Dict[str, str]:
    """'key text...' per line."""
    out = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split(maxsplit=1)
            if not parts:
                continue
            out[parts[0]] = parts[1] if len(parts) > 1 else ""
    return out


def compute_wer(refs: Dict[str, str], hyps: Dict[str, str],
                gigaspeech_filter: bool = False, to_upper: bool = False,
                to_char: bool = False
                ) -> Tuple[AlignStats, Dict[str, AlignStats]]:
    total = AlignStats()
    per_utt = {}
    for key, ref_text in refs.items():
        hyp_text = hyps.get(key, "")
        if gigaspeech_filter:
            ref_text = gigaspeech_post_process(ref_text)
            hyp_text = gigaspeech_post_process(hyp_text)
        elif to_upper:
            ref_text, hyp_text = ref_text.upper(), hyp_text.upper()
        if to_char:
            ref_toks, hyp_toks = characterize(ref_text), characterize(
                hyp_text)
        else:
            ref_toks, hyp_toks = ref_text.split(), hyp_text.split()
        st = align_words(ref_toks, hyp_toks)
        per_utt[key] = st
        total += st
    return total, per_utt


def longform_summary(per_file: Dict[str, AlignStats]) -> Dict[str, float]:
    """Micro-averaged WER, its ins/del/sub rates and the stdev of the
    per-file WERs."""
    total = AlignStats()
    wers = []
    for st in per_file.values():
        total += st
        wers.append(st.wer)
    return {
        "num_files": len(per_file),
        "wer": total.wer,
        "ins_rate": total.ins / max(total.ref_len, 1),
        "del_rate": total.dele / max(total.ref_len, 1),
        "sub_rate": total.sub / max(total.ref_len, 1),
        "wer_stdev": float(np.std(wers)) if wers else 0.0,
        "ref_words": total.ref_len,
    }
