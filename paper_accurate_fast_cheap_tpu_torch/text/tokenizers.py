"""Tokenizers (port of the JAX ``text/tokenizers.py``): the sentencepiece
``.model`` protobuf reader, the unigram Viterbi encoder, and the char,
bpe, rev_bpe, paraformer (seg-dict words, the paraformer beautifier),
whitespace and HuggingFace/whisper tokenizers that ``init_tokenizer`` builds
from a WeNet-style config (the last wraps ``transformers.AutoTokenizer``,
imported when one is built).

The reader and the encoder need no ``sentencepiece`` wheel; when the real
package is importable it is preferred, as in the JAX package.
"""
from __future__ import annotations

import os
import re
import struct
from typing import Dict, List, Optional, Tuple

WS = "▁"  # sentencepiece meta symbol


# ---------------------------------------------------------------- protobuf

def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def parse_sentencepiece_model(path: str) -> List[Tuple[str, float, int]]:
    """Parse a sentencepiece ModelProto: returns [(piece, score, type)].

    piece types: 1=NORMAL, 2=UNKNOWN, 3=CONTROL, 4=USER_DEFINED, 6=BYTE.
    """
    with open(path, "rb") as f:
        buf = f.read()
    pieces = []
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:  # repeated SentencePiece
            ln, pos = _read_varint(buf, pos)
            sub = buf[pos : pos + ln]
            pos += ln
            piece, score, ptype = "", 0.0, 1
            sp = 0
            while sp < len(sub):
                stag, sp = _read_varint(sub, sp)
                sfield, swire = stag >> 3, stag & 7
                if sfield == 1 and swire == 2:
                    sl, sp = _read_varint(sub, sp)
                    piece = sub[sp : sp + sl].decode("utf-8")
                    sp += sl
                elif sfield == 2 and swire == 5:
                    (score,) = struct.unpack("<f", sub[sp : sp + 4])
                    sp += 4
                elif sfield == 3 and swire == 0:
                    ptype, sp = _read_varint(sub, sp)
                else:  # skip unknown
                    if swire == 0:
                        _, sp = _read_varint(sub, sp)
                    elif swire == 2:
                        sl, sp = _read_varint(sub, sp)
                        sp += sl
                    elif swire == 5:
                        sp += 4
                    elif swire == 1:
                        sp += 8
                    else:
                        raise ValueError(f"bad wire type {swire}")
            pieces.append((piece, score, ptype))
        else:  # skip other top-level fields (trainer/normalizer specs)
            if wire == 0:
                _, pos = _read_varint(buf, pos)
            elif wire == 2:
                ln, pos = _read_varint(buf, pos)
                pos += ln
            elif wire == 5:
                pos += 4
            elif wire == 1:
                pos += 8
            else:
                raise ValueError(f"bad wire type {wire}")
    return pieces


class UnigramEncoder:
    """Viterbi unigram segmentation over a sentencepiece piece inventory."""

    def __init__(self, pieces: List[Tuple[str, float, int]]):
        self.pieces = pieces
        self.piece_score: Dict[str, float] = {}
        self.unk_id = 0
        min_score = 0.0
        for i, (p, s, t) in enumerate(pieces):
            if t == 2:
                self.unk_id = i
            if t in (1, 4):  # NORMAL / USER_DEFINED are matchable
                self.piece_score[p] = s
                min_score = min(min_score, s)
        self.max_len = max((len(p) for p in self.piece_score), default=1)
        self.unk_score = min_score - 10.0  # sentencepiece kUnkPenalty

    def encode(self, text: str, add_dummy_prefix: bool = True) -> List[str]:
        if not text:
            return []
        if add_dummy_prefix:
            text = " " + text
        text = re.sub(r" +", " ", text).replace(" ", WS)
        n = len(text)
        best = [(-1e30, -1)] * (n + 1)
        best[0] = (0.0, 0)
        for i in range(n):
            sc, _ = best[i]
            if sc <= -1e29:
                continue
            upper = min(n, i + self.max_len)
            for j in range(i + 1, upper + 1):
                piece = text[i:j]
                ps = self.piece_score.get(piece)
                if ps is not None:
                    cand = sc + ps
                    if cand > best[j][0]:
                        best[j] = (cand, i)
            # unknown single char fallback
            cand = sc + self.unk_score
            if cand > best[i + 1][0]:
                best[i + 1] = (cand, i)
        # backtrack
        toks = []
        j = n
        while j > 0:
            i = best[j][1]
            toks.append(text[i:j])
            j = i
        return toks[::-1]


class SentencePieceLike:
    """Minimal spm.SentencePieceProcessor equivalent (unigram)."""

    def __init__(self, model_path: str):
        self.pieces = parse_sentencepiece_model(model_path)
        self.enc = UnigramEncoder(self.pieces)
        self._id = {p: i for i, (p, _, _) in enumerate(self.pieces)}

    def encode(self, text: str, out_type=str):
        toks = self.enc.encode(text)
        if out_type is str:
            return toks
        return [self._id.get(t, self.enc.unk_id) for t in toks]

    def id_to_piece(self, i: int) -> str:
        return self.pieces[i][0]

    def piece_to_id(self, p: str) -> int:
        return self._id.get(p, self.enc.unk_id)

    def get_piece_size(self) -> int:
        return len(self.pieces)


def load_spm(model_path: str):
    try:
        import sentencepiece as spm

        sp = spm.SentencePieceProcessor()
        sp.load(model_path)
        return sp
    except (ImportError, AttributeError):
        # AttributeError covers stub/namespace modules without the real API
        return SentencePieceLike(model_path)


# ---------------------------------------------------------------- tokenizers

def read_symbol_table(path_or_dict) -> Dict[str, int]:
    if isinstance(path_or_dict, dict):
        return dict(path_or_dict)
    table = {}
    with open(path_or_dict, encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split()
            if len(parts) == 2:
                table[parts[0]] = int(parts[1])
            elif len(parts) == 1:
                table[parts[0]] = len(table)
    return table


def read_non_lang_symbols(path: Optional[str]) -> List[str]:
    if path is None:
        return []
    with open(path, encoding="utf-8") as f:
        return [ln.strip() for ln in f if ln.strip()]


class BaseTokenizer:
    def tokenize(self, line: str):
        tokens = self.text2tokens(line)
        return tokens, self.tokens2ids(tokens)

    def detokenize(self, ids: List[int]):
        tokens = self.ids2tokens(ids)
        return self.tokens2text(tokens), tokens


class CharTokenizer(BaseTokenizer):
    """Character tokenizer over a units.txt symbol table
    (`wenet/text/char_tokenizer.py`)."""

    def __init__(self, symbol_table, non_lang_syms=None,
                 split_with_space: bool = False, connect_symbol: str = "",
                 unk: str = "<unk>"):
        self._symbol_table = read_symbol_table(symbol_table)
        self.non_lang_syms = (
            read_non_lang_symbols(non_lang_syms)
            if isinstance(non_lang_syms, (str, type(None)))
            else list(non_lang_syms or [])
        )
        self.pattern = (
            re.compile(r"(\[[^\[\]]+\]|<[^<>]+>|{[^{}]+})")
            if self.non_lang_syms else None
        )
        self.split_with_space = split_with_space
        self.connect_symbol = connect_symbol
        self.unk = unk
        self._char_dict = {v: k for k, v in self._symbol_table.items()}

    def text2tokens(self, line: str) -> List[str]:
        line = line.strip()
        parts = self.pattern.split(line) if self.pattern else [line]
        tokens = []
        for part in parts:
            if part in self.non_lang_syms:
                tokens.append(part)
                continue
            if self.split_with_space:
                tokens.extend(p for p in part.split() if p)
            else:
                tokens.extend(ch for ch in part)
        return tokens

    def tokens2text(self, tokens: List[str]) -> str:
        return self.connect_symbol.join(tokens)

    def tokens2ids(self, tokens: List[str]) -> List[int]:
        unk_id = self._symbol_table.get(self.unk, 0)
        return [self._symbol_table.get(t, unk_id) for t in tokens]

    def ids2tokens(self, ids: List[int]) -> List[str]:
        return [self._char_dict[i] for i in ids]

    def vocab_size(self) -> int:
        return len(self._symbol_table)

    @property
    def symbol_table(self) -> Dict[str, int]:
        return self._symbol_table


class BpeTokenizer(CharTokenizer):
    """Sentencepiece tokenization with ids from the units symbol table."""

    def __init__(self, bpe_model, symbol_table, non_lang_syms=None,
                 split_with_space: bool = False, connect_symbol: str = "",
                 unk: str = "<unk>"):
        super().__init__(symbol_table, non_lang_syms, split_with_space,
                         connect_symbol, unk)
        self._model_path = bpe_model
        self._sp = None

    def _sp_model(self):
        if self._sp is None:
            self._sp = load_spm(self._model_path)
        return self._sp

    def text2tokens(self, line: str) -> List[str]:
        return self._sp_model().encode(line.strip(), out_type=str)

    def tokens2text(self, tokens: List[str]) -> str:
        return "".join(tokens).replace(WS, " ").strip()


class RevBpeTokenizer(BpeTokenizer):
    """`rev_bpe`: strips `<sw>`, rewrites `<unk>` -> `<unknown>`
    (`rev_bpe_tokenizer.py:41-81`)."""

    def __init__(self, *args, remove_sw: bool = True,
                 replace_unk_as_unknown: bool = True, **kw):
        super().__init__(*args, **kw)
        self.remove_sw = remove_sw
        self.replace_unk_as_unknown = replace_unk_as_unknown

    def text2tokens(self, line: str) -> List[str]:
        line = line.strip()
        if self.remove_sw:
            line = line.replace("<sw>", "").replace("  ", " ").strip()
        if self.replace_unk_as_unknown:
            line = line.replace("<unk>", "<unknown>")
        return self._sp_model().encode(line, out_type=str)

    def tokens2text(self, tokens: List[str]) -> str:
        return self.connect_symbol.join(tokens).replace(WS, " ").strip()


def _is_cjkish(s: str) -> bool:
    """`wenet/paraformer/search.py:10-13` — NOTE: the reference compares
    whole (possibly multi-char) strings lexicographically against the CJK
    range, so a token qualifies iff its first char does; reproduced
    verbatim for output parity."""
    return "一" <= s <= "鿿" or "0" <= s <= "9" \
        or s == "@"


def _strip_specials(tok: str) -> str:
    for s in (" ", "</s>", "<s>", "<unk>", "<OOV>"):
        tok = tok.replace(s, "")
    return tok


def _all_cjk(word) -> bool:
    """`search.py:16-32`; str input iterates chars, list input iterates
    whole tokens (the reference relies on both behaviors)."""
    cleaned = [_strip_specials(t) for t in word]
    return bool(cleaned) and all(_is_cjkish(c) for c in cleaned)


def _all_alpha(word) -> bool:
    """`search.py:35-54` — whole-unit str.isalpha(), with CJK units
    (alpha in Python but in the CJK range) explicitly rejected."""
    cleaned = [_strip_specials(t) for t in word]
    return bool(cleaned) and all(
        (c.isalpha() or c == "'") and not (c.isalpha() and _is_cjkish(c))
        for c in cleaned)


def paraformer_beautify_result(tokens: List[str]) -> str:
    """Join paraformer tokens into display text, gluing `@@` BPE pieces and
    spacing alpha words (`wenet/paraformer/search.py:57-104`)."""
    mid = [t for t in tokens if t not in ("<sos>", "<eos>", "<blank>")]
    out: List[str] = []
    word = ""
    if _all_cjk(mid):
        out = [t.replace(" ", "") for t in mid]
    elif _all_alpha(mid):
        for t in mid:
            if "@@" in t:
                word += t.replace("@@", "")
            else:
                out.append(word + t)
                out.append(" ")
                word = ""
    else:
        alpha_blank = False
        for t in mid:
            if _all_cjk([t]):
                if alpha_blank:
                    out.pop()
                out.append(t)
                alpha_blank = False
            elif "@@" in t:
                word += t.replace("@@", "")
                alpha_blank = False
            elif _all_alpha([t]):
                out.append(word + t)
                out.append(" ")
                word = ""
                alpha_blank = True
            else:
                out.append(t)
                alpha_blank = False
    return "".join(out).strip()


def tokenize_by_seg_dict(seg_dict: Dict[str, str], txt: str) -> List[str]:
    """CJK chars pass through; non-CJK words map through the seg dict
    (`wenet/text/tokenize_utils.py:22-65`, upper=False)."""
    pattern = re.compile(r"([一-鿿])")
    tokens: List[str] = []
    for part in pattern.split(txt):
        if not part.strip():
            continue
        if pattern.fullmatch(part):
            tokens.append(part)
            continue
        for word in part.split():
            word = word.strip()
            if word in seg_dict:
                tokens.extend(seg_dict[word].split(" "))
            else:
                tokens.append(word)
    return tokens


def read_seg_dict(path) -> Dict[str, str]:
    """`wenet/text/paraformer_tokenizer.py:8-15` — tab-separated
    word -> space-joined pieces."""
    table = {}
    with open(path, encoding="utf8") as fin:
        for line in fin:
            arr = line.strip().split("\t")
            assert len(arr) == 2, f"bad seg_dict line: {line!r}"
            table[arr[0]] = arr[1]
    return table


class ParaformerTokenizer(CharTokenizer):
    """Paraformer seg-dict tokenizer
    (`wenet/text/paraformer_tokenizer.py:18-52`): char tokenizer whose
    text2tokens routes non-CJK words through a seg dict and whose
    tokens2text uses the paraformer beautifier."""

    def __init__(self, symbol_table, seg_dict=None,
                 split_with_space: bool = False, connect_symbol: str = "",
                 unk: str = "<unk>"):
        super().__init__(symbol_table, None, split_with_space,
                         connect_symbol, unk)
        self.seg_dict = (read_seg_dict(seg_dict)
                         if isinstance(seg_dict, (str, os.PathLike))
                         else seg_dict)

    def text2tokens(self, line: str) -> List[str]:
        assert self.seg_dict is not None
        line = line.strip()
        parts = self.pattern.split(line) if self.pattern else [line]
        tokens: List[str] = []
        for part in parts:
            if not part.strip():
                continue
            if part in self.non_lang_syms:
                tokens.append(part)
            else:
                tokens.extend(tokenize_by_seg_dict(self.seg_dict, part))
        return tokens

    def tokens2text(self, tokens: List[str]) -> str:
        return paraformer_beautify_result(tokens)


class WhitespaceTokenizer(BaseTokenizer):
    """Plain word tokenizer (for tests / word-level models)."""

    def __init__(self, symbol_table):
        self._symbol_table = read_symbol_table(symbol_table)
        self._rev = {v: k for k, v in self._symbol_table.items()}

    def text2tokens(self, line):
        return line.strip().split()

    def tokens2text(self, tokens):
        return " ".join(tokens)

    def tokens2ids(self, tokens):
        unk = self._symbol_table.get("<unk>", 0)
        return [self._symbol_table.get(t, unk) for t in tokens]

    def ids2tokens(self, ids):
        return [self._rev[i] for i in ids]

    def vocab_size(self):
        return len(self._symbol_table)

    @property
    def symbol_table(self):
        return self._symbol_table


class HuggingFaceTokenizer(BaseTokenizer):
    """Wrap a transformers tokenizer
    (`wenet/text/hugging_face_tokenizer.py`)."""

    def __init__(self, model: str):
        from transformers import AutoTokenizer

        self.tok = AutoTokenizer.from_pretrained(model)

    def text2tokens(self, line):
        return self.tok.tokenize(line)

    def tokens2text(self, tokens):
        return self.tok.convert_tokens_to_string(tokens)

    def tokens2ids(self, tokens):
        return self.tok.convert_tokens_to_ids(tokens)

    def ids2tokens(self, ids):
        return self.tok.convert_ids_to_tokens(ids)

    def vocab_size(self):
        return len(self.tok)

    @property
    def symbol_table(self):
        return self.tok.get_vocab()


def init_tokenizer(configs) -> BaseTokenizer:
    """Build a tokenizer from a WeNet-style config."""
    tt = configs.get("tokenizer", "char")
    conf = configs.get("tokenizer_conf", {})
    if tt == "char":
        return CharTokenizer(
            conf["symbol_table_path"],
            conf.get("non_lang_syms_path"),
            split_with_space=conf.get("split_with_space", False),
        )
    if tt == "bpe":
        return BpeTokenizer(
            conf["bpe_path"], conf["symbol_table_path"],
            conf.get("non_lang_syms_path"),
            split_with_space=conf.get("split_with_space", False),
        )
    if tt == "rev_bpe":
        return RevBpeTokenizer(
            conf["bpe_path"], conf["symbol_table_path"],
            conf.get("non_lang_syms_path"),
            split_with_space=conf.get("split_with_space", False),
            remove_sw=conf.get("remove_sw", True),
            replace_unk_as_unknown=conf.get("replace_unk_as_unknown", True),
        )
    if tt == "huggingface":
        return HuggingFaceTokenizer(conf["model"])
    if tt == "whisper":
        return HuggingFaceTokenizer(conf.get("model", "openai/whisper-base"))
    if tt == "paraformer":
        return ParaformerTokenizer(
            conf["symbol_table_path"], conf.get("seg_dict_path"),
            split_with_space=conf.get("split_with_space", False),
        )
    if tt == "whitespace":
        return WhitespaceTokenizer(conf["symbol_table_path"])
    raise ValueError(f"unknown tokenizer type {tt!r}")
