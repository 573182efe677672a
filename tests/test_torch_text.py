"""The port's host-side inputs against the JAX package: tokenizers (on a
toy sentencepiece model written as in ``tests/test_tokenizers.py``), WAV
reading and resampling, Kaldi-text CMVN and config loading."""
import io
import json
import struct
import sys
import wave

import numpy as np
import pytest
import yaml

from paper_accurate_fast_cheap_tpu.data import pipeline as j_pipeline
from paper_accurate_fast_cheap_tpu.frontend import cmvn as j_cmvn
from paper_accurate_fast_cheap_tpu.text import tokenizers as j_tk
from paper_accurate_fast_cheap_tpu_torch.data import audio as t_audio
from paper_accurate_fast_cheap_tpu_torch.frontend import cmvn as t_cmvn
from paper_accurate_fast_cheap_tpu_torch.text import tokenizers as t_tk
from paper_accurate_fast_cheap_tpu_torch.utils.config import load_config


def _varint(v):
    out = b""
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _sp_piece(piece, score, ptype=1):
    pb = piece.encode("utf-8")
    body = (b"\x0a" + _varint(len(pb)) + pb          # field 1 string
            + b"\x15" + struct.pack("<f", score)      # field 2 float
            + b"\x18" + _varint(ptype))               # field 3 enum
    return b"\x0a" + _varint(len(body)) + body        # ModelProto field 1


PIECES = [
    ("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3),
    ("▁HE", -1.0, 1), ("LLO", -1.5, 1), ("▁WOR", -2.0, 1),
    ("LD", -1.0, 1), ("▁", -3.0, 1), ("H", -4.0, 1), ("E", -4.0, 1),
    ("L", -4.0, 1), ("O", -4.0, 1), ("W", -4.0, 1), ("R", -4.0, 1),
    ("D", -4.0, 1), ("<sw>", 0.0, 4), ("▁A", -1.2, 1),
]
LINES = ["HELLO WORLD", "A WORLD <sw> HELLO", "HOLD <unk> ZEBRA", ""]


@pytest.fixture(scope="module")
def spm_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("spm")
    model = d / "toy.model"
    model.write_bytes(b"".join(_sp_piece(*p) for p in PIECES))
    units = d / "units.txt"
    units.write_text("".join(f"{p} {i}\n" for i, (p, _, _)
                             in enumerate(PIECES)))
    return str(model), str(units)


@pytest.mark.parametrize("kind", ["char", "bpe", "rev_bpe", "whitespace"])
def test_tokenizers_match_jax(spm_files, kind):
    model, units = spm_files
    conf = {"tokenizer": kind,
            "tokenizer_conf": {"symbol_table_path": units,
                               "bpe_path": model}}
    tj, tt = j_tk.init_tokenizer(conf), t_tk.init_tokenizer(conf)
    assert tt.vocab_size() == tj.vocab_size()
    assert tt.symbol_table == tj.symbol_table
    for line in LINES:
        toks, ids = tt.tokenize(line)
        assert (toks, ids) == tj.tokenize(line)
        assert tt.detokenize(ids) == tj.detokenize(ids)
    assert (t_tk.parse_sentencepiece_model(model)
            == j_tk.parse_sentencepiece_model(model))


def test_unported_tokenizers_raise(tmp_path):
    """The paraformer and HuggingFace/whisper tokenizers are ported: both
    sides raise KeyError alike on a paraformer config without its symbol
    table, and a built one tokenizes and beautifies as JAX's."""
    for side in (j_tk, t_tk):
        with pytest.raises(KeyError):
            side.init_tokenizer({"tokenizer": "paraformer"})
    units = tmp_path / "units.txt"
    syms = ["<blank>", "<unk>", "你", "好", "世", "界", "hel@@", "lo",
            "wor@@", "ld", "ok", "<sos/eos>"]
    units.write_text("".join(f"{t} {i}\n" for i, t in enumerate(syms)))
    seg = tmp_path / "seg_dict"
    seg.write_text("hello\thel@@ lo\nworld\twor@@ ld\nok\tok\n")
    conf = {"tokenizer": "paraformer", "tokenizer_conf": {
        "symbol_table_path": str(units), "seg_dict_path": str(seg)}}
    tj, tt = j_tk.init_tokenizer(conf), t_tk.init_tokenizer(conf)
    for line in ("你好 hello world", "hello 世界 ok", "ok", "你好世界",
                 "world zebra 好"):
        assert tt.tokenize(line) == tj.tokenize(line)
        toks = tt.text2tokens(line)
        assert tt.tokens2text(toks) == tj.tokens2text(toks)
    for toks in (["你", "好"], ["hel@@", "lo", "wor@@", "ld"],
                 ["hel@@", "lo", "你", "ok", "<sos>"], ["<unk>", "1", "@"]):
        assert (t_tk.paraformer_beautify_result(toks)
                == j_tk.paraformer_beautify_result(toks))


def _unstub_modules(monkeypatch):
    """Some JAX-package tests put empty modules in ``sys.modules`` (stubs
    for the reference's imports: ``sentencepiece``, ``torchaudio``, ...);
    transformers' import asks for their specs and fails on them.  Hide the
    stubs for this test."""
    for name, mod in list(sys.modules.items()):
        if ("." not in name and name != "__main__" and mod is not None
                and getattr(mod, "__spec__", None) is None
                and not getattr(mod, "__file__", None)):
            monkeypatch.delitem(sys.modules, name)


def test_huggingface_tokenizer_matches_jax(tmp_path, monkeypatch):
    """The ``huggingface`` and ``whisper`` wrappers over one tokenizer
    saved here (no download): tokens, ids, text and the vocabulary."""
    _unstub_modules(monkeypatch)
    transformers = pytest.importorskip("transformers")
    letters = "abcdehlorw"
    vocab = {c: i for i, c in enumerate(letters)}
    vocab.update({"\u0120": len(vocab), "he": len(vocab) + 1,
                  "ll": len(vocab) + 2, "<|endoftext|>": len(vocab) + 3})
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "merges.txt").write_text("#version: 0.2\nh e\nl l\n")
    tok = transformers.GPT2Tokenizer(str(tmp_path / "vocab.json"),
                                     str(tmp_path / "merges.txt"))
    tok.save_pretrained(str(tmp_path / "tok"))
    for kind in ("huggingface", "whisper"):
        conf = {"tokenizer": kind,
                "tokenizer_conf": {"model": str(tmp_path / "tok")}}
        tj, tt = j_tk.init_tokenizer(conf), t_tk.init_tokenizer(conf)
        assert tt.vocab_size() == tj.vocab_size()
        assert tt.symbol_table == tj.symbol_table
        for line in ("hello world", "hold the ball"):
            assert tt.tokenize(line) == tj.tokenize(line)
            ids = tt.tokenize(line)[1]
            assert tt.detokenize(ids) == tj.detokenize(ids)


def _wav_bytes(x, sr, width=2, channels=1):
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(sr)
        scale = {2: 32767, 4: 2147483647}[width]
        dt = {2: np.int16, 4: np.int32}[width]
        w.writeframes((x * scale).astype(dt).tobytes())
    return buf.getvalue()


@pytest.mark.parametrize("width,channels,sr", [(2, 1, 16000), (4, 2, 8000)])
def test_wav_reading_and_resampling_match_jax(width, channels, sr):
    x = (np.random.RandomState(0).randn(1000 * channels) * 0.1).clip(-1, 1)
    data = _wav_bytes(x, sr, width, channels)
    wj, srj = j_pipeline._read_audio_bytes(data)
    wt, srt = t_audio.read_audio_bytes(data)
    assert srt == srj == sr
    np.testing.assert_array_equal(wt, wj)
    rt, _ = t_audio.resample_to(wt, srt, 16000)
    if sr != 16000:
        from scipy.signal import resample_poly

        g = np.gcd(sr, 16000)
        rj = resample_poly(wj, 16000 // g, sr // g).astype(np.float32)
        np.testing.assert_array_equal(rt, rj)
    # a FLAC magic on a body that is not FLAC: JAX's error, as JAX raises
    with pytest.raises(ValueError, match="flac decode failed"):
        j_pipeline._read_audio_bytes(b"fLaC" + data[4:])
    with pytest.raises(ValueError, match="flac decode failed"):
        t_audio.read_audio_bytes(b"fLaC" + data[4:])


def test_kaldi_cmvn_and_config_match_jax(tmp_path):
    rng = np.random.RandomState(1)
    dim, count = 6, 500.0
    means = rng.randn(dim) * count
    var = (rng.rand(dim) + 1.0) * count * 4
    p = tmp_path / "global_cmvn"
    p.write_text("[ " + " ".join(f"{v:.6f}" for v in means) + f" {count} "
                 + " ".join(f"{v:.6f}" for v in var) + " 0 ]\n")
    for a, b in zip(t_cmvn.load_cmvn(str(p), is_json=False),
                    j_cmvn.load_cmvn(str(p), is_json=False)):
        np.testing.assert_array_equal(a, b)
    conf = {"encoder_conf": {"output_size": 32}, "joint_conf": {
        "hat_joint": True}}
    (tmp_path / "c.json").write_text(json.dumps(conf))
    (tmp_path / "c.yaml").write_text(yaml.safe_dump(conf))
    assert load_config(str(tmp_path / "c.json")) == conf
    assert load_config(str(tmp_path / "c.yaml")) == conf
