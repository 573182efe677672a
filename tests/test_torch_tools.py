"""The port's scoring and latency tools, its websocket load bench and its
train-time feature augmentation.

``tools/wer`` and ``bin/compute_wer`` against the JAX package's on fixed
texts (word, GigaSpeech, uppercase and character scoring; the CLI's
printed lines); ``tools/latency_metrics`` against JAX's on seeded CTC
log-probs and a frame alignment file, and its CLI on a tiny model;
``bin/ws_bench`` against ``bin/serve.py`` on localhost (2 concurrent, 3
WAVs, ``-t`` scored through ``compute_wer``); ``frontend/augment`` and
``featurize(train=True)``: masks inside JAX's bounds, and ``train=False``
unchanged.
"""
import json
import logging
import threading
import wave

import numpy as np
import pytest
import torch

from paper_accurate_fast_cheap_tpu.bin import compute_wer as j_cw
from paper_accurate_fast_cheap_tpu.tools import latency_metrics as j_lat
from paper_accurate_fast_cheap_tpu.tools import wer as j_wer
from paper_accurate_fast_cheap_tpu_torch import api as t_api
from paper_accurate_fast_cheap_tpu_torch.bin import compute_wer as t_cw
from paper_accurate_fast_cheap_tpu_torch.bin import serve as t_serve
from paper_accurate_fast_cheap_tpu_torch.bin import ws_bench
from paper_accurate_fast_cheap_tpu_torch.frontend import augment
from paper_accurate_fast_cheap_tpu_torch.frontend import (
    pipeline as t_pipeline)
from paper_accurate_fast_cheap_tpu_torch.models import factory as t_factory
from paper_accurate_fast_cheap_tpu_torch.tools import latency_metrics as t_lat
from paper_accurate_fast_cheap_tpu_torch.tools import wer as t_wer

WORDS = ["UH", "the", "cat", "<UNK>", "sat-on", "mat", "um", "a", "<COMMA>",
         "dog", "我们", "好"]


def _texts(seed, n=12):
    rng = np.random.RandomState(seed)
    refs, hyps = {}, {}
    for i in range(n):
        ref = list(rng.choice(WORDS, rng.randint(0, 9)))
        hyp = [w for w in ref if rng.rand() > 0.25]
        for _ in range(rng.randint(0, 3)):
            hyp.insert(rng.randint(0, len(hyp) + 1), rng.choice(WORDS))
        refs[f"u{i}"], hyps[f"u{i}"] = " ".join(ref), " ".join(hyp)
    hyps.pop("u3")
    return refs, hyps


@pytest.mark.parametrize("flags", [{}, {"gigaspeech_filter": True},
                                   {"to_upper": True}, {"to_char": True}])
def test_wer_matches_jax(flags):
    refs, hyps = _texts(0)
    jt, jp = j_wer.compute_wer(refs, hyps, **flags)
    tt, tp = t_wer.compute_wer(refs, hyps, **flags)
    assert tt.errors > 0
    assert vars(tt) == vars(jt)
    assert {k: vars(v) for k, v in tp.items()} == {
        k: vars(v) for k, v in jp.items()}
    assert t_wer.longform_summary(tp) == j_wer.longform_summary(jp)
    for s in refs.values():
        assert t_wer.characterize(s) == j_wer.characterize(s)
        assert (t_wer.gigaspeech_post_process(s)
                == j_wer.gigaspeech_post_process(s))


def test_compute_wer_cli_matches_jax(tmp_path, capsys):
    refs, hyps = _texts(1)
    for name, d in (("ref", refs), ("hyp", hyps)):
        (tmp_path / name).write_text(
            "".join(f"{k}\t{v}\n" for k, v in d.items()), encoding="utf-8")
    for extra in (["--char", "-v"], ["--giga", "--longform"], ["--upper"]):
        argv = [str(tmp_path / "ref"), str(tmp_path / "hyp")] + extra
        assert j_cw.main(argv) == 0
        want = capsys.readouterr().out
        assert t_cw.main(argv) == 0
        assert capsys.readouterr().out == want


def test_latency_metrics_match_jax(tmp_path, caplog):
    rng = np.random.RandomState(3)
    z = rng.randn(40, 9).astype(np.float32) * 3
    logp = z - np.log(np.exp(z).sum(-1, keepdims=True))
    for toks in ([], [3], [2, 5, 5, 7], [1, 2, 3, 4, 5, 6, 7, 8]):
        assert (t_lat.ctc_peak_emission_times(logp, toks)
                == j_lat.ctc_peak_emission_times(logp, toks))
    ali = tmp_path / "ali.txt"
    lines, stamps = [], {}
    for i in range(7):
        n = rng.randint(8, 30)
        frames = ["<blank>"] * (4 * n + rng.randint(-2, 3))
        hyp = [0] * n
        for j in sorted(rng.choice(n, rng.randint(1, 5), replace=False)):
            hyp[j] = int(rng.randint(1, 9))
            frames[max(0, min(len(frames) - 1, 4 * j - rng.randint(0, 9)))] \
                = f"t{hyp[j]}"
        if i == 5:
            hyp = hyp[: n // 2]         # frame counts too far apart
        lines.append(f"k{i} " + " ".join(frames))
        if i != 6:                      # missing key
            stamps[f"k{i}"] = hyp
    ali.write_text("\n".join(lines) + "\n")
    want_ali = j_lat.read_alignments(str(ali))
    assert t_lat.read_alignments(str(ali)) == want_ali
    for a in want_ali.values():
        assert (t_lat.alignment_token_times(a)
                == j_lat.alignment_token_times(a))
    for h in stamps.values():
        assert (t_lat.streaming_token_times(h)
                == j_lat.streaming_token_times(h))
    jp, jc = j_lat.compare_with_alignment(stamps, want_ali)
    tp, tc = t_lat.compare_with_alignment(stamps, want_ali)
    assert tc == jc and jc["valid"] > 0 and jc["not_found"] == 1
    assert [vars(u) for u in tp] == [vars(u) for u in jp]
    assert t_lat.latency_report(tp) == j_lat.latency_report(jp)
    logs = []
    for fn, per in ((j_lat.print_report, jp), (t_lat.print_report, tp)):
        caplog.clear()
        with caplog.at_level(logging.INFO):
            fn(per)
        logs.append([r.getMessage() for r in caplog.records])
    assert logs[0] == logs[1] and len(logs[0]) == 21


VOCAB = 12
CONFIG = {
    "model": "transducer",
    "encoder_conf": dict(output_size=32, attention_heads=2, linear_units=64,
                         num_blocks=1, cnn_module_kernel=7,
                         selfattention_layer_type="rwkv_tmix60_bidirectional",
                         rwkv_do_bfloat16=False),
    "predictor_conf": {"embed_size": 32, "output_size": 32,
                       "hidden_size": 32, "num_layers": 1},
    "joint_conf": {"join_dim": 32},
    "model_conf": {"ctc_weight": 0.3, "transducer_weight": 0.7,
                   "attention_weight": 0.0},
    "tokenizer": "char",
    "tokenizer_conf": {"symbol_table_path": "units.txt"},
    "dataset_conf": {"fbank_conf": {"num_mel_bins": 80}},
}


def _write_wav(path, wav):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((wav * 32767).astype(np.int16).tobytes())


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A run directory: train.yaml, char units, epoch_0000.pt (seeded
    weights, the CTC blank bias lowered so the decode emits tokens), and 3
    WAVs with a reference trn."""
    d = tmp_path_factory.mktemp("ws")
    (d / "units.txt").write_text(
        "<blank> 0\n<unk> 1\n<sos/eos> 2\n▁ 3\n" + "".join(
            f"{c} {4 + i}\n" for i, c in enumerate("abcdefgh")))
    (d / "train.yaml").write_text(json.dumps(CONFIG))
    model, _ = t_factory.init_model(CONFIG, VOCAB, 80, device="cpu")
    sd = model.state_dict()
    sd["ctc.ctc_lo.bias"][0] -= 3.0
    torch.save(sd, str(d / "epoch_0000.pt"))
    rng = np.random.RandomState(4)
    scp, trn = [], []
    for i, secs in enumerate((1.3, 0.7, 1.9)):
        path = d / f"w{i}.wav"
        _write_wav(path, (rng.randn(int(secs * 16000)) * 0.1).clip(-1, 1))
        scp.append(f"w{i} {path}\n")
        trn.append(f"w{i}\tab cd\n")
    (d / "wav.scp").write_text("".join(scp))
    (d / "ref.trn").write_text("".join(trn))
    return d


def test_ws_bench_against_the_server(model_dir, capsys):
    m = t_api.load_model(str(model_dir), device="cpu")
    srv = t_serve.serve(m, host="127.0.0.1", port=0)
    port = srv.server_address[1]
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    hyp = model_dir / "hyp.trn"
    try:
        assert ws_bench.main(["-p", str(port), "-w",
                              str(model_dir / "wav.scp"), "-s", str(hyp),
                              "-n", "2", "-t",
                              str(model_dir / "ref.trn")]) == 0
    finally:
        srv.stop()
    out = capsys.readouterr().out
    for line in ("utts=3 total_duration=3.90s", "failed         : 0",
                 "For one request:", "median   :", "Overall ->"):
        assert line in out, line
    got = dict(ln.split("\t") for ln in hyp.read_text().splitlines())
    assert list(got) == ["w0", "w1", "w2"]
    from paper_accurate_fast_cheap_tpu_torch.data.audio import (
        read_wav_bytes)
    wavs = [read_wav_bytes((model_dir / f"w{i}.wav").read_bytes())[0]
            for i in range(3)]
    assert [got[f"w{i}"] for i in range(3)] == [
        m.transcribe_batch([w])[0] for w in wavs]
    assert any(got.values())


def test_latency_metrics_cli(model_dir, capsys):
    ali = model_dir / "ali.txt"
    ali.write_text("w0 " + " ".join(["<blank>"] * 128) + "\n")
    cfg = model_dir / "abs.json"
    cfg.write_text(json.dumps(dict(CONFIG, tokenizer_conf={
        "symbol_table_path": str(model_dir / "units.txt")})))
    assert t_lat.main(["--config", str(cfg),
                       "--checkpoint", str(model_dir / "epoch_0000.pt"),
                       "--wav_scp", str(model_dir / "wav.scp"),
                       "--alignment", str(ali), "--chunk_size", "4",
                       "--device", "cpu"]) == 0
    assert "first_token" in capsys.readouterr().out


def test_spec_augment_bounds():
    g = torch.Generator().manual_seed(0)
    B, T, D = 6, 90, 40
    lens = torch.tensor([90, 70, 33, 5, 1, 60])
    x = torch.ones(B, T, D)
    y = augment.spec_aug(x, lens, g, num_t_mask=2, num_f_mask=2, max_t=12,
                         max_f=5)
    t_masked = (y == 0).all(dim=2)
    f_masked = (y == 0).all(dim=1)
    for b in range(B):
        rows = torch.nonzero(t_masked[b]).flatten()
        # each time span starts inside the utterance and is 1..12 wide
        assert len(rows) <= 2 * 12 and rows.min() < max(int(lens[b]), 1)
        assert 1 <= int(f_masked[b].sum()) <= 2 * 5
    assert t_masked.any(dim=1).all()
    # spec_sub copies earlier frames of the input into its spans
    xs = torch.arange(T, dtype=torch.float32)[None, :, None].expand(B, T, D)
    ys = augment.spec_sub(xs, lens, g, max_t=10, num_t_sub=3)
    assert (ys <= xs).all() and (ys < xs).any()
    changed = (ys != xs).any(dim=2)
    for b in range(B):
        rows = torch.nonzero(changed[b]).flatten()
        assert len(rows) <= 3 * 10
    trimmed = augment.spec_trim_length(lens, g, max_t=20)
    assert ((trimmed <= lens) & (trimmed >= lens - 20)).all()
    assert (trimmed[lens < 4] == lens[lens < 4]).all()


def test_train_features():
    conf = {"fbank_conf": {"dither": 1.0}, "spec_aug": True,
            "spec_aug_conf": {"num_t_mask": 2, "max_t": 10},
            "spec_sub": True}
    rng = np.random.RandomState(2)
    wavs = torch.from_numpy((rng.randn(3, 16000) * 0.1).astype(np.float32))
    lens = torch.tensor([16000, 12000, 9000])
    feat = t_pipeline.make_feature_fn(conf, device="cpu")
    plain = t_pipeline.make_feature_fn({}, device="cpu")
    f0, l0 = feat(wavs, lens)
    p0, pl = plain(wavs, lens)
    # train=False ignores the config's augmentation and dither
    assert torch.equal(f0, p0) and torch.equal(l0, pl)
    with pytest.raises(ValueError, match="generator"):
        feat(wavs, lens, train=True)
    a, la = feat(wavs, lens, train=True,
                 generator=torch.Generator().manual_seed(1))
    b, _ = feat(wavs, lens, train=True,
                generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and torch.equal(la, l0)
    assert not torch.equal(a, f0) and (a == 0).any()
