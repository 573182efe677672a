"""The port's shard writer, data tools, hub and native WER alignment against
the JAX package's: ``bin/make_shard`` (wav, flac and opus entries) writes
JAX's tar members and payloads, each ``bin/data_tools`` subcommand JAX's
output, ``hub`` resolves and caches as JAX's (plus ``api.load_model`` by
name giving ``Model.from_dir``'s text), and ``tools/wer.align_words``'
native counts equal its Python DP's."""
import io
import json
import os
import tarfile
import wave

import numpy as np
import pytest
import torch

from paper_accurate_fast_cheap_tpu.bin import data_tools as j_tools
from paper_accurate_fast_cheap_tpu.bin import make_shard as j_shard
from paper_accurate_fast_cheap_tpu.data import codecs as j_codecs
from paper_accurate_fast_cheap_tpu.data import flac as j_flac
from paper_accurate_fast_cheap_tpu_torch import api, hub
from paper_accurate_fast_cheap_tpu_torch.bin import data_tools as t_tools
from paper_accurate_fast_cheap_tpu_torch.bin import make_shard as t_shard
from paper_accurate_fast_cheap_tpu_torch.models import factory
from paper_accurate_fast_cheap_tpu_torch.tools import wer as t_wer


def _wav_bytes(x, sr):
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((x * 32767).astype(np.int16).tobytes())
    return buf.getvalue()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Five recordings in five containers (one WAV at 8 kHz), a text, a
    segments file and a GigaSpeech-style JSON."""
    d = tmp_path_factory.mktemp("corpus")
    rng = np.random.RandomState(5)

    def sig(n):
        t = np.arange(n) / 16000.0
        return (0.3 * np.sin(2 * np.pi * rng.uniform(200, 900) * t)
                + 0.02 * rng.randn(n)).astype(np.float32)

    files = {
        "a": ("a.wav", _wav_bytes(sig(12000), 16000)),
        "b": ("b.flac", j_flac.encode_flac(sig(9000), 16000)),
        "c": ("c.wav", _wav_bytes(sig(6000), 8000)),
        "d": ("d.mp3", j_codecs.encode_mp3(sig(8000), 16000)),
        "e": ("e.opus", j_codecs.encode_ogg_opus(sig(8000), 16000)),
    }
    scp = []
    for k, (name, data) in files.items():
        (d / name).write_bytes(data)
        scp.append(f"{k} {d / name}\n")
    (d / "wav.scp").write_text("".join(scp))
    (d / "text").write_text("a hello there\nb how are\nc you\nd fine\n"
                            "e thanks UM <COMMA>\n")
    (d / "segments").write_text("a_0 a 0.0 0.4\na_1 a 0.4 0.7\nb_0 b 0.1 "
                                "0.5\nz_0 z 0 1\n")
    (d / "seg_text").write_text("a_0 one\na_1 two three\nb_0 four\n")
    # a kaldi-style data dir with a duplicate key and an empty transcript
    kd = d / "kaldi"
    kd.mkdir()
    (kd / "wav.scp").write_text("".join(scp) + f"x {d / 'missing.wav'}\n")
    (kd / "text").write_text("a hi\nb \nc you\nc again\nd x\ne y\nx z\n")
    return d


def _tar_members(path):
    with tarfile.open(path) as tf:
        return [(m.name, tf.extractfile(m).read()) for m in tf.getmembers()]


@pytest.mark.parametrize("fmt", ["wav", "flac", "opus"])
def test_make_shard_matches_jax(corpus, tmp_path, fmt):
    outs = {}
    for name, mod in (("jax", j_shard), ("port", t_shard)):
        out = tmp_path / name
        argv = ["--wav_scp", str(corpus / "wav.scp"),
                "--text", str(corpus / "text"), "--output_dir", str(out),
                "--audio_format", fmt, "--num_utts_per_shard", "2",
                "--resample", "16000"]
        assert mod.main(argv) == 0
        shards = (out / "shards.txt").read_text().split()
        outs[name] = [(os.path.basename(s), _tar_members(s))
                      for s in shards]
    assert len(outs["jax"]) == 3
    assert [m for _, ms in outs["jax"] for m, _ in ms] == [
        f"{k}.{ext}" for k in "abcde" for ext in ("txt", fmt)]
    assert outs["port"] == outs["jax"]


def test_make_shard_segments_match_jax(corpus, tmp_path):
    outs = {}
    for name, mod in (("jax", j_shard), ("port", t_shard)):
        out = tmp_path / name
        assert mod.main(["--wav_scp", str(corpus / "wav.scp"),
                         "--text", str(corpus / "seg_text"),
                         "--segments", str(corpus / "segments"),
                         "--output_dir", str(out), "--audio_format",
                         "flac"]) == 0
        outs[name] = _tar_members(out / "shard_000000.tar")
    assert [m for m, _ in outs["jax"]] == ["a_0.txt", "a_0.flac", "a_1.txt",
                                           "a_1.flac", "b_0.txt", "b_0.flac"]
    assert outs["port"] == outs["jax"]


def _both(capsys, argv_of):
    """Run JAX's and the port's data_tools on their own output paths; the
    return codes, stdout and every written file must be equal."""
    res = {}
    for name, mod in (("jax", j_tools), ("port", t_tools)):
        argv, out = argv_of(name)
        rc = mod.main(argv)
        printed = capsys.readouterr()
        files = {}
        if out is not None:
            if os.path.isdir(out):
                for f in sorted(os.listdir(out)):
                    with open(os.path.join(out, f), "rb") as fh:
                        files[f] = fh.read()
            else:
                with open(out, "rb") as fh:
                    files[""] = fh.read()
        text = [printed.out, printed.err]
        if out is not None:   # the runs' own output paths
            text = [t.replace(str(out), "<out>") for t in text]
        res[name] = (rc, *text, files)
    assert res["port"] == res["jax"]
    return res["port"]


def test_data_tools_match_jax(corpus, tmp_path, capsys):
    c = corpus
    rc, _, _, files = _both(capsys, lambda n: (
        ["make_raw_list", "--wav_scp", str(c / "wav.scp"), "--text",
         str(c / "text"), "--output", str(tmp_path / f"{n}.list")],
        tmp_path / f"{n}.list"))
    assert rc == 0 and files[""].count(b"\n") == 5
    _both(capsys, lambda n: (
        ["make_raw_list", "--wav_scp", str(c / "wav.scp"), "--text",
         str(c / "seg_text"), "--segments", str(c / "segments"),
         "--output", str(tmp_path / f"{n}_seg.list")],
        tmp_path / f"{n}_seg.list"))
    wavs = tmp_path / "wavs.scp"
    wavs.write_text(f"a {c / 'a.wav'}\nc {c / 'c.wav'}\n")
    _, out, err, _ = _both(capsys, lambda n: (
        ["wav2dur", "--wav_scp", str(wavs)], None))
    assert out == "a 0.750\nc 0.750\n" and "total_hours" in err
    # analyze over the raw list (all five containers decode) and a shard
    raw = tmp_path / "port.list"
    _, out, _, _ = _both(capsys, lambda n: (
        ["analyze", "--data", str(raw), "--data_type", "raw"], None))
    assert out.startswith("utts 5 ")
    assert t_shard.main(["--wav_scp", str(c / "wav.scp"), "--text",
                         str(c / "text"), "--output_dir",
                         str(tmp_path / "sh")]) == 0
    _both(capsys, lambda n: (
        ["analyze", "--data", str(tmp_path / "sh" / "shards.txt")], None))
    hyp = tmp_path / "hyp_text"
    hyp.write_text("ep1_0 hello there\nep1_1 world\nep2_0 x\n\n")
    _both(capsys, lambda n: (
        ["segments_to_files", "--input", str(hyp), "--out_dir",
         str(tmp_path / f"{n}_files"), "--ext", "txt"],
        tmp_path / f"{n}_files"))
    _both(capsys, lambda n: (
        ["segment_scp", "--segments", str(c / "segments"), "--input",
         str(c / "wav.scp"), "--output", str(tmp_path / f"{n}_seg.scp")],
        tmp_path / f"{n}_seg.scp"))
    meta = {"audios": [
        {"aid": "a", "path": "a.wav", "sample_rate": 16000,
         "duration": 0.75, "segments": [
             {"sid": "a_0", "begin_time": 0.0, "end_time": 0.4,
              "text_tn": "HELLO <COMMA>", "subsets": ["{XS}", "{S}"]}]},
        {"aid": "c", "path": "c.wav", "sample_rate": 8000,
         "duration": 0.75, "segments": []},
        {"aid": "q", "path": "nowhere.wav", "sample_rate": 16000}]}
    (c / "meta.json").write_text(json.dumps(meta))
    _both(capsys, lambda n: (
        ["gigaspeech_meta", "--input_json", str(c / "meta.json"),
         "--output_dir", str(tmp_path / f"{n}_meta")],
        tmp_path / f"{n}_meta"))
    rc, out, _, _ = _both(capsys, lambda n: (
        ["validate", "--dir", str(c / "kaldi"), "--check_audio"], None))
    assert rc == 1 and "duplicate key c" in out
    rc, out, _, _ = _both(capsys, lambda n: (
        ["validate", "--data", str(raw), "--check_audio"], None))
    assert rc == 0 and "unknown audio magic" in out


def _toy_model_dir(d):
    vocab = 40
    (d / "units.txt").write_text("".join(f"u{i} {i}\n"
                                         for i in range(vocab)))
    config = {
        "model": "transducer", "encoder": "conformer",
        "encoder_conf": dict(output_size=32, attention_heads=2,
                             linear_units=64, num_blocks=1,
                             selfattention_layer_type="rwkv_tmix60"),
        "predictor": "rnn",
        "predictor_conf": {"embed_size": 32, "output_size": 32,
                           "hidden_size": 32, "num_layers": 1},
        "joint_conf": {"join_dim": 32}, "decoder": None,
        "tokenizer": "char",
        "tokenizer_conf": {"symbol_table_path": "units.txt"},
        "dataset_conf": {"fbank_conf": {"num_mel_bins": 80, "dither": 0.0}},
    }
    (d / "train.yaml").write_text(json.dumps(config))
    model, _ = factory.init_model(config, vocab, 80, device="cpu",
                                  generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        model.ctc.ctc_lo.weight.mul_(3.0)
    torch.save(model.state_dict(), str(d / "epoch_0000.pt"))


def test_hub_resolve_and_cache(tmp_path, monkeypatch):
    """Hub surface (`wenet/cli/hub.py` parity), as the JAX package's test:
    local dirs pass through, registered names download once into the
    cache, archives unpack flat; the port's cache root is its own."""
    monkeypatch.delenv("PAFC_HOME", raising=False)
    assert hub.cache_root().endswith(".pafc_torch")
    monkeypatch.setenv("PAFC_HOME", str(tmp_path / "cache"))
    mdir = tmp_path / "local_model"
    mdir.mkdir()
    (mdir / "train.yaml").write_text("model: asr_model\n")
    assert hub.resolve(str(mdir)) == str(mdir)
    with pytest.raises(KeyError):
        hub.get_model_by_name("nope")
    tar_p = tmp_path / "m.tar.gz"
    with tarfile.open(tar_p, "w:gz") as tf:
        data = b"model: asr_model\n"
        info = tarfile.TarInfo("bundle/train.yaml")
        info.size = len(data)
        tf.addfile(info, io.BytesIO(data))
    hub.register_model("toy_en", f"file://{tar_p}")
    try:
        got = hub.get_model_by_name("toy_en")
        assert got.endswith("toy_en")
        assert (tmp_path / "cache" / "toy_en" / "train.yaml").exists()
        # second call = cache hit (delete the archive to prove no re-fetch)
        tar_p.unlink()
        assert hub.get_model_by_name("toy_en") == got
    finally:
        hub.Assets.pop("toy_en", None)
    # a plain tar archive by URL, cached under its stem
    plain = tmp_path / "plain.tar"
    with tarfile.open(plain, "w") as tf:
        info = tarfile.TarInfo("bundle/train.yaml")
        info.size = len(data)
        tf.addfile(info, io.BytesIO(data))
    assert hub.resolve(f"file://{plain}") == str(tmp_path / "cache" /
                                                 "plain")
    # $PAFC_HOME/assets.json registers names too
    (tmp_path / "cache" / "assets.json").write_text(
        json.dumps({"toy_en": "file:///nonexistent.tar.gz"}))
    try:
        assert hub.get_model_by_name("toy_en") == got
    finally:
        hub.Assets.pop("toy_en", None)


def test_load_model_by_name_and_url(tmp_path, monkeypatch):
    monkeypatch.setenv("PAFC_HOME", str(tmp_path / "cache"))
    local = tmp_path / "toy"
    local.mkdir()
    _toy_model_dir(local)
    tar_p = tmp_path / "toy_model.tar.gz"
    with tarfile.open(tar_p, "w:gz") as tf:
        for f in sorted(os.listdir(local)):
            tf.add(str(local / f), arcname=f"toy/{f}")
    wav = (0.2 * np.sin(np.arange(16000) * 0.07)
           + 0.05 * np.random.RandomState(2).randn(16000)).astype(np.float32)
    want = api.Model.from_dir(str(local), device="cpu").transcribe(wav)
    assert want["text"]
    hub.register_model("toy_hub", f"file://{tar_p}")
    try:
        got = api.load_model("toy_hub", device="cpu").transcribe(wav)
    finally:
        hub.Assets.pop("toy_hub", None)
    assert got == want
    # a direct archive URL, cached under the archive's name
    got = api.load_model(f"file://{tar_p}", device="cpu").transcribe(wav)
    assert got == want
    assert (tmp_path / "cache" / "toy_model" / "epoch_0000.pt").exists()


def test_native_alignment_matches_python_dp():
    rng = np.random.RandomState(7)
    vocab = [f"w{i}" for i in range(6)]
    cases = [([], []), (["a"], []), ([], ["a", "b"])]
    for _ in range(40):
        r = list(rng.choice(vocab, rng.randint(0, 30)))
        h = list(rng.choice(vocab, rng.randint(0, 30)))
        cases.append((r, h))
    for r, h in cases:
        assert t_wer.align_words(r, h) == t_wer.align_words_python(r, h)
    # the scorer's totals on a long pair
    r = list(rng.choice(vocab, 600))
    h = [w for w in r if rng.rand() > 0.1]
    st = t_wer.align_words(r, h)
    assert st == t_wer.align_words_python(r, h)
    assert st.dele >= 30
