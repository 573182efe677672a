"""The port's long-form CLI on real recording formats.

A tiny transducer of the flagship family (2 bi-RWKV conformer blocks of
width 32, a 1-layer LSTM predictor, blank-biased heads scaled x2 so the
beam emits varied tokens) decodes the same PCM16 audio from a WAV and from
its FLAC: ``bin/recognize_wav`` must write byte-identical TXT and CTM
files.  An Ogg/Opus and an MP3 copy decode through the same CLI.  An
unknown container is skipped with a warning by the data pipeline's
``decode_wav`` and raises ``ValueError`` in the CLI, as in the JAX
package."""
import io
import json
import logging
import wave

import numpy as np
import pytest
import torch

from paper_accurate_fast_cheap_tpu_torch.bin import recognize_wav as t_cli
from paper_accurate_fast_cheap_tpu_torch.data import codecs, flac
from paper_accurate_fast_cheap_tpu_torch.data import pipeline as t_pipeline
from paper_accurate_fast_cheap_tpu_torch.frontend.features import fbank
from paper_accurate_fast_cheap_tpu_torch.models import factory

VOCAB = 60


def _config(units, cmvn):
    return {
        "model": "transducer",
        "encoder": "conformer",
        "encoder_conf": dict(
            output_size=32, attention_heads=2, linear_units=64, num_blocks=2,
            input_layer="conv2d", pos_enc_layer_type="rel_pos",
            cnn_module_kernel=15, cnn_module_norm="layer_norm",
            selfattention_layer_type="rwkv_tmix60_bidirectional"),
        "decoder": None,
        "predictor": "rnn",
        "predictor_conf": {"embed_size": 32, "output_size": 32,
                           "embed_dropout": 0.1, "hidden_size": 32,
                           "num_layers": 1, "dropout": 0.1},
        "joint_conf": {"join_dim": 32},
        "model_conf": {"ctc_weight": 0.3, "transducer_weight": 0.7,
                       "attention_weight": 0.0},
        "tokenizer": "whitespace",
        "tokenizer_conf": {"symbol_table_path": units},
        "cmvn": "global_cmvn",
        "cmvn_conf": {"cmvn_file": cmvn, "is_json_cmvn": True},
        "dataset_conf": {"fbank_conf": {"num_mel_bins": 80, "dither": 0.0}},
    }


def _pcm16_wav(x, sr=16000):
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((x * 32767).astype(np.int16).tobytes())
    return buf.getvalue()


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    d = tmp_path_factory.mktemp("formats")
    units = d / "units.txt"
    units.write_text("<blank> 0\n<unk> 1\n" + "".join(
        f"{'▁w' if i % 3 == 0 else 'c'}{i} {i}\n" for i in range(2, VOCAB)))
    # tone bursts of random pitch under a 5 Hz envelope, over noise
    rng = np.random.RandomState(11)
    t = np.arange(16000 * 3) / 16000.0
    pitch = rng.uniform(150, 3000, 15).repeat(3200)
    x = (0.3 * np.sin(np.pi * (t * 5 % 1.0)) ** 2
         * np.sin(2 * np.pi * np.cumsum(pitch) / 16000)
         + rng.randn(t.size) * 0.01).astype(np.float32)
    wav = _pcm16_wav(x)
    (d / "ep.wav").write_bytes(wav)
    pcm = np.frombuffer(wav[44:], np.int16)
    (d / "ep.flac").write_bytes(flac.encode_flac(pcm, 16000))
    (d / "ep.opus").write_bytes(codecs.encode_ogg_opus(x, 16000))
    (d / "ep.mp3").write_bytes(codecs.encode_mp3(x, 16000))
    feats = fbank(torch.from_numpy(x) * 32768.0).double().numpy()
    cmvn = d / "cmvn.json"
    cmvn.write_text(json.dumps({"mean_stat": feats.sum(0).tolist(),
                                "var_stat": (feats ** 2).sum(0).tolist(),
                                "frame_num": len(feats)}))
    config = _config(str(units), str(cmvn))
    (d / "c.json").write_text(json.dumps(config))
    model, _ = factory.init_model(config, VOCAB, 80, device="cpu",
                                  generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.ctc.ctc_lo.weight.mul_(2.0)
        model.ctc.ctc_lo.bias[0] += 2.0
        model.joint.ffn_out.weight.mul_(2.0)
        model.joint.ffn_out.bias[0] += 4.0
    torch.save(model.state_dict(), str(d / "m.pt"))
    return d


def _decode(d, name, out):
    argv = ["--config", str(d / "c.json"), "--checkpoint", str(d / "m.pt"),
            "--wav", str(d / name), "--output_dir", str(out),
            "--mode", "rnnt_beam_search", "--chunk_size", "120",
            "--batch_size", "2", "--beam_size", "4", "--precision", "fp32",
            "--device", "cpu"]
    assert t_cli.main(argv) == 0
    stem = name.rsplit(".", 1)[0]
    return ((out / f"{stem}.txt").read_bytes(),
            (out / f"{stem}.ctm").read_bytes())


def test_wav_and_flac_give_identical_txt_and_ctm(assets, tmp_path):
    txt_w, ctm_w = _decode(assets, "ep.wav", tmp_path / "wav")
    txt_f, ctm_f = _decode(assets, "ep.flac", tmp_path / "flac")
    assert txt_w.strip() and ctm_w.strip()
    assert txt_f == txt_w
    assert ctm_f == ctm_w


@pytest.mark.parametrize("name", ["ep.opus", "ep.mp3"])
def test_lossy_formats_decode_through_the_cli(assets, tmp_path, name):
    txt, ctm = _decode(assets, name, tmp_path)
    assert txt.endswith(b"\n")
    for line in ctm.decode().splitlines():
        assert line.split()[0] == "ep" and len(line.split()) == 5


def test_unknown_container_skipped_in_pipeline_and_raised_by_cli(
        assets, tmp_path, caplog):
    bad = tmp_path / "bad.xyz"
    bad.write_bytes(b"\x00\x01junk" * 64)
    samples = [{"key": "bad", "wav": str(bad), "txt": "a"},
               {"key": "good", "wav": str(assets / "ep.flac"), "txt": "b"}]
    with caplog.at_level(logging.WARNING):
        out = list(t_pipeline.decode_wav(iter(samples)))
    assert [s["key"] for s in out] == ["good"]
    assert "unsupported audio format" in caplog.text
    # the thread-pool decode skips it too
    out = list(t_pipeline.decode_wav(iter(samples), num_workers=2))
    assert [s["key"] for s in out] == ["good"]
    with pytest.raises(ValueError, match="unsupported audio format"):
        t_cli.main(["--config", str(assets / "c.json"), "--checkpoint",
                    str(assets / "m.pt"), "--wav", str(bad),
                    "--output_dir", str(tmp_path / "o"), "--device", "cpu"])
