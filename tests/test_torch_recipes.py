"""The paper's example drivers, ported
(``paper_accurate_fast_cheap_tpu_torch/examples/gigaspeech/local/``), each
at its smallest settings on the CPU: the LF fixture maker, the accuracy
loop's plumbing (4 utterances, 1 epoch, a 1-block width-16 model), the
impl matrix on its checkpoint, the LF sweep at 2 chunk sizes over one WAV
and one FLAC, and the encoder-RTF sweep at one point of the flagship's
bench YAML.  The drivers read the recipe's configs and write only under
the paths they are given."""
import json
import os
import shutil

import numpy as np
import pytest
import torch
import yaml

from paper_accurate_fast_cheap_tpu_torch.data import audio, flac
from paper_accurate_fast_cheap_tpu_torch.examples.gigaspeech.local import (
    CONF_DIR, make_lf_fixture, run_accuracy_loop, run_impl_matrix,
    run_lf_sweep, run_rtf_sweep)
from paper_accurate_fast_cheap_tpu_torch.models import factory


def test_make_lf_fixture(tmp_path):
    # the flagship YAML narrowed (its structure, not its widths)
    with open(os.path.join(
            CONF_DIR, "rwkvbi_ds4k31nc_12le_trans_shortform.yaml")) as f:
        conf = yaml.safe_load(f)
    conf["encoder_conf"].update(output_size=64, attention_heads=2,
                                linear_units=64, num_blocks=1)
    conf["decoder_conf"].update(attention_heads=2, linear_units=64,
                                num_blocks=1, r_num_blocks=1)
    conf["predictor_conf"].update(embed_size=64, output_size=64,
                                  hidden_size=64, num_layers=1)
    conf["joint_conf"].update(enc_output_size=64, pred_output_size=64,
                              join_dim=64)
    small = tmp_path / "small.yaml"
    small.write_text(yaml.safe_dump(conf))
    out = tmp_path / "lf"
    assert make_lf_fixture.main([
        "--out", str(out), "--minutes", "0.05", "--vocab", "64",
        "--config", str(small), "--device", "cpu"]) == 0
    wav, sr = audio.read_audio_bytes((out / "episode0.05m.wav").read_bytes())
    assert sr == 16000 and len(wav) == 48000
    assert 0.4 < np.abs(wav).max() <= 0.5
    with open(out / "config.yaml") as f:
        config = yaml.safe_load(f)
    assert config["tokenizer"] == "char"
    sd = torch.load(str(out / "ckpt.pt"))
    ref, _ = factory.init_model(config, 64, 80, device="cpu",
                                generator=torch.Generator().manual_seed(1))
    ref = ref.state_dict()
    assert sd.keys() == ref.keys()
    for key in ("joint.ffn_out.bias", "ctc.ctc_lo.bias"):
        delta = sd[key] - ref[key]
        assert torch.allclose(delta[0], torch.tensor(2.5))
        assert not delta[1:].any()


@pytest.fixture(scope="module")
def loop(tmp_path_factory):
    out = tmp_path_factory.mktemp("acc")
    rc = run_accuracy_loop.main([
        "--out", str(out), "--device", "cpu", "--train_utts", "4",
        "--epochs", "1", "--lf_files", "1", "--lf_words", "6", "--dim", "16",
        "--blocks", "1", "--batch_size", "2", "--target_wer", "0"])
    return out, rc


def test_accuracy_loop_plumbing(loop, capsys):
    out, rc = loop
    for f in ("train/shards/shards.txt", "global_cmvn", "config.yaml",
              "ckpt_init.pt", "exp/epoch_0000.pt",
              "decode_init/hyp.text", "decode_trained/hyp.text"):
        assert (out / f).exists(), f
    with open(out / "global_cmvn") as f:
        assert json.load(f)["frame_num"] > 0
    # a second run reuses both decodes and the data; its summary says so
    rc2 = run_accuracy_loop.main([
        "--out", str(out), "--device", "cpu", "--train_utts", "4",
        "--epochs", "1", "--lf_files", "1", "--lf_words", "6", "--dim", "16",
        "--blocks", "1", "--batch_size", "2", "--target_wer", "0"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["metric"] == "accuracy_loop_wer"
    assert summary["decode_s"] == [0.0, 0.0]
    assert rc == rc2 == (0 if summary["improved"] else 1)


def test_impl_matrix(loop, capsys):
    out, _ = loop
    assert run_impl_matrix.main(["--fixture", str(out), "--device",
                                 "cpu"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["hard_contract_ok"] and res["cells"] == 5
    assert res["distinct_transcripts"] == 1 and res["ctm_identical"]


def test_lf_sweep_wav_and_flac(loop, tmp_path, capsys):
    out, _ = loop
    wdir = tmp_path / "eps"
    wdir.mkdir()
    src = out / "longform"
    shutil.copy(src / "ep0.wav", wdir / "ep0.wav")
    x, sr = audio.read_audio_bytes((src / "ep0.wav").read_bytes())
    pcm = np.round(x * 32768.0).astype(np.int16)
    (wdir / "ep0f.flac").write_bytes(flac.encode_flac(pcm, sr))
    for name in ("ep0", "ep0f"):
        shutil.copy(src / "ep0.ref_txt", wdir / f"{name}.ref_txt")
    sweep = tmp_path / "sweep"
    assert run_lf_sweep.main([
        "--config", str(out / "config.yaml"),
        "--checkpoint", str(out / "exp" / "epoch_0000.pt"),
        "--wav_dir", str(wdir), "--out_dir", str(sweep),
        "--chunk_sizes", "200,400", "--batch_size", "2",
        "--device", "cpu"]) == 0
    rows = (sweep / "summary.txt").read_text().splitlines()
    assert rows[0].startswith("chunk_frames wer") and len(rows) == 3
    assert [r.split()[0] for r in rows[1:]] == ["200", "400"]
    assert all(r.split()[6] == "2" for r in rows[1:])
    for chunk in (200, 400):
        d = sweep / f"chunk{chunk}"
        assert (d / "ep0.txt").read_bytes() == (d / "ep0f.txt").read_bytes()
        assert (d / "ep0.ctm").read_text() == (
            d / "ep0f.ctm").read_text().replace("ep0f ", "ep0 ")


def test_rtf_sweep(tmp_path, capsys):
    assert run_rtf_sweep.main([
        "--out_dir", str(tmp_path), "--models", "rwkv_bi_12L",
        "--batches", "1", "--chunks", "200", "--iters", "1",
        "--device", "cpu"]) == 0
    rtf = (tmp_path / "rwkv_bi_12L_run0_b1_c200.rtf").read_text()
    assert "batch 1 chunk 200 iters 1" in rtf and "device cpu" in rtf
    table = (tmp_path / "summary.md").read_text()
    assert "| bench_rwkvbi_ds4k31nc_12le | 1 | 200 |" in table
    assert table in capsys.readouterr().out
