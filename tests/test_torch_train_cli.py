"""The port's training CLI against the JAX package's, from tar shards.

Synthetic WeNet tar shards (seeded noise WAVs, letter transcripts, a
``char`` units file, JSON CMVN) feed:

* ``data/pipeline.build_dataset(mode="train")`` with shuffle, sort,
  dynamic batching, speed perturbation and utterance merging: the same
  batches as JAX's for one seed, key for key and array for array;
* ``bin/train.py`` on both sides for 2 epochs of 3 static batches of 2
  (one utterance shorter than the others) with cv, from one JAX checkpoint (parameters and a 2-step Adam state) that
  reaches the port through ``convert.state_dict_from_jax`` and
  ``convert.opt_state_from_jax``; dropout, dither and SpecAugment are off
  through ``--override_config``.  Per-step losses agree within 1e-4
  relative and the final parameters within 1e-4 of each tensor's scale;
* ``bin/average_model.py`` on the JAX run's checkpoints (converted) equal
  to JAX's ``average_checkpoints`` of them, and ``api.load_model`` on the
  run directory picking the checkpoint JAX's ``api`` picks.
"""
import io
import json
import os
import tarfile
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paper_accurate_fast_cheap_tpu import api as j_api
from paper_accurate_fast_cheap_tpu.bin import train as j_train
from paper_accurate_fast_cheap_tpu.data import pipeline as j_pipeline
from paper_accurate_fast_cheap_tpu.models import factory as j_factory
from paper_accurate_fast_cheap_tpu.text.tokenizers import (
    init_tokenizer as j_init_tokenizer)
from paper_accurate_fast_cheap_tpu.train import checkpointing as j_ckpt
from paper_accurate_fast_cheap_tpu.train import schedulers as j_sched
from paper_accurate_fast_cheap_tpu.train import train_step as j_ts
from paper_accurate_fast_cheap_tpu_torch import api as t_api
from paper_accurate_fast_cheap_tpu_torch.bin import average_model as t_avg
from paper_accurate_fast_cheap_tpu_torch.bin import train as t_train
from paper_accurate_fast_cheap_tpu_torch.convert import (
    opt_state_from_jax, state_dict_from_jax)
from paper_accurate_fast_cheap_tpu_torch.data import pipeline as t_pipeline
from paper_accurate_fast_cheap_tpu_torch.models import factory as t_factory
from paper_accurate_fast_cheap_tpu_torch.text.tokenizers import (
    init_tokenizer as t_init_tokenizer)
from paper_accurate_fast_cheap_tpu_torch.train import (
    checkpointing as t_ckpt)

LETTERS = "abcdefgh"
VOCAB = 4 + len(LETTERS)


def _wav_bytes(pcm: np.ndarray) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


def _shards(d, name, rng, n, lo, hi, per_shard, speakers=1, shapes=None):
    """``n`` utterances of lo..hi s in tar shards of ``per_shard``; keys
    'spk{s}-{name}{i}'; returns the shard list file.  ``shapes`` fixes
    utterance i's (seconds, letters): 2-letter words, the last 1 letter
    when odd."""
    paths = []
    for s0 in range(0, n, per_shard):
        path = os.path.join(d, f"{name}_{s0 // per_shard}.tar")
        with tarfile.open(path, "w") as tf:
            for i in range(s0, min(n, s0 + per_shard)):
                key = f"spk{i % speakers}-{name}{i:03d}"
                sec, letters = (shapes[i] if shapes else
                                (rng.uniform(lo, hi), None))
                pcm = np.clip(rng.randn(int(sec * 16000)) * 3000,
                              -32768, 32767).astype(np.int16)
                if letters is None:
                    txt = " ".join("".join(rng.choice(
                        list(LETTERS), rng.randint(1, 3)))
                        for _ in range(rng.randint(1, 3)))
                else:
                    word = "".join(rng.choice(list(LETTERS), letters))
                    txt = " ".join(word[j:j + 2]
                                   for j in range(0, letters, 2))
                for ext, data in (("txt", txt.encode()),
                                  ("wav", _wav_bytes(pcm))):
                    info = tarfile.TarInfo(f"{key}.{ext}")
                    info.size = len(data)
                    tf.addfile(info, io.BytesIO(data))
        paths.append(path)
    lst = os.path.join(d, f"{name}.list")
    with open(lst, "w") as f:
        f.write("\n".join(paths) + "\n")
    return lst


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("shards"))
    rng = np.random.RandomState(7)
    units = os.path.join(d, "units.txt")
    with open(units, "w") as f:
        f.write("<blank> 0\n<unk> 1\n<sos/eos> 2\n▁ 3\n" + "".join(
            f"{c} {4 + i}\n" for i, c in enumerate(LETTERS)))
    cmvn = os.path.join(d, "cmvn.json")
    with open(cmvn, "w") as f:
        json.dump({"mean_stat": [8.0 * 100] * 80,
                   "var_stat": [70.0 * 100] * 80, "frame_num": 100}, f)
    return dict(
        d=d, units=units, cmvn=cmvn,
        mixed=_shards(d, "mix", rng, 20, 0.3, 2.0, 6, speakers=3),
        # one utterance of 0.6 s with 3 letters, five of 0.9 s with 5: every
        # batch pads to one shape (the JAX trainer compiles its step once)
        # and the short one's batch is masked in frames and labels
        train=_shards(d, "tr", rng, 6, 0, 0, 3,
                      shapes=[(0.9, 5)] * 3 + [(0.6, 3)] + [(0.9, 5)] * 2),
        cv=_shards(d, "cv", rng, 2, 0, 0, 2, shapes=[(0.6, 3), (0.9, 5)]))


def test_build_dataset_train_matches_jax(data):
    conf = {
        "filter_conf": {"max_length": 2000, "min_length": 10,
                        "token_max_length": 200, "token_min_length": 1},
        "speed_perturb": True,
        "merge_utterances": True,
        "merge_utterances_conf": {"min_audio_len_secs": 1.5,
                                  "max_audio_len_secs": 3.0,
                                  "min_audio_len_acceptable_secs": 0.4,
                                  "max_utt_combined": 3, "add_sw_tag": True},
        "shuffle": True, "shuffle_conf": {"shuffle_size": 7},
        "sort": True, "sort_conf": {"sort_size": 5},
        "batch_conf": {"batch_type": "dynamic", "max_frames_in_batch": 500},
    }
    tok = {"tokenizer": "char",
           "tokenizer_conf": {"symbol_table_path": data["units"]}}
    j_batches = list(j_pipeline.build_dataset(
        "shard", data["mixed"], j_init_tokenizer(tok), conf, mode="train",
        seed=3))
    t_batches = list(t_pipeline.build_dataset(
        "shard", data["mixed"], t_init_tokenizer(tok), conf, mode="train",
        seed=3))
    assert len(t_batches) == len(j_batches) > 3
    assert any("<sw>" in t for b in t_batches for t in b["txts"])
    for jb, tb in zip(j_batches, t_batches):
        assert tb["keys"] == jb["keys"]
        assert tb["txts"] == jb["txts"]
        for k in ("wavs", "wav_lens", "labels", "label_lens"):
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)


def _train_config(data):
    return {
        "model": "transducer",
        "encoder": "conformer",
        "encoder_conf": dict(
            output_size=32, attention_heads=2, linear_units=64,
            num_blocks=2, dropout_rate=0.1, positional_dropout_rate=0.1,
            input_layer="conv2d", pos_enc_layer_type="rel_pos",
            cnn_module_kernel=7, cnn_module_norm="layer_norm",
            selfattention_layer_type="rwkv_tmix60_bidirectional",
            rwkv_do_bfloat16=False),
        "predictor": "rnn",
        "predictor_conf": {"embed_size": 32, "output_size": 32,
                           "embed_dropout": 0.1, "hidden_size": 32,
                           "num_layers": 1, "dropout": 0.1},
        "joint_conf": {"join_dim": 32},
        "decoder": None,
        "model_conf": {"ctc_weight": 0.3, "transducer_weight": 0.7,
                       "attention_weight": 0.0},
        "tokenizer": "char",
        "tokenizer_conf": {"symbol_table_path": data["units"]},
        "cmvn": "global_cmvn",
        "cmvn_conf": {"cmvn_file": data["cmvn"], "is_json_cmvn": True},
        "dataset_conf": {
            "filter_conf": {"max_length": 2000, "min_length": 10},
            "fbank_conf": {"num_mel_bins": 80, "frame_shift": 10,
                           "frame_length": 25, "dither": 1.0},
            "spec_aug": True, "shuffle": True,
            "shuffle_conf": {"shuffle_size": 100}, "sort": True,
            "batch_conf": {"batch_type": "static", "batch_size": 2},
        },
        "grad_clip": 5.0, "optim": "adam", "optim_conf": {"lr": 0.002},
        "scheduler": "warmuplr", "scheduler_conf": {"warmup_steps": 10},
        "log_interval": 1, "max_epoch": 2,
    }


OVERRIDES = [
    "dataset_conf.fbank_conf.dither=0.0", "dataset_conf.spec_aug=false",
    "encoder_conf.dropout_rate=0.0",
    "encoder_conf.positional_dropout_rate=0.0",
    "predictor_conf.embed_dropout=0.0", "predictor_conf.dropout=0.0"]


@pytest.fixture(scope="module")
def runs(data):
    d = data["d"]
    config = _train_config(data)
    cfg = os.path.join(d, "train.json")
    with open(cfg, "w") as f:
        json.dump(config, f)
    # the common start: JAX's init and 2 Adam steps on seeded gradients
    model, _ = j_factory.init_model(config, VOCAB, 80)
    params = jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((2, 128, 80)),
        jnp.full((2,), 128, jnp.int32), jnp.ones((2, 8), jnp.int32),
        jnp.full((2,), 8, jnp.int32))
    opt = j_ts.make_optimizer("adam", j_sched.warmup_lr(0.002, 10),
                              grad_clip=5.0)
    opt_state = opt.init(params)
    update = jax.jit(opt.update)
    rng = np.random.RandomState(1)
    for _ in range(2):
        grads = jax.tree.map(lambda p: jnp.asarray(
            rng.randn(*p.shape).astype(np.float32) * 0.01), params)
        upd, opt_state = update(grads, opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, upd)
    info = {"epoch": -1, "step": 2}
    j_start = os.path.join(d, "jax_start", "epoch_start")
    j_ckpt.save_checkpoint(j_start, params, opt_state, info)
    tmodel, _ = t_factory.init_model(config, VOCAB, 80, device="cpu")
    names = [n for n, _ in tmodel.named_parameters()]
    t_start = t_ckpt.save_checkpoint(
        os.path.join(d, "torch_start", "epoch_start"),
        state_dict_from_jax(jax.tree.map(np.asarray, params)),
        opt_state_from_jax(opt_state, names), info)
    argv = ["--config", cfg, "--train_data", data["train"], "--cv_data",
            data["cv"], "--data_type", "shard", "--num_epochs", "2",
            "--seed", "5"]
    for o in OVERRIDES:
        argv += ["--override_config", o]
    jdir, tdir = os.path.join(d, "jax_run"), os.path.join(d, "torch_run")
    assert j_train.main(argv + ["--model_dir", jdir,
                                "--checkpoint", j_start]) == 0
    assert t_train.main(argv + ["--model_dir", tdir, "--checkpoint", t_start,
                                "--device", "cpu"]) == 0
    return dict(jdir=jdir, tdir=tdir, config=config, params=params, d=d)


def _losses(run_dir):
    with open(os.path.join(run_dir, "logs", "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [(r["step"], r["train/loss"], r["train/frames_seen"])
            for r in recs if "train/loss" in r]


def test_train_cli_matches_jax(runs):
    jl, tl = _losses(runs["jdir"]), _losses(runs["tdir"])
    assert len(tl) == len(jl) == 6
    assert [s for s, _, _ in tl] == [s for s, _, _ in jl] == list(
        range(3, 9))
    assert [f for _, _, f in tl] == [f for _, _, f in jl]
    np.testing.assert_allclose([x for _, x, _ in tl],
                               [x for _, x, _ in jl], rtol=1e-4)
    # the parameters after the run, and the cv losses of the sidecars
    jp, _, jinfo = j_ckpt.load_checkpoint(
        os.path.join(runs["jdir"], "epoch_0001"), None)
    want = state_dict_from_jax(jax.tree.map(np.asarray, jp))
    got, opt, tinfo = t_ckpt.load_checkpoint(
        os.path.join(runs["tdir"], "epoch_0001"))
    assert opt["count"] == 8 and tinfo["step"] == jinfo["step"] == 8
    np.testing.assert_allclose(tinfo["cv_loss"], jinfo["cv_loss"],
                               rtol=1e-4)
    for name, w in want.items():
        scale = float(w.abs().max()) or 1.0
        assert float((got[name] - w).abs().max()) <= 1e-4 * scale, name
    # the weights moved from the start
    start = state_dict_from_jax(jax.tree.map(np.asarray, runs["params"]))
    assert any(float((got[n] - start[n]).abs().max()) > 1e-3 for n in got)


def test_average_model_matches_jax(runs, tmp_path):
    # JAX's average of its run's epoch checkpoints (its CLI's call, on the
    # restored parameters as the template)
    paths = [os.path.join(runs["jdir"], f"epoch_{e:04d}") for e in (0, 1)]
    restored = [j_ckpt.load_checkpoint(p, None) for p in paths]
    want = state_dict_from_jax(jax.tree.map(
        np.asarray, j_ckpt.average_checkpoints(paths, restored[0][0])))
    # the same checkpoints in the port's format, through the port's CLI
    src = tmp_path / "converted"
    for p, (params, _, info) in zip(paths, restored):
        t_ckpt.save_checkpoint(str(src / os.path.basename(p)),
                               state_dict_from_jax(jax.tree.map(
                                   np.asarray, params)), None, info)
    tdst = str(tmp_path / "torch_avg")
    for extra in ([], ["--val_best"]):
        assert t_avg.main(["--src_path", str(src), "--dst_path", tdst,
                           "--num", "2", "--config", "unused.yaml"]
                          + extra) == 0
        got, _, info = t_ckpt.load_checkpoint(tdst)
        assert info["tag"] == "average" and len(info["averaged_from"]) == 2
        assert set(got) == set(want)
        for n in want:
            torch.testing.assert_close(got[n], want[n], rtol=0, atol=0)


def test_api_picks_jax_checkpoint(runs, monkeypatch):
    picked = []

    def fake_assets(config, checkpoint, *a, **k):
        picked.append(checkpoint)
        raise StopIteration

    monkeypatch.setattr("paper_accurate_fast_cheap_tpu.bin.recognize."
                        "build_decode_assets", fake_assets)
    with pytest.raises(StopIteration):
        j_api.load_model(runs["jdir"])
    m = t_api.load_model(runs["tdir"], device="cpu")
    want = os.path.basename(picked[0])
    assert want == "epoch_0001"
    assert os.path.basename(t_api._last_checkpoint(runs["tdir"])) \
        == want + ".pt"
    sd = t_ckpt.load_checkpoint(os.path.join(runs["tdir"], want))[0]
    for n, p in m.model.state_dict().items():
        torch.testing.assert_close(p, sd[n], rtol=0, atol=0)
    rng = np.random.RandomState(2)
    texts = m.transcribe_batch([rng.randn(12000).astype(np.float32) * 0.1])
    assert isinstance(texts[0], str)
