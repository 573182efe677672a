"""The port's ``recognize_wav`` CLI against the JAX CLI, byte for byte.

One tiny transducer of the flagship family per joint (the standard
``ffn_out`` head and the HAT head), initialised in JAX with its output
heads scaled x2 and blank biases set so that the beam emits varied tokens
with blanks between; the JAX CLI reads its orbax checkpoint, the port's
CLI the same weights through ``convert.state_dict_from_jax`` and
``torch.save``.  Both decode the same 3 s WAV of tone bursts with global
JSON CMVN in fp32 (``--fuse off`` on the JAX side, ``--device cpu`` on the
port's), 2-window batches with a padded tail batch, beam 4, and must write
identical ``.txt`` and ``.ctm`` files.  The HAT joint's ``joint_step`` and
its device beam (``auto`` takes K4's route) are held to JAX as well.  A
rel-pos MHA transducer decodes through both CLIs with
``--encoder_context_size 8 --encoder_global_tokens 1`` (LCA): the port's
CLI reads the MHA checkpoint, the JAX CLI (which restores its checkpoint
without a template) the same weights under the LCA modules' names.

The beam options of the long-form path, on the standard joint at
``--batch_size 8``: the packed-alignment path with the pairwise merge and
with ``--beam_merge sort``, each against one run of the JAX CLI at its
default for that batch (``--fuse split``, packed alignment);
``--align_max_tokens`` is short enough that some windows fall back to the
batched aligner.  They share this module's assets and, on the JAX side,
its compilations.
"""
import io
import json
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paper_accurate_fast_cheap_tpu.bin import recognize_wav as j_cli
from paper_accurate_fast_cheap_tpu.decode import rnnt_search as j_search
from paper_accurate_fast_cheap_tpu.frontend.features import fbank as j_fbank
from paper_accurate_fast_cheap_tpu.models import factory as j_factory
from paper_accurate_fast_cheap_tpu.train import checkpointing
from paper_accurate_fast_cheap_tpu_torch.bin import recognize_wav as t_cli
from paper_accurate_fast_cheap_tpu_torch.convert import state_dict_from_jax
from paper_accurate_fast_cheap_tpu_torch.decode import rnnt_search as t_search
from paper_accurate_fast_cheap_tpu_torch.models import factory as t_factory

# the widths of tests/test_torch_slice.py's model: the JAX CLI's eager
# model.init then reuses the op compilations of that module's (and this
# fixture's) init, which dominate the JAX side's time on the CPU
VOCAB = 1100
BEAM = 4


def _config(units: str, cmvn: str, hat: bool,
            attention: str = "rwkv_tmix60_bidirectional") -> dict:
    return {
        "model": "transducer",
        "encoder": "conformer",
        "encoder_conf": dict(
            output_size=32, attention_heads=2, linear_units=64, num_blocks=2,
            input_layer="conv2d", pos_enc_layer_type="rel_pos",
            cnn_module_kernel=15, cnn_module_norm="layer_norm",
            selfattention_layer_type=attention, rwkv_do_bfloat16=False),
        "decoder": None,
        "predictor": "rnn",
        "predictor_conf": {"embed_size": 32, "output_size": 32,
                           "embed_dropout": 0.1, "hidden_size": 32,
                           "num_layers": 1, "dropout": 0.1},
        "joint_conf": {"join_dim": 32, "hat_joint": hat},
        "model_conf": {"ctc_weight": 0.3, "transducer_weight": 0.7,
                       "attention_weight": 0.0},
        "tokenizer": "whitespace",
        "tokenizer_conf": {"symbol_table_path": units},
        "cmvn": "global_cmvn",
        "cmvn_conf": {"cmvn_file": cmvn, "is_json_cmvn": True},
        "dataset_conf": {
            "fbank_conf": {"num_mel_bins": 80, "frame_shift": 10,
                           "frame_length": 25, "dither": 0.0},
        },
    }


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    d = tmp_path_factory.mktemp("lf")
    # word-initial pieces ("▁w3") and continuations ("c4"), so the CTM
    # merges pieces into words
    units = d / "units.txt"
    units.write_text("<blank> 0\n<unk> 1\n" + "".join(
        f"{'▁w' if i % 3 == 0 else 'c'}{i} {i}\n" for i in range(2, VOCAB)))
    # 15 tone bursts of random pitch under a 5 Hz envelope, over noise
    rng = np.random.RandomState(11)
    t = np.arange(16000 * 3) / 16000.0
    pitch = rng.uniform(150, 3000, 15).repeat(3200)
    wav = (0.3 * np.sin(np.pi * (t * 5 % 1.0)) ** 2
           * np.sin(2 * np.pi * np.cumsum(pitch) / 16000)
           + rng.randn(t.size) * 0.01).astype(np.float32)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((wav * 32767).astype(np.int16).tobytes())
    wav_path = d / "ep.wav"
    wav_path.write_bytes(buf.getvalue())
    # global CMVN stats of the file's own features
    feats = np.asarray(j_fbank(jnp.asarray(wav) * 32768.0), np.float64)
    cmvn = d / "cmvn.json"
    cmvn.write_text(json.dumps({"mean_stat": feats.sum(0).tolist(),
                                "var_stat": (feats ** 2).sum(0).tolist(),
                                "frame_num": len(feats)}))
    out = {}
    for joint in ("standard", "hat", "mha"):
        config = _config(str(units), str(cmvn), joint == "hat",
                         "rel_selfattn" if joint == "mha"
                         else "rwkv_tmix60_bidirectional")
        cfg = d / f"{joint}.json"
        cfg.write_text(json.dumps(config))
        model, _ = j_factory.init_model(config, VOCAB, 80)
        params = jax.tree.map(np.array, model.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 64, 80)),
            jnp.asarray([64]), jnp.ones((1, 4), jnp.int32),
            jnp.asarray([4])))
        p = params["params"]
        p["ctc"]["ctc_lo"]["kernel"] *= 2.0
        p["ctc"]["ctc_lo"]["bias"][0] += 2.0
        if joint == "hat":
            p["joint"]["token_pred"]["kernel"] *= 2.0
            p["joint"]["blank_pred"]["bias"] -= 4.0
        else:
            p["joint"]["ffn_out"]["kernel"] *= 2.0
            p["joint"]["ffn_out"]["bias"][0] += 4.0
        params = jax.tree.map(jnp.asarray, params)
        ckpt = d / f"{joint}_ckpt"
        if joint == "mha":
            # the JAX CLI's LCA model restores these names
            enc = {k.replace("RelPositionMultiHeadedAttention_",
                             "LimitedRelPositionAttention_"): v
                   for k, v in p["encoder"].items()}
            checkpointing.save_checkpoint(str(ckpt), jax.tree.map(
                jnp.asarray, {"params": dict(p, encoder=enc)}))
        else:
            checkpointing.save_checkpoint(str(ckpt), params)
        pt = d / f"{joint}.pt"
        torch.save(state_dict_from_jax(jax.tree.map(np.asarray, params)),
                   str(pt))
        out[joint] = dict(config=config, cfg=cfg, ckpt=ckpt, pt=pt,
                          model=model, params=params)
    return d, wav_path, out


@pytest.mark.parametrize("joint", ["standard", "hat", "mha"])
def test_recognize_wav_matches_jax_cli(assets, joint):
    d, wav_path, out = assets
    a = out[joint]
    common = ["--wav", str(wav_path), "--mode", "rnnt_beam_search",
              "--chunk_size", "120", "--batch_size", "2", "--beam_size",
              str(BEAM), "--precision", "fp32", "--config", str(a["cfg"])]
    if joint == "mha":
        common += ["--encoder_context_size", "8",
                   "--encoder_global_tokens", "1"]
    jdir, tdir = d / f"jax_{joint}", d / f"torch_{joint}"
    assert j_cli.main(common + ["--checkpoint", str(a["ckpt"]),
                                "--output_dir", str(jdir),
                                "--fuse", "off"]) == 0
    assert t_cli.main(common + ["--checkpoint", str(a["pt"]),
                                "--output_dir", str(tdir),
                                "--device", "cpu"]) == 0
    for ext in (".txt", ".ctm"):
        want = (jdir / f"ep{ext}").read_bytes()
        assert (tdir / f"ep{ext}").read_bytes() == want, ext
    # varied words with times, not a trivially equal empty decode
    words = (tdir / "ep.ctm").read_text().split()[4::5]
    assert len(words) > 8 and len(set(words)) > 3
    rtf = (tdir / "ep.rtf").read_text().splitlines()
    assert [ln.split()[0] for ln in rtf] == [
        "final_rtf", "steady_rtf", "median_rtf", "batch_times",
        "batch_audio"]


def _port_model(a):
    m, _ = t_factory.init_model(a["config"], VOCAB, 80, device="cpu")
    m.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray,
                                                       a["params"])))
    return m


def test_hat_joint_step_matches_jax(assets):
    a = assets[2]["hat"]
    model, params = a["model"], a["params"]
    rng = np.random.RandomState(2)
    enc = rng.randn(6, 32).astype(np.float32)
    pred = rng.randn(6, 32).astype(np.float32)
    want = model.apply(params, jnp.asarray(enc), jnp.asarray(pred),
                       method=model.joint_step)
    got = _port_model(a).joint_step(torch.from_numpy(enc),
                                    torch.from_numpy(pred))
    assert got.shape == (6, VOCAB)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_hat_beam_auto_matches_jax(assets):
    a = assets[2]["hat"]
    model, params = a["model"], a["params"]
    rng = np.random.RandomState(3)
    enc = rng.randn(2, 12, 32).astype(np.float32)
    z = rng.randn(2, 12, VOCAB).astype(np.float32) * 2
    ctc = z - np.log(np.exp(z).sum(-1, keepdims=True))
    lens = np.asarray([12, 9], np.int32)
    want = j_search.rnnt_beam_search(
        *j_search.make_transducer_step_fns(model, params), jnp.asarray(enc),
        jnp.asarray(lens), jnp.asarray(ctc), beam_size=BEAM, params=params)
    tmodel = _port_model(a)
    fns = t_search.make_transducer_step_fns(tmodel)
    assert not hasattr(fns[1], "preact")       # no split form: K4's route
    got = t_search.rnnt_beam_search(
        *fns, torch.from_numpy(enc), torch.from_numpy(lens),
        torch.from_numpy(ctc), beam_size=BEAM)
    assert any(r.tokens for r in want)
    for x, y in zip(want, got):
        assert x.tokens == y.tokens
        assert x.nbest == y.nbest
        np.testing.assert_allclose(y.nbest_scores, x.nbest_scores,
                                   rtol=1e-5)


# 100-frame windows: 3 real rows and 5 padded ones in one batch of 8; 20
# aligned tokens are fewer than two windows' hypotheses (23 tokens)
BEAM_COMMON = ["--mode", "rnnt_beam_search", "--beam_size", str(BEAM),
               "--precision", "fp32", "--chunk_size", "100",
               "--batch_size", "8"]


@pytest.fixture(scope="module")
def jax_beam_out(assets):
    """The JAX CLI once, at its default for this batch (``--fuse split``,
    the pairwise merge): the two merges write the same bytes."""
    d, wav_path, out = assets
    a = out["standard"]
    jdir = d / "jax_split"
    assert j_cli.main(BEAM_COMMON + [
        "--wav", str(wav_path), "--config", str(a["cfg"]), "--checkpoint",
        str(a["ckpt"]), "--fuse", "split", "--output_dir", str(jdir)]) == 0
    return jdir


@pytest.mark.parametrize("merge", ["pairwise", "sort"])
def test_beam_cli_matches_jax_cli(assets, jax_beam_out, merge, monkeypatch):
    from paper_accurate_fast_cheap_tpu_torch.ops import ctc_utils

    oks, fallback = [], []
    unpack = t_search.finalize_device_beam_aligned
    batch_align = ctc_utils.force_align_batch_device

    def spy_unpack(*a, **k):
        out = unpack(*a, **k)
        oks.extend(out[2].tolist())
        return out

    def spy_align(logp, lens, labels, *a, **k):
        fallback.extend(lab for lab in labels if lab)
        return batch_align(logp, lens, labels, *a, **k)

    monkeypatch.setattr(t_search, "finalize_device_beam_aligned",
                        spy_unpack)
    monkeypatch.setattr(ctc_utils, "force_align_batch_device", spy_align)
    d, wav_path, out = assets
    tdir = d / f"torch_beam_{merge}"
    assert t_cli.main(BEAM_COMMON + [
        "--wav", str(wav_path), "--config", str(out["standard"]["cfg"]),
        "--checkpoint", str(out["standard"]["pt"]), "--device", "cpu",
        "--beam_merge", merge, "--align_max_tokens", "20", "--output_dir",
        str(tdir)]) == 0
    for ext in (".txt", ".ctm"):
        assert (tdir / f"ep{ext}").read_bytes() == \
            (jax_beam_out / f"ep{ext}").read_bytes(), ext
    words = (tdir / "ep.ctm").read_text().split()[4::5]
    assert len(words) > 8 and len(set(words)) > 3
    # both paths ran: rows aligned by the beam, and longer ones by the
    # batched aligner
    assert any(oks) and fallback
