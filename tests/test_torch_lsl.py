"""The port's language-specific (LSL) conformer layers against the JAX
package's, from the encoder to the CLIs.

A tiny LSL encoder of the flagship's kind (bi RWKV-6 attention, no_pos,
3 blocks of width 32, ``num_langs=2``: blocks 0 and 2 are LSL) on seeded
weights (``tests/test_torch_encoder_families.seeded_params``), f32,
``.eval()``, ragged lengths.  ``cat_embs`` one-hot, soft and None give
JAX's encoder output and ``return_layers`` within 1e-5; None equals
[0.5, 0.5]; the two one-hot rows differ.

An LSL transducer (``encoder_conf=dict(..., num_langs=2)``, as JAX's tests
build it; rel-pos MHA, 2 blocks) gives JAX's loss with ``cat_embs`` within 1e-5, and one training
step through ``train/executor.Executor`` on a batch that carries
``cat_embs`` reports that loss (dropout 0).

The CLIs: an LSL CTC model (rel-pos MHA, the JAX CLIs handed this
fixture's model through a patched ``build_decode_assets``, the port's
factory given ``num_langs=2`` the same way) decodes one WAV with
``--verbatimicity 0.8`` through both ``recognize_wav`` CLIs, TXT and CTM
byte for byte, and ``write_embeddings --cat_embs 0.8,0.2`` gives JAX's
embeddings within 1e-4 of their scale.  A model from a YAML has no LSL
blocks, so ``--verbatimicity`` leaves its TXT and CTM unchanged (JAX's
rule), while on the LSL model 0.5 equals no flag.
"""
import io
import json
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paper_accurate_fast_cheap_tpu.bin import recognize as j_recognize
from paper_accurate_fast_cheap_tpu.bin import recognize_wav as j_cli
from paper_accurate_fast_cheap_tpu.bin import write_embeddings as j_emb
from paper_accurate_fast_cheap_tpu.frontend import cmvn as j_cmvn_lib
from paper_accurate_fast_cheap_tpu.frontend.features import fbank as j_fb
from paper_accurate_fast_cheap_tpu.frontend.pipeline import (
    make_feature_fn as j_make_feature_fn)
from paper_accurate_fast_cheap_tpu.models import factory as j_factory
from paper_accurate_fast_cheap_tpu.models.conformer import (
    ConformerEncoder as JEncoder)
from paper_accurate_fast_cheap_tpu.models.transducer import (
    Transducer as JTransducer)
from paper_accurate_fast_cheap_tpu.text.tokenizers import (
    init_tokenizer as j_init_tokenizer)
from paper_accurate_fast_cheap_tpu_torch.bin import recognize_wav as t_cli
from paper_accurate_fast_cheap_tpu_torch.bin import write_embeddings as t_emb
from paper_accurate_fast_cheap_tpu_torch.convert import state_dict_from_jax
from paper_accurate_fast_cheap_tpu_torch.models import factory as t_factory
from paper_accurate_fast_cheap_tpu_torch.models.conformer import (
    ConformerEncoder as TEncoder, LanguageSpecificConformerEncoderLayer)
from paper_accurate_fast_cheap_tpu_torch.models.transducer import (
    Transducer as TTransducer)
from paper_accurate_fast_cheap_tpu_torch.train import train_step as ts
from paper_accurate_fast_cheap_tpu_torch.train.executor import Executor
from test_torch_encoder_families import seeded_params

TOL = dict(rtol=1e-5, atol=1e-5)
ENC = dict(input_size=16, output_size=32, attention_heads=2,
           linear_units=32, num_blocks=3, input_layer="linear",
           pos_enc_layer_type="no_pos", cnn_module_kernel=7,
           selfattention_layer_type="rwkv_tmix60_bidirectional",
           rwkv_conf={"rwkv_do_bfloat16": False}, num_langs=2,
           dropout_rate=0.0, positional_dropout_rate=0.0)
CATS = {"one_hot": [[1.0, 0.0], [0.0, 1.0]],
        "soft": [[0.3, 0.7], [0.5, 0.5]], "none": None}


def _inputs(seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(2, 37, 16).astype(np.float32),
            np.asarray([37, 22], np.int32))


@pytest.fixture(scope="module")
def lsl():
    x, lens = _inputs(0)
    jenc = JEncoder(**ENC)
    params = seeded_params(jenc, np.random.RandomState(1), jnp.asarray(x),
                           jnp.asarray(lens))
    fwd = jax.jit(lambda p, x, l, c: jenc.apply(p, x, l, cat_embs=c,
                                                return_layers=True))
    tenc = TEncoder(**ENC)
    tenc.load_state_dict(state_dict_from_jax(params))
    return fwd, params, tenc.eval(), x, lens


def test_lsl_blocks_sit_at_both_ends(lsl):
    tenc = lsl[2]
    kinds = [isinstance(getattr(tenc, f"layer_{i}"),
                        LanguageSpecificConformerEncoderLayer)
             for i in range(3)]
    assert kinds == [True, False, True]
    assert tenc.attention_names == ["RWKVAttention_0"]
    assert tenc.layer_0.attention_names == ["RWKVAttention_0",
                                            "RWKVAttention_1"]


@pytest.mark.parametrize("cats", list(CATS))
def test_lsl_encoder_matches_jax(lsl, cats):
    fwd, params, tenc, x, lens = lsl
    c = CATS[cats]
    want, wl, wlayers = fwd(params, jnp.asarray(x), jnp.asarray(lens),
                            None if c is None else jnp.asarray(c))
    kw = {} if c is None else {"cat_embs": torch.tensor(c)}
    with torch.no_grad():
        got, gl, glayers = tenc(torch.from_numpy(x), torch.from_numpy(lens),
                                return_layers=True, **kw)
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert len(glayers) == len(wlayers) == 3
    for g, w in zip(glayers, wlayers):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_lsl_none_is_uniform_and_languages_differ(lsl):
    tenc, x, lens = lsl[2], *map(torch.from_numpy, lsl[3:])
    with torch.no_grad():
        none = tenc(x, lens)[0]
        half = tenc(x, lens, cat_embs=torch.full((2, 2), 0.5))[0]
        a = tenc(x, lens, cat_embs=torch.tensor([[1.0, 0.0]] * 2))[0]
        b = tenc(x, lens, cat_embs=torch.tensor([[0.0, 1.0]] * 2))[0]
    torch.testing.assert_close(none, half, rtol=1e-6, atol=1e-6)
    assert (a - b).abs().max() > 1e-2


def test_lsl_transducer_loss_and_train_step(lsl):
    """JAX's loss with ``cat_embs``, and the port's executor taking a batch
    that carries ``cat_embs`` into one train step that reports it."""
    V = 24
    rng = np.random.RandomState(2)
    x, lens = _inputs(3)
    labels = rng.randint(1, V, (2, 4)).astype(np.int32)
    llens = np.asarray([4, 2], np.int32)
    cats = np.asarray([[0.8, 0.2], [0.0, 1.0]], np.float32)
    # the rel-pos MHA in the LSL blocks here: JAX compiles it faster
    enc = dict(ENC, selfattention_layer_type="rel_selfattn",
               pos_enc_layer_type="rel_pos", num_blocks=2)
    kw = dict(vocab_size=V, encoder_conf=enc,
              predictor_conf=dict(embed_size=16, hidden_size=16,
                                  output_size=16, num_layers=1,
                                  embed_dropout=0.0, dropout=0.0),
              joint_conf={"join_dim": 16}, transducer_weight=0.7,
              ctc_weight=0.3, attention_weight=0.0)
    jm = JTransducer(**kw)
    args = [jnp.asarray(a) for a in (x, lens, labels, llens, cats)]
    params = seeded_params(jm, np.random.RandomState(4), *args)
    want = float(jax.jit(jm.apply)(params, *args)["loss"])
    tm = TTransducer(**kw)
    tm.load_state_dict(state_dict_from_jax(params))
    with torch.no_grad():
        got = tm.eval()(*(torch.from_numpy(a) for a in
                          (x, lens, labels, llens, cats)))["loss"]
    np.testing.assert_allclose(float(got), want, **TOL)

    def loss_fn(p, batch, seed):
        tm.train()
        ts.bind_params(tm, p)
        out = tm(*batch)
        return out["loss"], {}

    params_t = {n: p.detach() for n, p in tm.named_parameters()}
    opt = ts.make_optimizer("adam", lambda s: 1e-3)
    step = ts.make_train_step(loss_fn, opt)
    losses = []

    def recorded(state, batch, seed):
        assert len(batch) == 5 and batch[4].shape == (2, 2)
        state, loss, metrics = step(state, batch, seed)
        losses.append(float(loss))
        return state, loss, metrics

    ex = Executor(recorded, None,
                  lambda w, wl, train, generator: (torch.from_numpy(x),
                                                   torch.from_numpy(lens)))
    ex.train_epoch(ts.init_train_state(params_t, opt), [{
        "wavs": np.zeros((2, 8), np.float32), "wav_lens": np.asarray([8, 8]),
        "labels": labels, "label_lens": llens, "cat_embs": cats}])
    assert len(losses) == 1
    np.testing.assert_allclose(losses[0], want, **TOL)


# ---- the CLIs ----

VOCAB = 30
CLI_ENC = dict(output_size=32, attention_heads=2, linear_units=32,
               num_blocks=3, cnn_module_kernel=7)


def _wav_bytes(wav):
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((wav * 32767).astype(np.int16).tobytes())
    return buf.getvalue()


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    d = tmp_path_factory.mktemp("lsl_cli")
    units = d / "units.txt"
    units.write_text("<blank> 0\n<unk> 1\n" + "".join(
        f"{'▁w' if i % 3 == 0 else 'c'}{i} {i}\n" for i in range(2, VOCAB)))
    rng = np.random.RandomState(21)
    lines, waves = [], []
    for i, secs in enumerate((2.6, 1.4)):
        t = np.arange(int(16000 * secs)) / 16000.0
        pitch = rng.uniform(150, 3000, t.size // 3200 + 1).repeat(3200)
        wav = (0.3 * np.sin(np.pi * (t * 5 % 1.0)) ** 2
               * np.sin(2 * np.pi * np.cumsum(pitch[:t.size]) / 16000)
               + rng.randn(t.size) * 0.01).astype(np.float32)
        path = d / f"utt{i}.wav"
        path.write_bytes(_wav_bytes(wav))
        waves.append(wav)
        lines.append(json.dumps({"key": f"utt{i}", "wav": str(path),
                                 "txt": "c4 ▁w6"}))
    (d / "data.list").write_text("\n".join(lines) + "\n")
    feats = np.concatenate([np.asarray(j_fb(jnp.asarray(w) * 32768.0),
                                       np.float64) for w in waves])
    cmvn = d / "cmvn.json"
    cmvn.write_text(json.dumps({"mean_stat": feats.sum(0).tolist(),
                                "var_stat": (feats ** 2).sum(0).tolist(),
                                "frame_num": len(feats)}))
    config = {
        "model": "asr_model", "encoder": "conformer",
        "encoder_conf": CLI_ENC, "model_conf": {"ctc_weight": 1.0},
        "tokenizer": "whitespace",
        "tokenizer_conf": {"symbol_table_path": str(units)},
        "cmvn": "global_cmvn",
        "cmvn_conf": {"cmvn_file": str(cmvn), "is_json_cmvn": True},
        "dataset_conf": {"fbank_conf": {"num_mel_bins": 80, "frame_shift": 10,
                                        "frame_length": 25, "dither": 0.0}},
    }
    cfg = d / "conf.json"
    cfg.write_text(json.dumps(config))
    lsl_config = dict(config, encoder_conf=dict(CLI_ENC, num_langs=2))
    model, model_type = j_factory.init_model(lsl_config, VOCAB, 80)
    assert model.encoder_conf.get("num_langs") is None  # JAX's key set
    model = model.clone(encoder_conf=dict(model.encoder_conf, num_langs=2))
    args = (jnp.zeros((1, 64, 80)), jnp.asarray([64]),
            jnp.ones((1, 4), jnp.int32), jnp.asarray([4]))
    params = jax.tree.map(np.array, seeded_params(
        model, np.random.RandomState(22), *args))
    params["params"]["ctc"]["ctc_lo"]["kernel"] *= 3.0
    pt = d / "model.pt"
    torch.save(state_dict_from_jax(params), str(pt))
    params = jax.tree.map(jnp.asarray, params)
    plain_pt = d / "plain.pt"
    plain, _ = t_factory.init_model(config, VOCAB, 80, device="cpu")
    torch.save(plain.state_dict(), str(plain_pt))

    def jax_assets(config, checkpoint, input_dim=80):
        """The JAX CLIs' assets on this fixture's LSL model."""
        conf = dict(config["dataset_conf"], spec_aug=False, spec_sub=False,
                    speed_perturb=False)
        stats = j_cmvn_lib.load_cmvn(str(cmvn), True)
        return (j_init_tokenizer(config), model, model_type, params,
                j_make_feature_fn(conf, stats), conf)

    return dict(d=d, cfg=cfg, pt=pt, plain_pt=plain_pt, jax_assets=jax_assets,
                wav=d / "utt0.wav")


def _lsl_factory(monkeypatch):
    """The port's factory builds the LSL blocks (JAX's YAML key set has no
    ``num_langs``; its tests pass it in ``encoder_conf``)."""
    conf_of = t_factory.encoder_conf_from_yaml
    monkeypatch.setattr(t_factory, "encoder_conf_from_yaml",
                        lambda conf, input_dim=80: dict(
                            conf_of(conf, input_dim), num_langs=2))


def _decode(cli_main, a, out, extra):
    assert cli_main(["--wav", str(a["wav"]), "--config", str(a["cfg"]),
                     "--mode", "ctc_greedy_search", "--chunk_size", "120",
                     "--batch_size", "2", "--precision", "fp32",
                     "--output_dir", str(out)] + extra) == 0
    return [(out / f"utt0{ext}").read_bytes() for ext in (".txt", ".ctm")]


def test_recognize_wav_verbatimicity_matches_jax_cli(cli, monkeypatch):
    d = cli["d"]
    monkeypatch.setattr(j_recognize, "build_decode_assets",
                        cli["jax_assets"])
    want = _decode(j_cli.main, cli, d / "j_v08", [
        "--checkpoint", "unused", "--fuse", "off", "--verbatimicity", "0.8"])
    plain = _decode(t_cli.main, cli, d / "t_plain", [
        "--checkpoint", str(cli["plain_pt"]), "--device", "cpu",
        "--verbatimicity", "1.0"])
    _lsl_factory(monkeypatch)
    port = ["--checkpoint", str(cli["pt"]), "--device", "cpu"]
    got = _decode(t_cli.main, cli, d / "t_v08",
                  port + ["--verbatimicity", "0.8"])
    assert got == want
    # varied words with times, not a trivially equal empty decode
    words = want[1].decode().split()[4::5]
    assert len(set(words)) >= 3
    assert (_decode(t_cli.main, cli, d / "t_none", port)
            == _decode(t_cli.main, cli, d / "t_v05",
                       port + ["--verbatimicity", "0.5"]))
    # a YAML model has no LSL blocks: the flag changes nothing
    monkeypatch.undo()
    assert plain == _decode(t_cli.main, cli, d / "t_plain_none", [
        "--checkpoint", str(cli["plain_pt"]), "--device", "cpu"])


def test_write_embeddings_cat_embs_match_jax_cli(cli, monkeypatch):
    d = cli["d"]
    monkeypatch.setattr(j_recognize, "build_decode_assets",
                        cli["jax_assets"])
    _lsl_factory(monkeypatch)
    common = ["--config", str(cli["cfg"]), "--test_data",
              str(d / "data.list"), "--data_type", "raw", "--batch_size",
              "2", "--cat_embs", "0.8,0.2"]
    assert j_emb.main(common + ["--checkpoint", "unused", "--output_name",
                                str(d / "j_emb")]) == 0
    assert t_emb.main(common + ["--checkpoint", str(cli["pt"]),
                                "--output_name", str(d / "t_emb"),
                                "--device", "cpu"]) == 0
    assert ((d / "t_emb" / "sample_names").read_text()
            == (d / "j_emb" / "sample_names").read_text())
    for i in range(3):
        want = np.loadtxt(d / "j_emb" / f"embeddings_layer_{i}")
        got = np.loadtxt(d / "t_emb" / f"embeddings_layer_{i}")
        assert got.shape == want.shape == (2, 32)
        np.testing.assert_allclose(got, want,
                                   atol=1e-4 * np.abs(want).max())
