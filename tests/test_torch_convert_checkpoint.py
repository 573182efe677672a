"""The port's WeNet checkpoint converter against the JAX package's.

Fake reference-named state_dicts (no download) for five models: a
conformer with bidirectional RWKV-6 and the bitransformer decoder
(``ASRModel``), a rel-pos MHA transducer, an LCA transducer with a
global token (whose reference ``global_q/k/v`` neither package reads), and
bi and uni Mamba-2 transducers (mamba_ssm's ``Mamba2`` tensors through
``_mamba2``; the uni one without the optional conv bias).
Every tensor of the port's ``convert_state_dict`` equals
``state_dict_from_jax`` of the JAX ``convert_state_dict`` bit for bit; the
port's model loads the result strictly and its encoder matches JAX's on the
converted weights within 1e-4; ``main`` round-trips through ``torch.save``
files.
"""
import functools
import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paper_accurate_fast_cheap_tpu.models import factory as j_factory
from paper_accurate_fast_cheap_tpu.tools.convert_checkpoint import (
    convert_state_dict as j_convert)
from paper_accurate_fast_cheap_tpu_torch.convert import state_dict_from_jax
from paper_accurate_fast_cheap_tpu_torch.models import factory as t_factory
from paper_accurate_fast_cheap_tpu_torch.tools import convert_checkpoint

D, FF, VOCAB, MELS, HEADS = 32, 64, 12, 23, 2


def _config(attn: str, model: str, **enc) -> dict:
    conf = {
        "model": model, "encoder": "conformer",
        "encoder_conf": dict(
            output_size=D, attention_heads=HEADS, linear_units=FF,
            num_blocks=2, selfattention_layer_type=attn, dropout_rate=0.0,
            rwkv_do_bfloat16=False, **enc),
        "model_conf": {"ctc_weight": 0.3, "reverse_weight": 0.3},
    }
    if model == "asr_model":
        conf.update(decoder="bitransformer", decoder_conf=dict(
            attention_heads=HEADS, linear_units=FF, num_blocks=1,
            r_num_blocks=1, dropout_rate=0.0))
    else:
        conf.update(
            decoder=None, predictor="rnn",
            predictor_conf={"embed_size": D, "hidden_size": D,
                            "output_size": D, "num_layers": 2},
            joint_conf={"join_dim": D},
            model_conf={"ctc_weight": 0.3, "transducer_weight": 0.7,
                        "attention_weight": 0.0})
    return conf


CASES = {
    "rwkv_bi_bidecoder": _config("rwkv_tmix60_bidirectional", "asr_model"),
    "mha_transducer": _config("rel_selfattn", "transducer"),
    "lca_gt_transducer": _config("limited_rel_selfattn", "transducer",
                                 att_context_size=[4, 4], global_tokens=1),
    "mambabi_transducer": _config("mamba_att", "transducer",
                                  rnn_att_direction="bi"),
    "mamba_uni_transducer": _config("mamba_att", "transducer",
                                    rnn_att_direction="uni"),
}
# the Mamba-2 block at d = 32: d_inner 64, headdim D / HEADS, d_state 128
M_IN, M_N, M_CONV = 2 * D, 128, 4
M_H = M_IN // (D // HEADS)


def _fake_ref_state_dict(case: str, seed: int = 0) -> dict:
    """Reference-named tensors of a 2-block conformer of ``case``."""
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    sd = {"encoder.embed.conv.0.weight": f(D, 1, 3, 3),
          "encoder.embed.conv.0.bias": f(D),
          "encoder.embed.conv.2.weight": f(D, D, 3, 3),
          "encoder.embed.conv.2.bias": f(D),
          "encoder.embed.out.0.weight": f(D, (((MELS - 1) // 2 - 1) // 2)
                                          * D),
          "encoder.embed.out.0.bias": f(D)}
    lin = lambda p, o, i, bias=True: sd.update(  # noqa: E731
        {f"{p}.weight": f(o, i), **({f"{p}.bias": f(o)} if bias else {})})
    for i in range(2):
        src = f"encoder.encoders.{i}"
        for n in ("norm_ff", "norm_mha", "norm_ff_macaron", "norm_conv",
                  "norm_final"):
            sd[f"{src}.{n}.weight"], sd[f"{src}.{n}.bias"] = f(D), f(D)
        for n in ("feed_forward", "feed_forward_macaron"):
            lin(f"{src}.{n}.w_1", FF, D)
            lin(f"{src}.{n}.w_2", D, FF)
        cm = f"{src}.conv_module"
        sd[f"{cm}.pointwise_conv1.weight"] = f(2 * D, D, 1)
        sd[f"{cm}.pointwise_conv1.bias"] = f(2 * D)
        sd[f"{cm}.depthwise_conv.weight"] = f(D, 1, 31)
        sd[f"{cm}.depthwise_conv.bias"] = f(D)
        sd[f"{cm}.norm.weight"], sd[f"{cm}.norm.bias"] = f(D), f(D)
        sd[f"{cm}.pointwise_conv2.weight"] = f(D, D, 1)
        sd[f"{cm}.pointwise_conv2.bias"] = f(D)
        if case.startswith("rwkv"):
            for direction in ("forward", "backward"):
                pre = f"{src}.self_attn.rwkv_wrapper_{direction}.tmix_block"
                for n in ("time_maa_x", "time_maa_r", "time_maa_k",
                          "time_maa_v", "time_maa_w", "time_decay"):
                    sd[f"{pre}.{n}"] = f(1, 1, D)
                sd[f"{pre}.time_maa_rkvw_w1"] = f(D, 128)
                sd[f"{pre}.time_maa_rkvw_w2"] = f(4, 32, D)
                sd[f"{pre}.time_decay_w1"] = f(D, 64)
                sd[f"{pre}.time_decay_w2"] = f(64, D)
                sd[f"{pre}.time_faaaa"] = f(HEADS, D // HEADS)
                for n in ("receptance", "key", "value", "output"):
                    lin(f"{pre}.{n}", D, D, bias=False)
                sd[f"{pre}.ln_x.weight"], sd[f"{pre}.ln_x.bias"] = f(D), f(D)
        elif case.startswith("mamba"):
            pres = ([f"{src}.self_attn.mamba.mamba_forward",
                     f"{src}.self_attn.mamba.mamba_backward"]
                    if case.startswith("mambabi") else
                    [f"{src}.self_attn.mamba"])
            conv_dim = M_IN + 2 * M_N
            for pre in pres:
                lin(f"{pre}.in_proj", 2 * M_IN + 2 * M_N + M_H, D,
                    bias=False)
                sd[f"{pre}.conv1d.weight"] = f(conv_dim, 1, M_CONV)
                if case.startswith("mambabi"):
                    sd[f"{pre}.conv1d.bias"] = f(conv_dim)
                for n in ("dt_bias", "A_log", "D"):
                    sd[f"{pre}.{n}"] = f(M_H)
                sd[f"{pre}.norm.weight"] = f(M_IN)
                lin(f"{pre}.out_proj", D, M_IN, bias=False)
        else:
            sa = f"{src}.self_attn"
            for n in ("linear_q", "linear_k", "linear_v", "linear_out"):
                lin(f"{sa}.{n}", D, D)
            lin(f"{sa}.linear_pos", D, D, bias=False)
            sd[f"{sa}.pos_bias_u"] = f(HEADS, D // HEADS)
            sd[f"{sa}.pos_bias_v"] = f(HEADS, D // HEADS)
            if case.startswith("lca"):
                for n in ("global_q", "global_k", "global_v"):
                    lin(f"{sa}.{n}", D, D)
    sd["encoder.after_norm.weight"] = f(D)
    sd["encoder.after_norm.bias"] = f(D)
    lin("ctc.ctc_lo", VOCAB, D)
    if case.startswith("rwkv"):
        for side in ("left_decoder", "right_decoder"):
            dd = f"decoder.{side}"
            sd[f"{dd}.embed.0.weight"] = f(VOCAB, D)
            sd[f"{dd}.after_norm.weight"] = f(D)
            sd[f"{dd}.after_norm.bias"] = f(D)
            lin(f"{dd}.output_layer", VOCAB, D)
            dj = f"{dd}.decoders.0"
            for n in ("norm1", "norm2", "norm3"):
                sd[f"{dj}.{n}.weight"], sd[f"{dj}.{n}.bias"] = f(D), f(D)
            for blk in ("self_attn", "src_attn"):
                for n in ("linear_q", "linear_k", "linear_v", "linear_out"):
                    lin(f"{dj}.{blk}.{n}", D, D)
            lin(f"{dj}.feed_forward.w_1", FF, D)
            lin(f"{dj}.feed_forward.w_2", D, FF)
    else:
        sd["predictor.embed.weight"] = f(VOCAB, D)
        for k in range(2):
            sd[f"predictor.rnn.weight_ih_l{k}"] = f(4 * D, D)
            sd[f"predictor.rnn.weight_hh_l{k}"] = f(4 * D, D)
            sd[f"predictor.rnn.bias_ih_l{k}"] = f(4 * D)
            sd[f"predictor.rnn.bias_hh_l{k}"] = f(4 * D)
        lin("predictor.projection", D, D)
        for n in ("enc_ffn", "pred_ffn"):
            lin(f"joint.{n}", D, D)
        lin("joint.ffn_out", VOCAB, D)
    return sd


@pytest.fixture(scope="module")
def converted():
    """Per case: the reference state_dict, the JAX model and its converted
    weights, the port's conversion and its strictly loaded model.  LCA
    starts from the MHA transducer's init under its own names."""
    out = {}
    for case, config in CASES.items():
        model, _ = j_factory.init_model(config, VOCAB, MELS)
        if case.startswith("lca"):
            p = out["mha_transducer"]["init"]["params"]
            enc = {k.replace("RelPositionMultiHeadedAttention_",
                             "LimitedRelPositionAttention_"): v
                   for k, v in p["encoder"].items()}
            init = {"params": dict(p, encoder=enc)}
        else:
            init = jax.tree.map(np.array, model.init(
                jax.random.PRNGKey(0), jnp.zeros((1, 40, MELS)),
                jnp.asarray([40]), jnp.ones((1, 3), jnp.int32),
                jnp.asarray([3])))
        sd = _fake_ref_state_dict(case)
        want = state_dict_from_jax(j_convert(sd, init))
        got = convert_checkpoint.convert_state_dict(
            {k: torch.from_numpy(v) for k, v in sd.items()},
            state_dict_from_jax(init))
        tmodel, _ = t_factory.init_model(config, VOCAB, MELS, device="cpu")
        tmodel.load_state_dict(got, strict=True)
        out[case] = dict(init=init, sd=sd, want=want, got=got, model=model,
                         tmodel=tmodel, config=config)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_conversion_equals_jax_bit_for_bit(converted, case):
    c = converted[case]
    assert set(c["got"]) == set(c["want"])
    for name, w in c["want"].items():
        assert torch.equal(c["got"][name], w), name
    # the reference's tensors did reach the model
    assert torch.equal(c["got"]["ctc.ctc_lo.weight"],
                       torch.from_numpy(c["sd"]["ctc.ctc_lo.weight"]))


@pytest.mark.parametrize("case", list(CASES))
def test_converted_encoder_matches_jax(converted, case):
    c = converted[case]
    rng = np.random.RandomState(1)
    feats = rng.randn(2, 60, MELS).astype(np.float32)
    lens = np.asarray([60, 45], np.int32)
    params = jax.tree.map(jnp.asarray, j_convert(c["sd"], c["init"]))
    model = c["model"]
    j_enc, _ = jax.jit(functools.partial(
        model.apply, method=model.forward_encoder))(
            params, jnp.asarray(feats), jnp.asarray(lens))
    t_enc, _ = c["tmodel"].forward_encoder(torch.from_numpy(feats),
                                           torch.from_numpy(lens))
    np.testing.assert_allclose(t_enc.numpy(), np.asarray(j_enc), atol=1e-4)


def test_unread_reference_keys_are_logged(converted, caplog):
    c = converted["lca_gt_transducer"]
    with caplog.at_level(logging.INFO):
        convert_checkpoint.convert_state_dict(c["sd"], c["got"])
    text = caplog.text
    assert "encoder.encoders.0.self_attn.global_q.weight" in text
    assert "not read (12)" in text                 # global_q/k/v x 2 blocks


def test_main_round_trips_through_torch_save(converted, tmp_path):
    c = converted["mha_transducer"]
    units = tmp_path / "units.txt"
    units.write_text("".join(f"t{i} {i}\n" for i in range(VOCAB)))
    config = dict(c["config"], tokenizer="whitespace",
                  tokenizer_conf={"symbol_table_path": str(units)},
                  dataset_conf={"fbank_conf": {"num_mel_bins": MELS}})
    cfg = tmp_path / "conf.json"
    cfg.write_text(json.dumps(config))
    ref = tmp_path / "wenet.pt"
    torch.save({"model0": {k: torch.from_numpy(v)
                           for k, v in c["sd"].items()}}, str(ref))
    out = tmp_path / "model.pt"
    assert convert_checkpoint.main(["--checkpoint", str(ref), "--config",
                                    str(cfg), "--output", str(out)]) == 0
    state = torch.load(str(out), map_location="cpu", weights_only=True)
    tmodel, _ = t_factory.init_model(config, VOCAB, MELS, device="cpu")
    want = convert_checkpoint.convert_state_dict(c["sd"],
                                                 tmodel.state_dict())
    tmodel.load_state_dict(state, strict=True)
    assert set(state) == set(want)
    for name, w in want.items():
        assert torch.equal(state[name], w), name
