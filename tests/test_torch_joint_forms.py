"""Every transducer joint form the JAX package builds, in the port, against
JAX on the same weights.

The forms (JAX ``models/joint.py``): ``activation`` relu and swish,
``postjoin_linear`` (a ``post_ffn`` Dense before the activation) and
``prejoin_linear: false`` (no ``enc_ffn``/``pred_ffn``), each with the
standard ``ffn_out`` head and with the HAT head.  A tiny transducer of each
(encoder width 16, a 1-layer LSTM predictor of 16, V = 40) is built by both
factories; JAX's parameters are filled from a seed
(``test_torch_encoder_families.seeded_params``) and reach the port through
``convert.state_dict_from_jax``.  On random encoder outputs each form's
joint logits match within 1e-5, its RNN-T loss (the port's chunked
``loss_from_encoder`` against JAX's dense oracle ``rnnt_loss_dense`` on the
JAX predictor's outputs) within 1e-5 relative, and the port's
device beam gives JAX's host-beam oracle's tokens on each of the three
``topk_impl`` routes (``pallas_joint``: K2 on ``preact``'s output, which
takes ``pallas`` for HAT; ``pallas``: K4; ``xla``: K5; their plain versions
here).  JAX runs eagerly: one compile per primitive shape serves every
form.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paper_accurate_fast_cheap_tpu.decode import rnnt_search as j_search
from paper_accurate_fast_cheap_tpu.models import factory as j_factory
from paper_accurate_fast_cheap_tpu.ops import rnnt as j_rnnt
from paper_accurate_fast_cheap_tpu.utils import common
from paper_accurate_fast_cheap_tpu_torch.convert import state_dict_from_jax
from paper_accurate_fast_cheap_tpu_torch.decode import rnnt_search as t_search
from paper_accurate_fast_cheap_tpu_torch.models import factory as t_factory
from paper_accurate_fast_cheap_tpu_torch.models.joint import TransducerJoint
from test_torch_encoder_families import seeded_params

V, D, B, T, U, BEAM = 40, 16, 2, 5, 3, 4
FORMS = {"relu": {"activation": "relu"},
         "swish": {"activation": "swish"},
         "postjoin": {"postjoin_linear": True},
         "no_prejoin": {"prejoin_linear": False}}
CASES = [(f, hat) for f in FORMS for hat in (False, True)]
IDS = [f"{f}-{'hat' if hat else 'ffn_out'}" for f, hat in CASES]
ROUTES = ("pallas_joint", "pallas", "xla")
_RUNS = {}


def _config(form: str, hat: bool) -> dict:
    return {
        "model": "transducer", "encoder": "conformer",
        "encoder_conf": dict(output_size=D, attention_heads=2,
                             linear_units=32, num_blocks=1,
                             input_layer="linear",
                             selfattention_layer_type="rwkv_tmix60",
                             rwkv_do_bfloat16=False),
        "predictor": "rnn",
        "predictor_conf": {"embed_size": D, "output_size": D,
                           "hidden_size": D, "num_layers": 1,
                           "embed_dropout": 0.0, "dropout": 0.0},
        "joint_conf": dict(join_dim=D, hat_joint=hat, **FORMS[form]),
        "decoder": None,
        "model_conf": {"ctc_weight": 0.3, "transducer_weight": 0.7,
                       "attention_weight": 0.0},
    }


def _run(form: str, hat: bool) -> dict:
    """Both models of one form and their outputs (cached)."""
    key = (form, hat)
    if key in _RUNS:
        return _RUNS[key]
    rng = np.random.RandomState(len(_RUNS))
    config = _config(form, hat)
    jm, _ = j_factory.init_model(config, V, 8)
    init = (jnp.zeros((1, 8, 8)), jnp.asarray([8]), jnp.ones((1, 2),
                                                             jnp.int32),
            jnp.asarray([2]))
    params = seeded_params(jm, rng, *init)
    # a blank-shy head, so every form's beam emits tokens
    head = params["params"]["joint"]["blank_pred" if hat else "ffn_out"]
    head["bias"][0] -= 3.0
    tm, kind = t_factory.init_model(config, V, 8, device="cpu")
    assert kind == "transducer"
    tm.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params)))
    tm.eval()

    enc = rng.randn(B, T, D).astype(np.float32)
    pred = rng.randn(B, U + 1, D).astype(np.float32)
    elens = np.asarray([T, T - 2], np.int32)
    labels = rng.randint(1, V, (B, U)).astype(np.int32)
    llens = np.asarray([U, U - 1], np.int32)
    ctc = np.array(jax.nn.log_softmax(rng.randn(B, T, V).astype(
        np.float32), axis=-1))
    out = {"tm": tm, "enc": enc, "elens": elens, "ctc": ctc}

    out["j_logits"] = np.asarray(jm.apply(
        params, jnp.asarray(enc), jnp.asarray(pred),
        method=lambda m, e, p: m.joint(e, p)))
    # JAX's dense oracle on its own predictor's outputs (the chunked
    # loss's own oracle; eager, it costs a fraction of the chunked form)
    ys_blank = common.add_blank(jnp.asarray(labels), jnp.asarray(llens), 0)
    j_full = jm.apply(params, jnp.asarray(enc), ys_blank,
                      method=lambda m, e, y: m.joint(e, m.predictor_mod(y)))
    out["j_loss"] = float(jnp.mean(j_rnnt.rnnt_loss_dense(
        j_full, jnp.asarray(labels), jnp.asarray(elens),
        jnp.asarray(llens))))
    with torch.no_grad():
        j = tm.joint
        e_t, p_t = torch.from_numpy(enc), torch.from_numpy(pred)
        out["t_logits"] = j.joint_projected(
            j.project_enc(e_t)[:, :, None], j.project_pred(p_t)[:, None]
        ).numpy()
        out["t_loss"] = float(tm.loss_from_encoder(
            e_t, torch.from_numpy(elens), torch.from_numpy(labels).long(),
            torch.from_numpy(llens))["loss_rnnt"])

    fns = (lambda p, tok, st: jm.apply(p, tok, st,
                                       method=jm.predictor_step),
           lambda p, e, pr: jm.apply(p, e, pr, method=jm.joint_step),
           lambda n: jm.apply(params, n, method=jm.predictor_init_state))
    j_res = j_search.rnnt_beam_search(
        *fns, jnp.asarray(enc), jnp.asarray(elens), jnp.asarray(ctc),
        beam_size=BEAM, ctc_weight=0.3, transducer_weight=0.7,
        impl="host", params=params)
    out["j_tokens"] = [r.tokens for r in j_res]
    _RUNS[key] = out
    return out


@pytest.mark.parametrize("form,hat", CASES, ids=IDS)
def test_joint_logits_match_jax(form, hat):
    r = _run(form, hat)
    assert r["t_logits"].shape == (B, T, U + 1, V)
    np.testing.assert_allclose(r["t_logits"], r["j_logits"], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("form,hat", CASES, ids=IDS)
def test_rnnt_loss_matches_jax(form, hat):
    r = _run(form, hat)
    assert np.isfinite(r["t_loss"])
    assert abs(r["t_loss"] - r["j_loss"]) <= 1e-5 * abs(r["j_loss"])


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("form,hat", CASES, ids=IDS)
def test_beam_tokens_on_each_route(form, hat, route):
    r = _run(form, hat)
    res = t_search.rnnt_beam_search(
        *t_search.make_transducer_step_fns(r["tm"]),
        torch.from_numpy(r["enc"]), torch.from_numpy(r["elens"]),
        torch.from_numpy(r["ctc"]), beam_size=BEAM, ctc_weight=0.3,
        transducer_weight=0.7, topk_impl=route)
    assert [x.tokens for x in res] == r["j_tokens"]
    assert any(r["j_tokens"])


def test_wenet_converter_carries_post_ffn():
    """``tools/convert_checkpoint.py`` reads WeNet's ``joint.post_ffn``
    (and the pre-join projections and head) into the port's joint."""
    from paper_accurate_fast_cheap_tpu_torch.tools import (
        convert_checkpoint as cc)

    tm = _run("postjoin", False)["tm"]
    state = tm.state_dict()
    g = torch.Generator().manual_seed(7)
    wenet = {k: torch.randn(v.shape, generator=g) for k, v in state.items()
             if k.startswith("joint.")}
    c = cc._Converter(wenet, state)
    cc._transducer(c)
    assert "joint.post_ffn.weight" in wenet and c.read == set(wenet)
    for k, v in wenet.items():
        assert torch.equal(c.out[k], v), k


def test_joint_refusals():
    """JAX asserts add mode; without pre-join projections the encoder and
    predictor widths must agree (they are added directly)."""
    with pytest.raises(ValueError, match="joint_mode"):
        TransducerJoint(V, D, D, D, joint_mode="concat")
    with pytest.raises(ValueError, match="prejoin_linear"):
        TransducerJoint(V, D, 2 * D, D, prejoin_linear=False)
    with pytest.raises(ValueError, match="activation"):
        TransducerJoint(V, D, D, D, activation="gelu")
