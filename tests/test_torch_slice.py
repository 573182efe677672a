"""The port's long-form decode slice against the JAX package, end to end.

A tiny transducer of the flagship family (2 conformer blocks of width 32,
bidirectional RWKV-6 with head size 16, a 1-layer LSTM predictor of 32,
V=1100 so the two-level vocab top-k runs, blank bias +2.5 on both heads)
is initialised in JAX; its weights reach the port through
``convert.state_dict_from_jax``.  Waveform -> fbank + CMVN -> encoder ->
CTC log-probs -> device prefix beam (beam 4) runs in both, in f32 with
``rwkv_do_bfloat16: False``; the port runs its plain versions on the CPU.
The port's beam runs each of its three top-k routes (``pallas_joint``: K2,
``pallas``: K4, ``xla``: K5) on the same encoder output, and every route
gives the JAX package's tokens.  The flagship's default bf16 RWKV cast
(``rwkv_do_bfloat16: True``) is held to JAX on the same weights at a bf16
tolerance.
"""
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paper_accurate_fast_cheap_tpu.decode import rnnt_search as j_search
from paper_accurate_fast_cheap_tpu.frontend import pipeline as j_pipeline
from paper_accurate_fast_cheap_tpu.models import factory as j_factory
from paper_accurate_fast_cheap_tpu_torch.convert import state_dict_from_jax
from paper_accurate_fast_cheap_tpu_torch.decode import rnnt_search as t_search
from paper_accurate_fast_cheap_tpu_torch.frontend import (
    pipeline as t_pipeline)
from paper_accurate_fast_cheap_tpu_torch.models import factory as t_factory
from paper_accurate_fast_cheap_tpu_torch.models.rwkv import RWKVAttention

VOCAB = 1100
BEAM = 4
CONFIG = {
    "model": "transducer",
    "encoder": "conformer",
    "encoder_conf": dict(
        output_size=32, attention_heads=2, linear_units=64, num_blocks=2,
        input_layer="conv2d", pos_enc_layer_type="rel_pos",
        cnn_module_kernel=15, cnn_module_norm="layer_norm",
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
}


@pytest.fixture(scope="module")
def slice_run():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(0)
    lens = np.asarray([9600, 7200], np.int32)            # 0.6 s and 0.45 s
    wavs = (rng.randn(2, 9600) * 0.1).astype(np.float32)
    wavs[1, 7200:] = 0.0
    cmvn = ((rng.randn(80) + 8.0).astype(np.float32),
            (0.3 + 0.05 * rng.rand(80)).astype(np.float32))

    model, _ = j_factory.init_model(CONFIG, VOCAB, 80)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 80)),
                        jnp.asarray([64]), jnp.ones((1, 4), jnp.int32),
                        jnp.asarray([4]))
    p = params["params"]
    p["joint"]["ffn_out"]["bias"] = p["joint"]["ffn_out"]["bias"].at[0].add(
        2.5)
    p["ctc"]["ctc_lo"]["bias"] = p["ctc"]["ctc_lo"]["bias"].at[0].add(2.5)

    j_feats, j_flens = j_pipeline.make_feature_fn({}, cmvn)(
        jnp.asarray(wavs), jnp.asarray(lens))
    # jitted: one compile costs less on the CPU than the eager op stream
    j_enc, j_elens = jax.jit(functools.partial(
        model.apply, method=model.forward_encoder))(params, j_feats, j_flens)
    j_ctc = model.apply(params, j_enc, method=model.ctc_logprobs)
    fns = j_search.make_transducer_step_fns(model, params)
    j_res = j_search.finalize_device_beam(j_search.pack_device_beam(
        j_search.rnnt_beam_search(
            *fns, j_enc, j_elens, j_ctc, beam_size=BEAM, ctc_weight=0.3,
            transducer_weight=0.7, impl="device", params=params,
            defer=True)), beam=BEAM)

    tmodel, kind = t_factory.init_model(CONFIG, VOCAB, 80, device="cpu")
    assert kind == "transducer"
    tmodel.load_state_dict(state_dict_from_jax(
        jax.tree.map(np.asarray, params)))
    t_feats, t_flens = t_pipeline.make_feature_fn({}, cmvn, device="cpu")(
        torch.from_numpy(wavs), torch.from_numpy(lens))
    t_enc, t_elens = tmodel.forward_encoder(t_feats, t_flens)
    t_ctc = tmodel.ctc_logprobs(t_enc)
    t_res = t_search.finalize_device_beam(t_search.pack_device_beam(
        t_search.rnnt_beam_search(
            *t_search.make_transducer_step_fns(tmodel), t_enc, t_elens,
            t_ctc, beam_size=BEAM, ctc_weight=0.3, transducer_weight=0.7,
            impl="device", defer=True)), beam=BEAM)
    # the encoder on JAX's own features: isolates it from the FFT's rounding
    t_enc_j, _ = tmodel.forward_encoder(torch.from_numpy(np.array(j_feats)),
                                        torch.from_numpy(np.array(j_flens)))
    return dict(tmodel=tmodel, params=params, j_flens=j_flens,
                j_feats=j_feats, t_feats=t_feats, j_enc=j_enc, t_enc=t_enc,
                t_enc_j=t_enc_j, j_elens=j_elens, t_elens=t_elens,
                j_ctc=j_ctc, t_ctc=t_ctc, j_res=j_res, t_res=t_res)


def test_features_match(slice_run):
    # two FFT implementations on int16-scale frames: ~1e-3 on log-mel
    np.testing.assert_allclose(slice_run["t_feats"].numpy(),
                               np.asarray(slice_run["j_feats"]), atol=1e-3)


def test_encoder_and_ctc_match(slice_run):
    np.testing.assert_array_equal(slice_run["t_elens"].numpy(),
                                  np.asarray(slice_run["j_elens"]))
    # f32 on identical features: the chunked WKV and the products differ in
    # summation order only
    np.testing.assert_allclose(slice_run["t_enc_j"].numpy(),
                               np.asarray(slice_run["j_enc"]), atol=1e-4)
    # end to end from the waveform (the fbank gap rides along; after CMVN
    # and the encoder's LayerNorms it stays well inside 1e-4 here)
    np.testing.assert_allclose(slice_run["t_enc"].numpy(),
                               np.asarray(slice_run["j_enc"]), atol=1e-4)
    np.testing.assert_allclose(slice_run["t_ctc"].numpy(),
                               np.asarray(slice_run["j_ctc"]), atol=1e-4)


def test_beam_tokens_identical(slice_run):
    j_res, t_res = slice_run["j_res"], slice_run["t_res"]
    assert len(j_res) == len(t_res) == 2
    assert any(r.tokens for r in j_res)
    for a, b in zip(j_res, t_res):
        assert a.tokens == b.tokens
        assert a.nbest == b.nbest
        np.testing.assert_allclose(b.nbest_scores, a.nbest_scores,
                                   rtol=1e-4)


@pytest.mark.parametrize("topk_impl", ["pallas_joint", "pallas", "xla"])
def test_beam_routes_tokens_identical(slice_run, topk_impl):
    tmodel = slice_run["tmodel"]
    res = t_search.rnnt_beam_search(
        *t_search.make_transducer_step_fns(tmodel), slice_run["t_enc"],
        slice_run["t_elens"], slice_run["t_ctc"], beam_size=BEAM,
        ctc_weight=0.3, transducer_weight=0.7, topk_impl=topk_impl)
    for a, b in zip(slice_run["j_res"], res):
        assert a.tokens == b.tokens
        assert a.nbest == b.nbest
        np.testing.assert_allclose(b.nbest_scores, a.nbest_scores,
                                   rtol=1e-4)


@pytest.fixture(scope="module")
def bf16_run(slice_run):
    """The same weights with the flagship's default bf16 RWKV cast on, in
    both packages: JAX's encoder, CTC and beam, and the port's encoder on
    JAX's features, its beam on its own encoder output and on JAX's."""
    conf = copy.deepcopy(CONFIG)
    conf["encoder_conf"]["rwkv_do_bfloat16"] = True
    model, _ = j_factory.init_model(conf, VOCAB, 80)
    params = slice_run["params"]
    j_enc, j_elens = jax.jit(functools.partial(
        model.apply, method=model.forward_encoder))(
            params, slice_run["j_feats"], slice_run["j_flens"])
    j_ctc = model.apply(params, j_enc, method=model.ctc_logprobs)
    j_res = j_search.rnnt_beam_search(
        *j_search.make_transducer_step_fns(model, params), j_enc, j_elens,
        j_ctc, beam_size=BEAM, ctc_weight=0.3, transducer_weight=0.7,
        impl="device", params=params)
    tmodel = copy.deepcopy(slice_run["tmodel"])
    for m in tmodel.modules():
        if isinstance(m, RWKVAttention):
            m.do_bfloat16 = True
    t_enc, t_elens = tmodel.forward_encoder(
        torch.from_numpy(np.array(slice_run["j_feats"])),
        torch.from_numpy(np.array(slice_run["j_flens"])))
    t_ctc = tmodel.ctc_logprobs(t_enc)
    fns = t_search.make_transducer_step_fns(tmodel)
    kw = dict(beam_size=BEAM, ctc_weight=0.3, transducer_weight=0.7)
    t_res = t_search.rnnt_beam_search(*fns, t_enc, t_elens, t_ctc, **kw)
    t_res_on_j = t_search.rnnt_beam_search(
        *fns, torch.from_numpy(np.array(j_enc)), t_elens,
        torch.from_numpy(np.array(j_ctc)), **kw)
    return dict(j_enc=j_enc, j_ctc=j_ctc, j_res=j_res, t_enc=t_enc,
                t_ctc=t_ctc, t_res=t_res, t_res_on_j=t_res_on_j)


def test_bf16_rwkv_cast_matches_jax(slice_run, bf16_run):
    """The flagship default (RWKV inputs cast to bf16) against JAX.

    Encoder and CTC log-probs within 3e-2 absolute, ~1% of the encoder's
    output scale (~3 here): both packages round the time-mix inputs to bf16
    (2^-8 relative), but in a different op order, so some roundings flip
    and the flips ride through two blocks.  Measured: 6.4e-3 (encoder) and
    8.0e-3 (CTC); the same cast on 2 x 300 random frames gave 1.5e-2 on a
    scale of 3.6.  With the cast off the gap is 1e-4 (above).  The tokens
    are compared because they are shown stable under that gap: the port's
    beam gives JAX's tokens both on its own encoder output and on JAX's.
    Best scores within 2e-3 relative (measured 3e-4: the log-probs' gap
    summed over the frames).
    """
    b = bf16_run
    j_enc = np.asarray(b["j_enc"])
    assert np.abs(j_enc).max() > 1.0          # the scale the bound assumes
    np.testing.assert_allclose(b["t_enc"].numpy(), j_enc, atol=3e-2)
    np.testing.assert_allclose(b["t_ctc"].numpy(), np.asarray(b["j_ctc"]),
                               atol=3e-2)
    # the cast is on: the encoder differs from the f32 run's by more than
    # the f32 runs differ from each other (1e-4)
    assert np.abs(j_enc - np.asarray(slice_run["j_enc"])).max() > 1e-3
    assert any(r.tokens for r in b["j_res"])
    for a, t, tj in zip(b["j_res"], b["t_res"], b["t_res_on_j"]):
        assert a.tokens == t.tokens == tj.tokens
        np.testing.assert_allclose(t.nbest_scores[:1], a.nbest_scores[:1],
                                   rtol=2e-3)
