"""The port's model parts against the JAX package's, on the same weights.

f32, ``.eval()``, weights filled from a numpy seed over ``jax.eval_shape``
(``tests/test_torch_encoder_families.seeded_params``) and carried by
``convert.state_dict_from_jax``:

* the five subsamplings (``linear``, ``conv1d2``, ``conv2d``, ``conv2d6``,
  ``conv2d8``) with lengths that reach the clamp at 0, within 1e-5;
* the learnable positional encoding at offsets 0 and 7, within 1e-6;
* the mixture-of-experts FFN (swish and tanh-GELU), with gate logits tied
  between experts so the top-k's lowest-index rule decides, within 1e-5;
  the selection alone equals ``jax.lax.top_k`` on integer rows full of
  ties;
* LoRA's Dense and Embed within 1e-5, and ``merge_lora_params`` equal to
  JAX's merge (the folded forward equals the unfolded one at alpha / r =
  2, JAX's fixed merge scale);
* the ``embedding`` and ``conv`` predictors through the transducer loss
  (RNN-T, CTC and total within 1e-5), and the searches refusing them;
* ``mfcc`` within 2e-3 (the fbank it starts from is held to 1e-3 by
  ``tests/test_torch_frontend.py``; the DCT sums 23 such bins);
* the weight bridge's ``batch_stats`` errors.
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paper_accurate_fast_cheap_tpu.frontend import features as j_features
from paper_accurate_fast_cheap_tpu.models import convolution as j_conv
from paper_accurate_fast_cheap_tpu.models import embedding as j_emb
from paper_accurate_fast_cheap_tpu.models import lora as j_lora
from paper_accurate_fast_cheap_tpu.models import subsampling as j_sub
from paper_accurate_fast_cheap_tpu.models.transducer import (
    Transducer as JTransducer)
from paper_accurate_fast_cheap_tpu_torch.convert import state_dict_from_jax
from paper_accurate_fast_cheap_tpu_torch.decode import rnnt_search as t_search
from paper_accurate_fast_cheap_tpu_torch.frontend import (
    features as t_features)
from paper_accurate_fast_cheap_tpu_torch.models import convolution as t_conv
from paper_accurate_fast_cheap_tpu_torch.models import embedding as t_emb
from paper_accurate_fast_cheap_tpu_torch.models import factory as t_factory
from paper_accurate_fast_cheap_tpu_torch.models import lora as t_lora
from paper_accurate_fast_cheap_tpu_torch.models import subsampling as t_sub
from paper_accurate_fast_cheap_tpu_torch.models.transducer import (
    Transducer as TTransducer)
from test_torch_encoder_families import seeded_params

TOL = dict(rtol=1e-5, atol=1e-5)


def _carry(jmod, tmod, seed, *args, **kw):
    """JAX's output on ``args`` (numpy leaves) and the port module with the
    same seeded weights."""
    jargs = [jnp.asarray(a) for a in args]
    params = seeded_params(jmod, np.random.RandomState(seed), *jargs, **kw)
    want = jax.jit(lambda p, *a: jmod.apply(p, *a, **kw))(params, *jargs)
    tmod.load_state_dict(state_dict_from_jax(params))
    return jax.tree.map(np.asarray, want), tmod.eval(), params


@pytest.mark.parametrize("kind", ["linear", "conv1d2", "conv2d", "conv2d6",
                                  "conv2d8"])
def test_subsampling_matches_jax(kind):
    jcls = {"linear": j_sub.LinearNoSubsampling,
            "conv1d2": j_sub.Conv1dSubsampling2,
            "conv2d": j_sub.Conv2dSubsampling4,
            "conv2d6": j_sub.Conv2dSubsampling6,
            "conv2d8": j_sub.Conv2dSubsampling8}[kind]
    rng = np.random.RandomState(1)
    x = rng.randn(3, 61, 20).astype(np.float32)
    lens = np.asarray([61, 9, 2], np.int32)
    (want, wl), tmod, _ = _carry(jcls(idim=20, odim=24),
                                 t_sub.SUBSAMPLE_CLASSES[kind](20, 24), 2,
                                 x, lens)
    with torch.no_grad():
        got, gl = tmod(torch.from_numpy(x), torch.from_numpy(lens))
    np.testing.assert_array_equal(gl.numpy(), wl)
    assert gl.min() >= 0
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("offset", [0, 7])
def test_learnable_positions_match_jax(offset):
    jmod = j_emb.LearnablePositionalEncoding(d_model=16, max_len=64)
    tmod = t_emb.LearnablePositionalEncoding(16, max_len=64)
    x = np.random.RandomState(3).randn(2, 11, 16).astype(np.float32)
    (want_y, want_p), tmod, _ = _carry(jmod, tmod, 4, x, offset=offset)
    with torch.no_grad():
        got_y, got_p = tmod(torch.from_numpy(x), offset=offset)
    np.testing.assert_allclose(got_y.numpy(), want_y, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got_p.detach().numpy(), want_p)


def test_top_k_ties_to_lowest_index():
    x = np.random.RandomState(5).randint(0, 4, (64, 9)).astype(np.float32)
    for k in (1, 2, 5):
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        tv, ti = t_conv.top_k_lowest_index(torch.from_numpy(x), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("activation", ["swish", "gelu"])
def test_moe_matches_jax(activation):
    jmod = j_conv.MoEFFNLayer(d_model=16, hidden=24, n_experts=4,
                              n_expert_per_token=2, activation=activation)
    tmod = t_conv.MoEFFNLayer(16, 24, 4, 2, activation)
    x = np.random.RandomState(6).randn(2, 13, 16).astype(np.float32)
    jx = jnp.asarray(x)
    params = jax.tree.map(np.array, seeded_params(
        jmod, np.random.RandomState(7), jx))
    # experts 1 and 2 share a gate column: their logits tie on every frame
    gate = params["params"]["gate"]["kernel"]
    gate[:, 2] = gate[:, 1]
    want = np.asarray(jmod.apply(params, jx))
    tmod.load_state_dict(state_dict_from_jax(params))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


class _JLoRAPair(fnn.Module):
    r: int
    alpha: float

    @fnn.compact
    def __call__(self, x, ids):
        return (j_lora.LoRADense(24, r=self.r, alpha=self.alpha,
                                 name="dense")(x),
                j_lora.LoRAEmbed(30, 24, r=self.r, alpha=self.alpha,
                                 name="emb")(ids))


class _TLoRAPair(torch.nn.Module):
    def __init__(self, r, alpha):
        super().__init__()
        self.dense = t_lora.LoRADense(16, 24, r=r, alpha=alpha)
        self.emb = t_lora.LoRAEmbed(30, 24, r=r, alpha=alpha)

    def forward(self, x, ids):
        return self.dense(x), self.emb(ids)


@pytest.mark.parametrize("r,alpha", [(4, 8.0), (8, 32.0)])
def test_lora_and_merge_match_jax(r, alpha):
    rng = np.random.RandomState(8)
    x = rng.randn(3, 5, 16).astype(np.float32)
    ids = rng.randint(0, 30, (3, 5)).astype(np.int32)
    (want_d, want_e), tmod, params = _carry(
        _JLoRAPair(r, alpha), _TLoRAPair(r, alpha), 9, x, ids)
    with torch.no_grad():
        got_d, got_e = tmod(torch.from_numpy(x), torch.from_numpy(ids).long())
    np.testing.assert_allclose(got_d.numpy(), want_d, **TOL)
    np.testing.assert_allclose(got_e.numpy(), want_e, **TOL)
    merged = t_lora.merge_lora_params(tmod)
    want = state_dict_from_jax(jax.tree.map(
        np.asarray, j_lora.merge_lora_params(params["params"])))
    assert set(merged) == set(want)
    for k in want:
        torch.testing.assert_close(merged[k], want[k], rtol=1e-6, atol=1e-6)
    if alpha / r == t_lora.MERGE_SCALE:
        folded = _TLoRAPair(r, alpha)
        folded.load_state_dict(merged)
        with torch.no_grad():
            fd, fe = folded(torch.from_numpy(x), torch.from_numpy(ids).long())
        torch.testing.assert_close(fd, got_d, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(fe, got_e, rtol=1e-5, atol=1e-5)


ENC = dict(input_size=16, output_size=32, attention_heads=2,
           linear_units=32, num_blocks=1, input_layer="linear",
           dropout_rate=0.0)


@pytest.mark.parametrize("predictor,conf", [
    ("embedding", dict(embed_size=24, output_size=32, history_size=2)),
    ("conv", dict(embed_size=24, output_size=32, kernel_size=3))])
def test_predictor_loss_matches_jax(predictor, conf):
    V = 20
    rng = np.random.RandomState(10)
    feats = rng.randn(2, 21, 16).astype(np.float32)
    flens = np.asarray([21, 14], np.int32)
    labels = rng.randint(1, V, (2, 5)).astype(np.int32)
    llens = np.asarray([5, 3], np.int32)
    kw = dict(vocab_size=V, encoder_conf=ENC, predictor=predictor,
              predictor_conf=conf, joint_conf={"join_dim": 16},
              transducer_weight=0.7, ctc_weight=0.3, attention_weight=0.0)
    jm = JTransducer(**kw)
    args = [jnp.asarray(a) for a in (feats, flens, labels, llens)]
    params = seeded_params(jm, np.random.RandomState(11), *args)
    want = jax.jit(jm.apply)(params, *args)
    tm = TTransducer(**kw)
    tm.load_state_dict(state_dict_from_jax(params))
    with torch.no_grad():
        got = tm.eval()(*(torch.from_numpy(a)
                          for a in (feats, flens, labels, llens)))
    for k in ("loss", "loss_rnnt", "loss_ctc"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), **TOL)
    with pytest.raises(NotImplementedError, match="no init_state"):
        t_search.make_transducer_step_fns(tm)
    model, kind = t_factory.init_model(
        {"model": "transducer", "encoder": "conformer", "encoder_conf": ENC,
         "predictor": predictor, "predictor_conf": conf}, V, 16,
        device="cpu")
    assert kind == "transducer" and model.predictor_type == predictor
    with pytest.raises(NotImplementedError, match=predictor):
        model.predictor_init_state(2)


def test_mfcc_matches_jax():
    wav = (np.random.RandomState(12).randn(6000) * 3000).astype(np.float32)
    want = np.asarray(j_features.mfcc(jnp.asarray(wav)))
    got = t_features.mfcc(torch.from_numpy(wav)).numpy()
    assert got.shape == want.shape == (36, 13)
    np.testing.assert_allclose(got, want, atol=2e-3)


def test_bridge_batch_stats():
    tree = {"params": {"bn": {"scale": np.ones(3, np.float32)}},
            "batch_stats": {"bn": {"mean": np.zeros(3, np.float32),
                                   "var": np.ones(3, np.float32)}}}
    assert sorted(state_dict_from_jax(tree)) == [
        "bn.running_mean", "bn.running_var", "bn.weight"]
    tree["batch_stats"]["bn"]["count"] = np.zeros(1, np.float32)
    with pytest.raises(KeyError, match="count"):
        state_dict_from_jax(tree)
