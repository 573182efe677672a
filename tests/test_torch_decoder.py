"""The port's attention decoder, its loss and the decoder-bearing models
against the JAX package, at tiny widths (d 64, 4 heads, 1 + 1 decoder
blocks, V = 12), f32, eval mode.

* ``MultiHeadedAttention`` (fully masked rows give zeros), the absolute
  ``PositionalEncoding``, ``TransformerDecoder``, ``BiTransformerDecoder``
  (right decoder on and off) and ``forward_one_step`` against the flax
  modules on the same weights (``convert.state_dict_from_jax``): 1e-5.
* ``label_smoothing_loss`` (both normalisations), ``add_sos_eos``,
  ``reverse_pad_list`` and ``accuracy``.
* The paper-shaped ``Transducer`` (transducer 0.3, CTC 0.2, attention 0.5,
  reverse 0.3, label smoothing 0.1) and the ``ASRModel``: every loss output
  (1e-5 relative) and every gradient (1e-4 of each tensor's largest entry,
  floored at 1e-4 of the largest gradient) against ``jax.grad``, and two
  steps of the paper's optimizer (Adam, clip 0.1) against optax on the
  same gradients (parameters within 1e-4 of each tensor's largest update),
  with the gradients at both steps' weights held to ``jax.grad``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from paper_accurate_fast_cheap_tpu.models import attention as j_att
from paper_accurate_fast_cheap_tpu.models import decoder as j_dec
from paper_accurate_fast_cheap_tpu.models import embedding as j_emb
from paper_accurate_fast_cheap_tpu.models import factory as j_factory
from paper_accurate_fast_cheap_tpu.ops import losses as j_losses
from paper_accurate_fast_cheap_tpu.train import schedulers as j_sched
from paper_accurate_fast_cheap_tpu.train import train_step as j_ts
from paper_accurate_fast_cheap_tpu.utils import common as j_common
from paper_accurate_fast_cheap_tpu_torch.convert import state_dict_from_jax
from paper_accurate_fast_cheap_tpu_torch.models import attention as t_att
from paper_accurate_fast_cheap_tpu_torch.models import decoder as t_dec
from paper_accurate_fast_cheap_tpu_torch.models import embedding as t_emb
from paper_accurate_fast_cheap_tpu_torch.models import factory as t_factory
from paper_accurate_fast_cheap_tpu_torch.ops import common as t_common
from paper_accurate_fast_cheap_tpu_torch.ops import losses as t_losses
from paper_accurate_fast_cheap_tpu_torch.train import schedulers as t_sched
from paper_accurate_fast_cheap_tpu_torch.train import train_step as t_ts
from test_torch_train import _flax_params_from_port

V, D, HEADS = 12, 64, 4
DEC = dict(attention_heads=HEADS, linear_units=64, num_blocks=1,
           r_num_blocks=1)


def _port_weights(module, params):
    """Load a flax module's parameters into the port's module."""
    module.load_state_dict(state_dict_from_jax(
        jax.tree.map(np.asarray, params)))
    return module.eval()


def _t(a):
    return torch.from_numpy(np.array(a))


def _memory(rng, B=3, T=9):
    mem = rng.randn(B, T, D).astype(np.float32)
    return mem, np.asarray([9, 6, 4], np.int32)


def _labels(rng, B=3, U=5):
    ys = rng.randint(1, V - 1, (B, U)).astype(np.int32)
    return ys, np.asarray([5, 3, 1], np.int32)


def test_mha_fully_masked_rows_give_zeros():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 4, D).astype(np.float32)
    kv = rng.randn(2, 6, D).astype(np.float32)
    mask = rng.rand(2, 4, 6) > 0.4
    mask[0, 1] = False             # a fully masked query row
    mask[1, :] = False             # a fully masked utterance
    jm = j_att.MultiHeadedAttention(heads=HEADS, d_model=D)
    params = jm.init(jax.random.PRNGKey(0), x, kv, mask)
    tm = _port_weights(t_att.MultiHeadedAttention(HEADS, D), params)
    for m in (mask, mask[:, :1]):              # (B, Tq, Tk) and (B, 1, Tk)
        want = np.asarray(jm.apply(params, x, kv, jnp.asarray(m)))
        got = tm(_t(x), _t(kv), _t(m)).detach().numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # a fully masked row attends to nothing: only linear_out's bias is left
    got = tm(_t(x), _t(kv), _t(mask)).detach()
    np.testing.assert_allclose(got[1].numpy(), np.broadcast_to(
        tm.linear_out.bias.detach().numpy(), (4, D)), atol=1e-6)


def test_positional_encoding():
    x = np.random.RandomState(1).randn(2, 7, D).astype(np.float32)
    want_y, want_pos = j_emb.PositionalEncoding(d_model=D).apply({}, x)
    got_y, got_pos = t_emb.PositionalEncoding(D).eval()(_t(x))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got_pos.numpy(), np.asarray(want_pos),
                               atol=1e-6)


def test_transformer_decoder_and_one_step():
    rng = np.random.RandomState(2)
    mem, mlens = _memory(rng)
    ys, ylens = _labels(rng)
    jm = j_dec.TransformerDecoder(vocab_size=V, encoder_output_size=D,
                                  attention_heads=HEADS, linear_units=64,
                                  num_blocks=2)
    params = jm.init(jax.random.PRNGKey(1), mem, mlens, ys, ylens)
    tm = _port_weights(t_dec.TransformerDecoder(
        V, D, attention_heads=HEADS, linear_units=64, num_blocks=2), params)
    want = np.asarray(jm.apply(params, mem, mlens, ys, ylens))
    got = tm(_t(mem), _t(mlens), _t(ys), _t(ylens)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    want = np.asarray(jm.apply(params, mem, mlens, ys, ylens,
                               method=jm.forward_one_step))
    got = tm.forward_one_step(_t(mem), _t(mlens), _t(ys),
                              _t(ylens)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("reverse_weight", [0.3, 0.0])
def test_bitransformer_decoder(reverse_weight):
    rng = np.random.RandomState(3)
    mem, mlens = _memory(rng)
    ys, ylens = _labels(rng)
    r_ys = np.asarray(j_common.reverse_pad_list(jnp.asarray(ys),
                                                jnp.asarray(ylens), 0))
    jm = j_dec.BiTransformerDecoder(vocab_size=V, encoder_output_size=D,
                                    **DEC)
    params = jm.init(jax.random.PRNGKey(2), mem, mlens, ys, ylens, r_ys,
                     reverse_weight)
    tm = _port_weights(t_dec.BiTransformerDecoder(
        V, D, **DEC, with_right=reverse_weight > 0), params)
    want = jm.apply(params, mem, mlens, ys, ylens, r_ys, reverse_weight)
    got = tm(_t(mem), _t(mlens), _t(ys), _t(ylens), _t(r_ys),
             reverse_weight)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-5)
    if reverse_weight == 0.0:
        assert not got[1].any()
    want = np.asarray(jm.apply(params, mem, mlens, ys, ylens,
                               method=jm.forward_one_step))
    got = tm.forward_one_step(_t(mem), _t(mlens), _t(ys), _t(ylens))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)


def test_bridge_refuses_unknown_leaves():
    """A flax leaf the port has no module for raises instead of being
    copied.  Every leaf of the JAX package converts since the other model
    families were ported (the wav2vec2 model's ``mask_emb``, LoRA's
    ``lora_A`` and Mamba-2's ``A_log``, the earlier examples, now do), so
    the leaf here is one no flax module of the package creates."""
    tree = {"norm": {"gamma": np.zeros((D,), np.float32)}}
    with pytest.raises(KeyError, match="norm.gamma"):
        state_dict_from_jax(tree)
    assert "mask_emb" in state_dict_from_jax(
        {"mask_emb": np.zeros((D,), np.float32)})


@pytest.mark.parametrize("normalize_length", [False, True])
def test_label_smoothing_loss(normalize_length):
    rng = np.random.RandomState(4)
    logits = (rng.randn(3, 6, V) * 3).astype(np.float32)
    tgt = rng.randint(0, V, (3, 6)).astype(np.int32)
    tgt[0, 4:] = -1
    tgt[2, 1:] = -1
    want = j_losses.label_smoothing_loss(jnp.asarray(logits),
                                         jnp.asarray(tgt), 0.1,
                                         normalize_length=normalize_length)
    got = t_losses.label_smoothing_loss(_t(logits), _t(tgt), 0.1,
                                        normalize_length=normalize_length)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_sos_eos_reverse_and_accuracy():
    rng = np.random.RandomState(5)
    ys, ylens = _labels(rng, B=4, U=6)
    ylens = np.asarray([6, 3, 0, 1], np.int32)
    for want, got in zip(
            j_common.add_sos_eos(jnp.asarray(ys), jnp.asarray(ylens), 10,
                                 11),
            t_common.add_sos_eos(_t(ys), _t(ylens), 10, 11)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for pad in (0, -1):
        np.testing.assert_array_equal(
            t_common.reverse_pad_list(_t(ys), _t(ylens), pad).numpy(),
            np.asarray(j_common.reverse_pad_list(jnp.asarray(ys),
                                                 jnp.asarray(ylens), pad)))
    logits = rng.randn(4, 6, V).astype(np.float32)
    tgt = np.where(rng.rand(4, 6) > 0.3, logits.argmax(-1), -1)
    np.testing.assert_allclose(
        float(t_common.accuracy(_t(logits), _t(tgt))),
        float(j_common.accuracy(jnp.asarray(logits), jnp.asarray(tgt))),
        rtol=1e-6)


# ---- the decoder-bearing models: losses, gradients, optimizer steps ----

ENCODER = dict(output_size=D, attention_heads=HEADS, linear_units=64,
               num_blocks=1, cnn_module_kernel=15,
               selfattention_layer_type="rwkv_tmix60_bidirectional",
               rwkv_do_bfloat16=False)
# the paper's configuration (examples/gigaspeech/conf/
# rwkvbi_ds4k31nc_12le_trans_shortform.yaml) at tiny widths
PAPER_TINY = {
    "model": "transducer", "encoder": "conformer", "encoder_conf": ENCODER,
    "decoder": "bitransformer", "decoder_conf": DEC,
    "predictor": "rnn",
    "predictor_conf": {"embed_size": 32, "output_size": 32,
                       "hidden_size": 32, "num_layers": 2},
    "joint_conf": {"join_dim": 32},
    "tokenizer_conf": {"special_tokens": {"<sos>": 2, "<eos>": 2}},
    "model_conf": {"transducer_weight": 0.3, "ctc_weight": 0.2,
                   "attention_weight": 0.5, "lsm_weight": 0.1,
                   "reverse_weight": 0.3, "length_normalized_loss": False},
}
ASR_TINY = {
    "model": "asr_model", "encoder": "conformer", "encoder_conf": ENCODER,
    "decoder": "transformer", "decoder_conf": DEC,
    "model_conf": {"ctc_weight": 0.3, "lsm_weight": 0.1,
                   "length_normalized_loss": True},
}


def _batch():
    rng = np.random.RandomState(6)
    return (rng.randn(2, 100, 80).astype(np.float32),
            np.asarray([100, 84], np.int32),
            rng.randint(1, V, (2, 5)).astype(np.int32),
            np.asarray([5, 3], np.int32))


@pytest.fixture(scope="module", params=["transducer", "asr_model"])
def models(request):
    config = PAPER_TINY if request.param == "transducer" else ASR_TINY
    tmodel, _ = t_factory.init_model(
        config, V, 80, device="cpu",
        generator=torch.Generator().manual_seed(7))
    jmodel, _ = j_factory.init_model(config, V, 80)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 80)), jnp.asarray([64]),
                            jnp.ones((1, 4), jnp.int32), jnp.asarray([4]))
    params = _flax_params_from_port(shapes, tmodel.state_dict())
    batch = tuple(map(jnp.asarray, _batch()))

    def loss(p):
        out = jmodel.apply(p, *batch)
        return out["loss"], out

    grad_fn = jax.jit(jax.value_and_grad(loss, has_aux=True))
    return config, tmodel, params, grad_fn


def test_decoder_models_losses_and_gradients(models):
    config, tmodel, params, grad_fn = models
    batch = _batch()
    (_, j_out), j_grads = grad_fn(params)
    tmodel.eval().zero_grad()
    out = tmodel(*map(torch.from_numpy, batch))
    out["loss"].backward()
    assert set(out) == set(j_out)
    assert float(j_out["loss_att"]) > 0
    for k in out:
        np.testing.assert_allclose(float(out[k].detach()), float(j_out[k]),
                                   rtol=1e-5, atol=1e-7)
    want = state_dict_from_jax(jax.tree.map(np.asarray, j_grads))
    assert any(n.startswith("decoder.right_decoder") for n in want) == (
        config["decoder"] == "bitransformer")
    _check_grads(tmodel, want)


def _check_grads(tmodel, want):
    """Every gradient of the port's model within 1e-4 of JAX's, relative to
    the tensor's largest entry floored at 1e-4 of the model's largest
    gradient: a key bias adds one constant to each softmax row, so its
    gradient is zero up to rounding (~1e-9)."""
    grads = dict(tmodel.named_parameters())
    assert set(grads) == set(want)
    top = max(float(np.abs(w.numpy()).max()) for w in want.values())
    for name, p in grads.items():
        w = want[name].numpy()
        err = np.abs(p.grad.numpy() - w).max() / max(np.abs(w).max(),
                                                      1e-4 * top)
        assert err < 1e-4, (name, err)


def test_paper_optimizer_steps_match_optax(models):
    """Two steps of the paper's optimizer (Adam, global-norm clip 0.1;
    steadylr at its full rate 1e-3 from the first step, so that the updates
    show) from the same weights: at each step the port's loss and gradients at the JAX model's
    current weights against ``jax.grad``, then the port's optimizer and
    optax's chain (``make_optimizer`` of the JAX package) fed the same
    gradients, parameters within 1e-4 of each tensor's largest update (optax
    takes Adam's bias corrections 1 - b^count in f32, where 1 - 0.999^2
    loses four digits to cancellation, the port in f64: ~1e-5 of an update)
    plus 1e-6 relative (the rounding of the parameters themselves).  (Fed each
    its own gradients, Adam's normalisation turns rounding noise in the
    near-zero gradient entries into updates of either sign, which the next
    step then amplifies.)"""
    config, tmodel, params, grad_fn = models
    batch = tuple(map(torch.from_numpy, _batch()))
    lr = 1e-3
    j_opt = j_ts.make_optimizer("adam", j_sched.steady_lr(lr, 1),
                                grad_clip=0.1)
    t_opt = t_ts.make_optimizer("adam", t_sched.steady_lr(lr, 1),
                                grad_clip=0.1)
    p0 = state_dict_from_jax(jax.tree.map(np.asarray, params))
    t_params = dict(p0)
    t_state = t_opt.init(t_params)

    @jax.jit
    def j_update(grads, state, p):
        updates, state = j_opt.update(grads, state, p)
        return optax.apply_updates(p, updates), state

    j_params, j_state = params, jax.jit(j_opt.init)(params)
    for i in range(2):
        (j_l, _), j_grads = grad_fn(j_params)
        grads = state_dict_from_jax(jax.tree.map(np.asarray, j_grads))
        tmodel.load_state_dict(
            state_dict_from_jax(jax.tree.map(np.asarray, j_params)))
        tmodel.eval().zero_grad()
        t_l = tmodel(*batch)["loss"]
        t_l.backward()
        np.testing.assert_allclose(float(t_l.detach()), float(j_l),
                                   rtol=1e-5)
        _check_grads(tmodel, grads)
        j_params, j_state = j_update(j_grads, j_state, j_params)
        t_upd, t_state = t_opt.update(grads, t_state, t_params)
        t_params = t_ts.apply_updates(t_params, t_upd)
    assert t_state["count"] == 2
    want = state_dict_from_jax(jax.tree.map(np.asarray, j_params))
    for name, p in t_params.items():
        moved = float((want[name] - p0[name]).abs().max())
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=1e-6,
                                   atol=1e-4 * moved)
