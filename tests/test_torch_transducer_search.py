"""The port's transducer searches against the JAX package's, on the same
encoder output: the host-loop beam oracle (and the port's device beam
against it), the device beam's ``sort`` merge, the beam with its packed
top-hypothesis alignment (``align_pack``), and the greedy search with 1
and 3 symbols a frame.

A tiny transducer of the flagship family (predictor 1 x 32, joint 32,
V = 1100, blank bias +2.5) is initialised in JAX; its weights reach the
port through ``convert.state_dict_from_jax``.  Both sides read the same
seeded encoder output (B = 3, T = 24, lengths 24, 20 and 13) and CTC
log-probs in f32; the port runs its plain versions on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paper_accurate_fast_cheap_tpu.decode import rnnt_search as j_search
from paper_accurate_fast_cheap_tpu.models import factory as j_factory
from paper_accurate_fast_cheap_tpu_torch.convert import state_dict_from_jax
from paper_accurate_fast_cheap_tpu_torch.decode import rnnt_search as t_search
from paper_accurate_fast_cheap_tpu_torch.models import factory as t_factory

VOCAB = 1100
BEAM = 4
CONFIG = {
    "model": "transducer",
    "encoder": "conformer",
    "encoder_conf": dict(
        output_size=32, attention_heads=2, linear_units=64, num_blocks=1,
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
def setup():
    model, _ = j_factory.init_model(CONFIG, VOCAB, 80)
    # jitted: one compile costs less on the CPU than the eager op stream
    params = jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 80)), jnp.asarray([64]),
        jnp.ones((1, 4), jnp.int32), jnp.asarray([4]))
    p = params["params"]
    p["joint"]["ffn_out"]["kernel"] = p["joint"]["ffn_out"]["kernel"] * 3.0
    p["joint"]["ffn_out"]["bias"] = p["joint"]["ffn_out"]["bias"].at[0].add(
        2.5)
    rng = np.random.RandomState(5)
    B, T = 3, 24
    enc = (rng.randn(B, T, 32) * 2).astype(np.float32)
    z = (rng.randn(B, T, VOCAB) * 2).astype(np.float32)
    z[..., 0] += 3.0
    ctc = (z - np.log(np.exp(z).sum(-1, keepdims=True))).astype(np.float32)
    lens = np.asarray([24, 20, 13], np.int32)
    tmodel, _ = t_factory.init_model(CONFIG, VOCAB, 80, device="cpu")
    tmodel.load_state_dict(state_dict_from_jax(
        jax.tree.map(np.asarray, params)))
    tmodel.eval()
    return dict(model=model, params=params, tmodel=tmodel, enc=enc, ctc=ctc,
                lens=lens,
                j_fns=j_search.make_transducer_step_fns(model, params),
                t_fns=t_search.make_transducer_step_fns(tmodel))


def _j_beam(s, **kw):
    return j_search.rnnt_beam_search(
        *s["j_fns"], jnp.asarray(s["enc"]), jnp.asarray(s["lens"]),
        jnp.asarray(s["ctc"]), beam_size=BEAM, params=s["params"], **kw)


def _t_beam(s, **kw):
    return t_search.rnnt_beam_search(
        *s["t_fns"], torch.from_numpy(s["enc"]), torch.from_numpy(s["lens"]),
        torch.from_numpy(s["ctc"]), beam_size=BEAM, **kw)


def _same(j_res, t_res):
    assert len(j_res) == len(t_res)
    assert sum(len(r.tokens) for r in j_res) > 10
    for a, b in zip(j_res, t_res):
        assert a.tokens == b.tokens
        assert a.nbest == b.nbest
        np.testing.assert_allclose(b.nbest_scores, a.nbest_scores,
                                   rtol=1e-5, atol=1e-4)


def test_host_beam_matches_jax_and_device_beam(setup):
    j_res = _j_beam(setup, impl="host")
    t_res = _t_beam(setup, impl="host")
    _same(j_res, t_res)
    # the port's device beam gives the oracle's tokens, in n-best order
    for route in ("pallas_joint", "xla"):
        dev = _t_beam(setup, topk_impl=route)
        for a, b in zip(t_res, dev):
            assert a.tokens == b.tokens
            assert a.nbest == b.nbest


def test_sort_merge_matches_jax(setup):
    j_res = _j_beam(setup, merge="sort")
    for route in ("pallas_joint", "pallas", "xla"):
        _same(j_res, _t_beam(setup, merge="sort", topk_impl=route))
    # the two merges agree here (no exact score ties between prefixes)
    _same(j_res, _t_beam(setup, merge="pairwise"))


@pytest.mark.parametrize("lmax", [4, 64])
def test_packed_alignment_matches_jax(setup, lmax):
    j_buf = _j_beam(setup, defer=True, align_pack=lmax)
    t_buf = _t_beam(setup, defer=True, align_pack=lmax)
    assert t_buf.dtype == torch.int32 and t_buf.shape == j_buf.shape
    j_out = j_search.finalize_device_beam_aligned(j_buf, beam=BEAM)
    t_out = t_search.finalize_device_beam_aligned(t_buf, beam=BEAM)
    _same(j_out[0], t_out[0])
    for a, b in zip(j_out[1:], t_out[1:]):
        np.testing.assert_array_equal(b, np.asarray(a))
    ok = t_out[2]
    # Lmax 4 is shorter than some top hypotheses: those rows are not ok
    assert ok.all() if lmax == 64 else not ok.all()
    # the non-deferred form returns the beam's results
    _same(j_out[0], _t_beam(setup, align_pack=lmax))


@pytest.mark.parametrize("n_steps", [1, 3])
def test_greedy_matches_jax(setup, n_steps):
    s = setup
    B = len(s["lens"])
    j_pred, j_joint, j_init = s["j_fns"]
    j_res = j_search.basic_greedy_search(
        j_pred, j_joint, j_init(B), jnp.asarray(s["enc"]),
        jnp.asarray(s["lens"]), n_steps=n_steps, params=s["params"])
    t_pred, t_joint, t_init = s["t_fns"]
    t_res = t_search.basic_greedy_search(
        t_pred, t_joint, t_init(B), torch.from_numpy(s["enc"]),
        torch.from_numpy(s["lens"]), n_steps=n_steps)
    assert sum(len(r.tokens) for r in j_res) > 10
    assert [r.tokens for r in t_res] == [r.tokens for r in j_res]
