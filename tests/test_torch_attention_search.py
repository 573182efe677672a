"""The port's attention-decoder beam search against the JAX package.

One tiny ``ASRModel`` (2 decoder blocks, width 32, 2 heads, vocabulary 20)
is initialised in JAX, its <eos> logit raised so that hypotheses end
inside the search, and loaded into the port through
``convert.state_dict_from_jax``.  The same random encoder output (B 2,
one utterance padded) goes through JAX's ``attention_beam_search`` and the
port's at beam 4: plain, with a length penalty, with GNMT's length
normalisation and with GNMT's length + coverage scorer (the coverage from
the last decoder block's cross-attention: the port takes it from the
decoder's own forward, JAX from its sown intermediates).  Tokens must be
identical and scores within 1e-4; the coverage rows within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paper_accurate_fast_cheap_tpu.decode import search as j_search
from paper_accurate_fast_cheap_tpu.models.asr_model import ASRModel as JASR
from paper_accurate_fast_cheap_tpu_torch.convert import state_dict_from_jax
from paper_accurate_fast_cheap_tpu_torch.decode import search as t_search
from paper_accurate_fast_cheap_tpu_torch.models.asr_model import (
    ASRModel as TASR)

V, D = 20, 32
ENC = dict(input_size=8, output_size=D, attention_heads=2, linear_units=32,
           num_blocks=1)
DEC = dict(attention_heads=2, linear_units=32, num_blocks=2)
SOS = EOS = V - 1
B, T, BEAM, MAX_LEN = 2, 12, 4, 6


@pytest.fixture(scope="module")
def models():
    jm = JASR(vocab_size=V, encoder_conf=ENC, decoder_conf=DEC,
              ctc_weight=0.5)
    params = jax.jit(jm.init)(jax.random.PRNGKey(3), jnp.zeros((1, 40, 8)),
                              jnp.asarray([40]), jnp.ones((1, 3), jnp.int32),
                              jnp.asarray([3]))
    params = jax.tree.map(np.array, params)
    dec = params["params"]["decoder"]["left_decoder"]
    dec["output_layer"]["kernel"] *= 3.0
    dec["output_layer"]["bias"][EOS] += 2.5
    tm = TASR(V, dict(ENC), dict(DEC), ctc_weight=0.5)
    tm.load_state_dict(state_dict_from_jax(params))
    params = jax.tree.map(jnp.asarray, params)

    # one function object each, so that JAX's search compiles each prefix
    # length once for every case
    def j_step(e, el, ys, yl):
        return jm.apply(params, e, el, ys, yl,
                        method=jm.decoder_one_step_attn)

    rng = np.random.RandomState(5)
    enc = rng.randn(B, T, D).astype(np.float32)
    lens = np.asarray([T, T - 5], np.int32)
    return dict(jm=jm, params=params, tm=tm.eval(), enc=enc, lens=lens,
                j_step=j_step,
                j_gnmt=j_search.make_gnmt_step_fn(jm, params))


CASES = {
    "plain": {},
    "length_penalty": dict(length_penalty=0.6),
    "gnmt_alpha": dict(gnmt_alpha=0.9),
    "gnmt_alpha_beta_coverage": dict(gnmt_alpha=0.9, gnmt_beta=0.4),
}


@pytest.mark.parametrize("case", list(CASES))
def test_attention_beam_matches_jax(models, case):
    tm, enc, lens = models["tm"], models["enc"], models["lens"]
    kw = dict(sos=SOS, eos=EOS, beam_size=BEAM, max_len=MAX_LEN,
              **CASES[case])
    j_kw, t_kw = dict(kw), dict(kw)
    if "gnmt_beta" in kw:
        j_kw["decoder_one_step_attn"] = models["j_gnmt"]
        t_kw["decoder_one_step_attn"] = t_search.make_gnmt_step_fn(tm)
    want = j_search.attention_beam_search(models["j_step"], jnp.asarray(enc),
                                          jnp.asarray(lens), **j_kw)
    got = t_search.attention_beam_search(
        tm.decoder_one_step, torch.from_numpy(enc), torch.from_numpy(lens),
        **t_kw)
    for g, w in zip(got, want):
        assert g.tokens == w.tokens
        np.testing.assert_allclose(g.score, w.score, rtol=1e-4, atol=1e-4)
    if case == "plain":
        # a hypothesis ended with <eos> before max_len and won
        assert any(len(w.tokens) < MAX_LEN for w in want)


def test_coverage_step_matches_jax(models):
    """The GNMT step's (log-probs, coverage) against JAX's, and the
    coverage is the decoder's masked cross-attention: rows sum to 1 over
    the valid frames, 0 on the padding."""
    tm = models["tm"]
    # the beam's shapes at its third step, so that JAX reuses its compile
    enc = np.repeat(models["enc"], BEAM, axis=0)
    lens = np.repeat(models["lens"], BEAM)
    ys = np.random.RandomState(6).randint(0, V, (B * BEAM, 3)).astype(
        np.int32)
    ys[:, 0] = SOS
    yl = np.full((B * BEAM,), 3, np.int32)
    j_lp, j_cov = jax.jit(models["j_gnmt"])(
        jnp.asarray(enc), jnp.asarray(lens), jnp.asarray(ys),
        jnp.asarray(yl))
    with torch.no_grad():
        t_lp, t_cov = tm.decoder_one_step_attn(
            torch.from_numpy(enc), torch.from_numpy(lens),
            torch.from_numpy(ys), torch.from_numpy(yl))
    np.testing.assert_allclose(t_lp.numpy(), np.asarray(j_lp), atol=1e-5)
    np.testing.assert_allclose(t_cov.numpy(), np.asarray(j_cov), atol=1e-5)
    np.testing.assert_allclose(t_cov.sum(-1).numpy(), 1.0, rtol=1e-5)
    assert float(t_cov[-1, lens[-1]:].abs().max()) == 0.0
    # the plain step is the same forward without the probabilities
    with torch.no_grad():
        plain = tm.decoder_one_step(torch.from_numpy(enc),
                                    torch.from_numpy(lens),
                                    torch.from_numpy(ys),
                                    torch.from_numpy(yl))
    assert torch.equal(plain, t_lp)


def test_gnmt_penalties():
    cov = np.asarray([0.2, 1.4, 0.7, 1.0])
    assert t_search.gnmt_coverage_wu(cov, 0.4) == j_search.gnmt_coverage_wu(
        cov, 0.4)
    for n in (1, 7, 30):
        assert t_search.gnmt_length_wu(n, 0.9) == j_search.gnmt_length_wu(
            n, 0.9)
