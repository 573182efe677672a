"""The port's CTC alignment and CTC searches against the JAX package.

The batched device Viterbi (``force_align_batch_device`` and the
device-label ``force_align_device_tokens``) must give the JAX package's
frame paths exactly, and the host CTC searches its tokens, times and
scores, on the same log-probs (f32, made with numpy).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paper_accurate_fast_cheap_tpu.decode import search as j_search
from paper_accurate_fast_cheap_tpu.ops import ctc_utils as j_ctc
from paper_accurate_fast_cheap_tpu_torch.decode import search as t_search
from paper_accurate_fast_cheap_tpu_torch.ops import ctc_utils as t_ctc


def _logp(rng, B, T, V, blank_bias=0.0):
    z = rng.randn(B, T, V).astype(np.float32) * 2
    z[..., 0] += blank_bias
    return z - np.log(np.exp(z).sum(-1, keepdims=True))


LABELS = [
    [2, 3, 3, 1],                  # repeat -> no skip transition there
    [4, 2],
    [5, 1, 6, 2, 2, 3, 4, 1, 6],   # long: overflows the device-token budget
    [],                            # empty
]


def test_force_align_batch_device_matches_jax():
    rng = np.random.RandomState(3)
    B, T, V = 4, 23, 7
    logp = _logp(rng, B, T, V)
    lens = np.asarray([23, 15, 23, 9], np.int32)
    want = j_ctc.force_align_batch_device(jnp.asarray(logp), lens, LABELS,
                                          s_bucket=8)
    got = t_ctc.force_align_batch_device(torch.from_numpy(logp), lens,
                                         LABELS, s_bucket=8)
    assert got == want
    # the host helpers on top of it
    for g in got:
        assert (t_ctc.alignment_to_token_spans(g)
                == j_ctc.alignment_to_token_spans(g))
    peaks = [s[1] for s in t_ctc.alignment_to_token_spans(got[2])]
    assert (t_ctc.gen_timestamps_from_peak(peaks, np.int32(23) * 4 * 0.01)
            == j_ctc.gen_timestamps_from_peak(peaks,
                                              np.int32(23) * 4 * 0.01))


def test_force_align_device_tokens_matches_jax():
    rng = np.random.RandomState(4)
    B, T, V, Lmax = 4, 17, 7, 5
    logp = _logp(rng, B, T, V)
    lens = np.asarray([17, 11, 17, 9], np.int32)
    tokens = np.zeros((B, Lmax), np.int32)
    tok_len = np.zeros((B,), np.int32)
    for b, ls in enumerate(LABELS):
        tok_len[b] = len(ls)
        tokens[b, : min(len(ls), Lmax)] = ls[:Lmax]
    jp, jok = jax.jit(j_ctc.force_align_device_tokens)(
        jnp.asarray(logp), jnp.asarray(lens), jnp.asarray(tokens),
        jnp.asarray(tok_len))
    tp, tok = t_ctc.force_align_device_tokens(
        torch.from_numpy(logp), lens, torch.from_numpy(tokens),
        torch.from_numpy(tok_len))
    assert tok.tolist() == np.asarray(jok).tolist() == [True, True, False,
                                                        False]
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


@pytest.mark.parametrize("mode", ["greedy", "prefix_beam"])
def test_ctc_searches_match_jax(mode):
    rng = np.random.RandomState(5)
    logp = _logp(rng, 3, 30, 9, blank_bias=1.0)
    lens = np.asarray([30, 21, 5], np.int32)
    if mode == "greedy":
        want = j_search.ctc_greedy_search(logp, lens)
        got = t_search.ctc_greedy_search(torch.from_numpy(logp), lens)
    else:
        want = j_search.ctc_prefix_beam_search(logp, lens, beam_size=4)
        got = t_search.ctc_prefix_beam_search(torch.from_numpy(logp), lens,
                                              beam_size=4)
    assert any(r.tokens for r in want)
    for a, b in zip(want, got):
        assert (a.tokens, a.times, a.nbest, a.nbest_times) == (
            b.tokens, b.times, b.nbest, b.nbest_times)
        np.testing.assert_allclose(b.nbest_scores, a.nbest_scores, rtol=1e-6)
        np.testing.assert_allclose(b.score, a.score, rtol=1e-6)
    assert (t_search.remove_duplicates_and_blank([0, 3, 3, 0, 3, 2, 2])
            == j_search.remove_duplicates_and_blank([0, 3, 3, 0, 3, 2, 2]))
