"""Keyword biasing in the port's CTC prefix beam against the JAX package.

Both sides are host numpy, so scores and tokens must be identical: the
context graph's steps and finals over random phrases (shared prefixes,
fail links, phrases inside phrases), and ``ctc_prefix_beam_search`` with a
``ContextGraph`` on random posteriors (n-best, scores, times), plus the
unbiased search unchanged by the new fields.
"""
import numpy as np
import pytest

from paper_accurate_fast_cheap_tpu.decode import context_graph as j_cg
from paper_accurate_fast_cheap_tpu.decode import search as j_search
from paper_accurate_fast_cheap_tpu_torch.decode import context_graph as t_cg
from paper_accurate_fast_cheap_tpu_torch.decode import search as t_search

PHRASES = [[3, 4, 5], [4, 6], [4], [7, 3, 4, 5, 2], [2, 2]]


def test_context_graph_walks_match_jax():
    rng = np.random.RandomState(0)
    jg = j_cg.ContextGraph(PHRASES, context_score=1.5)
    tg = t_cg.ContextGraph(PHRASES, context_score=1.5)
    for _ in range(20):
        js, ts = jg.root, tg.root
        for tok in rng.randint(1, 9, 12):
            jd, js = jg.forward_one_step(js, int(tok))
            td, ts = tg.forward_one_step(ts, int(tok))
            assert td == jd
            assert (ts.token, ts.total_score, ts.is_end) == (
                js.token, js.total_score, js.is_end)
            assert (ts is tg.root) == (js is jg.root)
        assert tg.finalize(ts) == jg.finalize(js)
    # a completed phrase with no continuation returns to the root, boost
    # kept; a dying partial match gives its boost back
    d1, st = tg.forward_one_step(tg.root, 4)
    d2, st = tg.forward_one_step(st, 6)
    assert st is tg.root and d1 + d2 == 3.0
    d1, st = tg.forward_one_step(tg.root, 3)
    d2, st = tg.forward_one_step(st, 9)
    assert d1 + d2 == 0.0


def _posteriors(rng, B=3, T=14, V=10):
    logits = rng.randn(B, T, V) * 2.0
    logits[..., 0] += 1.0
    logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    return logp.astype(np.float32), np.asarray([T, T - 3, T - 6])


@pytest.mark.parametrize("score", [0.0, 1.0, 3.0])
def test_biased_prefix_beam_matches_jax(score):
    rng = np.random.RandomState(1)
    logp, lens = _posteriors(rng)
    kw = dict(beam_size=5)
    if score:
        kw_j = dict(kw, context_graph=j_cg.ContextGraph(PHRASES, score))
        kw_t = dict(kw, context_graph=t_cg.ContextGraph(PHRASES, score))
    else:
        kw_j = kw_t = kw
    want = j_search.ctc_prefix_beam_search(logp, lens, **kw_j)
    got = t_search.ctc_prefix_beam_search(logp, lens, **kw_t)
    for g, w in zip(got, want):
        assert g.nbest == w.nbest
        assert g.nbest_scores == w.nbest_scores
        assert g.nbest_times == w.nbest_times
        assert (g.tokens, g.score, g.times) == (w.tokens, w.score, w.times)


def test_biasing_changes_the_ranking():
    """Posteriors slightly prefer token 2; the phrase [1] is boosted."""
    T, V = 4, 5
    logp = np.log(np.full((1, T, V), 0.02))
    logp[0, :, 0] = np.log(0.55)
    logp[0, 1, 0] = np.log(0.05)
    logp[0, 1, 2] = np.log(0.50)
    logp[0, 1, 1] = np.log(0.35)
    lens = np.asarray([T])
    assert t_search.ctc_prefix_beam_search(logp, lens, 4)[0].tokens == [2]
    biased = t_search.ctc_prefix_beam_search(
        logp, lens, 4, context_graph=t_cg.ContextGraph([[1]], 3.0))
    assert biased[0].tokens == [1]
