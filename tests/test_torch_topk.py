"""The port's exact selections (the plain versions of K2, K4 and K5)
against the JAX package.

``top_k_vocab`` (K5's wrapper, on CPU tensors its plain version) and
``stable_top_k`` must pick the same indices as the JAX versions, ties
included (indices exact, values exact), and so must K5's plain version
against the JAX Pallas kernel ``top_k_vocab_pallas`` in interpret mode.
K4's plain version (``fused_top_k_vocab`` on CPU tensors) is held to
``fused_top_k_vocab_pallas`` in interpret mode: indices exact, values
within 1e-6 (the same f32 logaddexp).  The fused joint head's plain version
(the K2 wrapper on CPU tensors) is held to the JAX Pallas kernel in
interpret mode: indices exact, values 1e-5 (the product and the logsumexp
are summed in another order).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paper_accurate_fast_cheap_tpu.decode.rnnt_search import (
    top_k_vocab as j_top_k_vocab)
from paper_accurate_fast_cheap_tpu.ops.topk_pallas import (
    fused_top_k_vocab_pallas, joint_top_k_vocab_pallas, top_k_vocab_pallas)
from paper_accurate_fast_cheap_tpu_torch.ops import topk as t_topk
from paper_accurate_fast_cheap_tpu_torch.ops.fused_topk import (
    fused_top_k_vocab)
from paper_accurate_fast_cheap_tpu_torch.ops.joint_topk import (
    joint_top_k_vocab, joint_top_k_vocab_plain)


def _check(x, k):
    vj, ij = j_top_k_vocab(jnp.asarray(x), k)
    vt, it = t_topk.top_k_vocab(torch.from_numpy(x), k)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


@pytest.mark.parametrize("shape,k", [
    ((4, 8, 5002), 8),       # the product point (V = vocab, beam 8)
    ((2, 3, 2000), 4),       # non-pow2 V
    ((16, 1537), 8),         # 2-D input, V % 128 != 0
    ((3, 5, 600), 8),        # V <= 8 * 128: the direct path
    ((4, 8, 5002), 40),      # beam 40: k >= the chunk count, direct
    ((4, 8, 5002), 128),
])
def test_top_k_vocab_random(shape, k):
    x = (np.random.RandomState(0).randn(*shape) * 5).astype(np.float32)
    _check(x, k)


def test_top_k_vocab_adversarial_ties():
    # many exact duplicates across chunk boundaries (the JAX kernel test's
    # pattern): the tie-break rules must agree
    rng = np.random.default_rng(0)
    x = rng.integers(-6, 6, size=(8, 8, 2048)).astype(np.float32)
    _check(x, 8)


def test_top_k_vocab_neg_inf_rows_and_lanes():
    x = np.random.default_rng(1).normal(size=(4, 4, 1664)).astype(np.float32)
    x[0, 1] = -np.inf                      # dead beam row
    x[2, :, 700:] = -np.inf                # masked vocab tail
    _check(x, 6)


def test_stable_top_k_matches_lax_top_k():
    rng = np.random.default_rng(2)
    x = rng.integers(-3, 3, size=(5, 64)).astype(np.float32)
    x[0, :40] = -np.inf                    # more -inf than k: index order
    x[1] = -np.inf
    vj, ij = jax.lax.top_k(jnp.asarray(x), 8)
    vt, it = t_topk.stable_top_k(torch.from_numpy(x), 8)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


@pytest.mark.parametrize("B,N,V,D,tw,cw", [
    (2, 8, 2048, 128, 0.7, 0.3),
    (3, 4, 1203, 256, 0.7, 0.3),    # V % 128 != 0 -> -inf pad columns
    (2, 4, 1280, 128, 1.0, 0.0),    # ctc_weight 0 -> log_cw = -inf
])
def test_joint_top_k_matches_jax_pallas(B, N, V, D, tw, cw):
    rng = np.random.RandomState(10)
    x = (rng.randn(B * N, D) * 0.5).astype(np.float32)
    w = (rng.randn(D, V) * 0.2).astype(np.float32)       # flax (in, out)
    b = (rng.randn(V) * 0.1).astype(np.float32)
    logits = rng.randn(B, V).astype(np.float32)
    ctc = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    ltw = math.log(tw) if tw > 0 else -math.inf
    lcw = math.log(cw) if cw > 0 else -math.inf
    vj, ij = joint_top_k_vocab_pallas(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(b), jnp.asarray(ctc), N,
                                      ltw, lcw)
    tx, tw_, tb, tc = (torch.from_numpy(a) for a in (x, w.T.copy(), b, ctc))
    vt, it = joint_top_k_vocab(tx, tw_, tb, tc, N, ltw, lcw)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-5,
                               atol=1e-5)
    # a lane-padded, strided ctc (as the beam passes it) gives the same
    Vp = -(-V // 128) * 128
    pad = np.full((B, 2, Vp), -np.inf, np.float32)
    pad[:, 1, :V] = ctc
    vp, ip = joint_top_k_vocab(tx, tw_, tb, torch.from_numpy(pad)[:, 1], N,
                               ltw, lcw)
    np.testing.assert_array_equal(ip.numpy(), it.numpy())
    np.testing.assert_array_equal(vp.numpy(), vt.numpy())


def test_joint_top_k_tie_semantics():
    """Exact logit ties (duplicated weight rows, equal bias) break to the
    lowest vocab index, as the JAX kernel does."""
    B, N, V, D = 2, 4, 1408, 128
    rng = np.random.default_rng(2)
    w = rng.normal(size=(D, V)).astype(np.float32)
    w[:, 400:420] = w[:, 100:120]
    w[:, 1300:1320] = w[:, 100:120]
    b = np.zeros((V,), np.float32)
    x = (rng.normal(size=(B * N, D)) * 0.3).astype(np.float32)
    ctc = np.full((B, V), -np.log(V), np.float32)     # uniform: ties kept
    ltw, lcw = float(np.log(0.7)), float(np.log(0.3))
    _, ij = joint_top_k_vocab_pallas(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(b), jnp.asarray(ctc), N,
                                     ltw, lcw)
    _, it = joint_top_k_vocab_plain(
        torch.from_numpy(x), torch.from_numpy(w.T.copy()),
        torch.from_numpy(b), torch.from_numpy(ctc), N, ltw, lcw)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))


@pytest.mark.parametrize("k", [40, 128])
def test_joint_top_k_wide_beam_matches_jax(k):
    """k past the selection's old 32 cap, on seeded inputs with exact ties
    (duplicated weight columns, uniform CTC rows).  The JAX wrapper hands
    k >= the chunk count (and k > 128) to its exact XLA top_k_vocab:
    indices exact, values 1e-5 (the logsumexp's order).  x and w are
    multiples of 1/4 and 1/8, so every logit is exact in f32 in any
    summation order and the duplicated columns tie in both packages (and
    many other logits tie too)."""
    B, N, V, D = 2, 4, 1408, 128
    rng = np.random.default_rng(3)
    w = (rng.integers(-4, 5, size=(D, V)) / 8).astype(np.float32)
    w[:, 400:420] = w[:, 100:120]
    w[:, 1300:1320] = w[:, 100:120]
    b = np.zeros((V,), np.float32)
    x = (rng.integers(-4, 5, size=(B * N, D)) / 4).astype(np.float32)
    ctc = np.full((B, V), -np.log(V), np.float32)
    ltw, lcw = float(np.log(0.7)), float(np.log(0.3))
    vj, ij = joint_top_k_vocab_pallas(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(b), jnp.asarray(ctc), k,
                                      ltw, lcw)
    vt, it = joint_top_k_vocab(
        torch.from_numpy(x), torch.from_numpy(w.T.copy()),
        torch.from_numpy(b), torch.from_numpy(ctc), k, ltw, lcw)
    assert it.shape == (B, N, k)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-5,
                               atol=1e-5)


def test_check_select_takes_any_k_that_fits():
    """The CUDA selection serves every k whose row and scratch fit the
    block's shared memory (k = 40, 128 and 256 at the flagship's V), and
    refuses a k past V or a row too wide to stage."""
    for k in (1, 8, 40, 128, 256):
        t_topk.check_select("t", 5002, k)
    with pytest.raises(ValueError, match="outside 1..V"):
        t_topk.check_select("t", 100, 101)
    with pytest.raises(ValueError, match="does not fit"):
        t_topk.check_select("t", 60000, 8)
    with pytest.raises(ValueError, match="does not fit"):
        t_topk.check_select("t", 5002, 1024)


def _mixed_rows(V, seed):
    """Rows of one (3, 2, V) array: random scores, quantized scores with
    exact duplicates within and across chunks, a dead (-inf) beam row and
    a -inf vocab tail."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(3, 2, V)).astype(np.float32) * 5
    x[1] = rng.integers(-6, 6, size=(2, V))
    x[2, 0] = -np.inf
    x[2, 1, V // 2:] = -np.inf
    return x


@pytest.mark.parametrize("V,k", [
    (1300, 6),      # two-level, V % 128 != 0
    (600, 8),       # V <= 8 * 128: the direct gate
    (1100, 9),      # k >= G: the direct gate
])
def test_k5_plain_matches_jax_pallas(V, k):
    x = _mixed_rows(V, 4)
    vj, ij = top_k_vocab_pallas(jnp.asarray(x), k)
    vt, it = t_topk.top_k_vocab(torch.from_numpy(x), k)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


def _softmax_rows(rng, shape):
    z = rng.randn(*shape).astype(np.float32) * 2
    return z - np.log(np.exp(z).sum(-1, keepdims=True))


@pytest.mark.parametrize("B,N,V,tw,cw,ties", [
    (2, 4, 1300, 0.7, 0.3, False),         # two-level
    (2, 4, 1100, 1.0, 0.0, True),          # exact ties, log_cw = -inf
    (2, 4, 600, 0.7, 0.3, True),           # V <= 8 * 128: the direct gate
])
def test_k4_plain_matches_jax_pallas(B, N, V, tw, cw, ties):
    rng = np.random.RandomState(7)
    logp = _softmax_rows(rng, (B * N, V))
    ctc = _softmax_rows(rng, (B, V))
    if ties:
        # duplicated blocks across chunk boundaries, a uniform CTC row
        logp[:, 400:420] = logp[:, 100:120]
        logp[:, V - 30:V - 10] = logp[:, 100:120]
        ctc[:] = -np.log(V)
    ltw = math.log(tw) if tw > 0 else -math.inf
    lcw = math.log(cw) if cw > 0 else -math.inf
    vj, ij = fused_top_k_vocab_pallas(jnp.asarray(logp), jnp.asarray(ctc),
                                      N, ltw, lcw)
    vt, it = fused_top_k_vocab(torch.from_numpy(logp), torch.from_numpy(ctc),
                               N, ltw, lcw)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-6,
                               atol=1e-6)
    # a lane-padded, strided ctc (as the beam passes it) gives the same
    pad = np.full((B, 2, V + 40), -np.inf, np.float32)
    pad[:, 1, :V] = ctc
    vp, ip = fused_top_k_vocab(torch.from_numpy(logp),
                               torch.from_numpy(pad)[:, 1], N, ltw, lcw)
    np.testing.assert_array_equal(ip.numpy(), it.numpy())
    np.testing.assert_array_equal(vp.numpy(), vt.numpy())
