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
    """The CUDA selections (K2's two-level one, K4's and K5's filter) serve
    every k whose row and scratch fit the block's shared memory (k = 40,
    128 and 256 at the flagship's V), and refuse a k past V or a row too
    wide to stage."""
    for smem in (t_topk.select_smem_bytes, t_topk.filter_smem_bytes):
        for k in (1, 8, 40, 128, 256):
            t_topk.check_select("t", 5002, k, smem)
        with pytest.raises(ValueError, match="outside 1..V"):
            t_topk.check_select("t", 100, 101, smem)
        with pytest.raises(ValueError, match="does not fit"):
            t_topk.check_select("t", 60000, 8, smem)
        with pytest.raises(ValueError, match="does not fit"):
            t_topk.check_select("t", 5002, 1024, smem)


_SENTINEL = -2 ** 63                 # below every key: the kernel's key 0


def _filter_keys(x, Vp):
    """(value desc, index asc) keys of the scores of x, padded to Vp: the
    monotone value bits (-0 as +0) above the inverted index, in int64;
    the sentinel for -inf and the pad."""
    xp = torch.nn.functional.pad(x, (0, Vp - x.shape[1]), value=-math.inf)
    n = torch.arange(Vp)
    bits = torch.where(xp == 0, 0.0, xp).view(torch.int32).long() & 0xffffffff
    u = torch.where(bits >= 2 ** 31, 0xffffffff - bits, bits + 2 ** 31)
    return xp, torch.where(xp > -math.inf,
                           (u - 2 ** 31) * 2 ** 32 + (2 ** 32 - 1 - n),
                           _SENTINEL)


def _filter_model(x, k, low=None):
    """K4's and K5's threshold filter (``csrc/topk_filter.cuh``) on f32 rows
    x (R, V), as the kernel computes it: thread group (warp c % 8, lane
    n % 32) of column n in chunk c; a key per score ordering (value desc,
    index asc); tau = the k-th best group key (none past 256 groups or
    short of k groups) -- of the lower bounds ``low`` where K4 stages them
    (max of the logaddexp's operands); the candidates = the scores whose
    key is >= tau; their exact top-k.  Returns (vals, idx, degenerate,
    n_cand): a degenerate row (fewer than k chunks holding a score, or k
    scores on the direct path) runs the two-level selection instead."""
    R, V = x.shape
    G = -(-V // 128)
    Vp = G * 128
    direct = V <= 8 * 128 or k >= G
    xp, key = _filter_keys(x, Vp)
    fin = key > _SENTINEL
    n_fin = fin.sum(-1) if direct else fin.view(R, G, 128).any(-1).sum(-1)
    _, gsrc = (xp, key) if low is None else _filter_keys(low, Vp)
    n = torch.arange(Vp)
    group = ((n // 128) % 8 * 32 + n % 32).expand(R, Vp)
    gkey = torch.full((R, 256), _SENTINEL).scatter_reduce(
        1, group, gsrc, "amax")
    tau = (gkey.sort(-1, descending=True).values[:, k - 1:k] if k <= 256
           else torch.full((R, 1), _SENTINEL))
    cand = fin & (key >= tau)
    top = torch.where(cand, key, _SENTINEL).sort(-1, descending=True).values
    idx = (2 ** 32 - 1 - (top[:, :k] & 0xffffffff)).clamp(0, Vp - 1)
    return (torch.gather(xp, 1, idx), idx.to(torch.int32), n_fin < k,
            cand.sum(-1))


def _filter_rows(V, k, seed):
    """Rows of one (11, V) f32 array: random scores, integer ties, a -inf
    tail, a dead row, rows finite in fewer than k (and in k - 1) chunks,
    in k chunks, short of k finite scores, one finite score per chunk
    (the groups of lane 0: fewer than k groups hold a finite score), and
    signed zeros."""
    rng = np.random.RandomState(seed)
    G = -(-V // 128)
    x = (rng.randn(11, V) * 5).astype(np.float32)
    x[1] = rng.randint(-6, 6, size=V)
    x[2, V // 3:] = -np.inf
    x[3] = -np.inf
    for r, c in ((4, 3), (5, k - 1), (6, k)):
        keep = np.zeros(G, bool)
        keep[rng.permutation(G)[:min(c, G)]] = True
        x[r, ~np.repeat(keep, 128)[:V]] = -np.inf
    few = rng.permutation(V)[:max(k - 1, 1)]
    x[7] = -np.inf
    x[7, few] = rng.randn(few.size)
    x[8] = -np.inf
    x[8, ::128] = rng.randint(-2, 2, size=G)
    x[9] = rng.randint(-1, 2, size=V) * 0.0      # +0 and -0 tie
    x[10] = rng.randint(0, 2, size=V) * 1e-3
    return torch.from_numpy(x)


@pytest.mark.parametrize("V", [600, 1664, 2048, 5002])
@pytest.mark.parametrize("k", [1, 8, 40, 128])
@pytest.mark.parametrize("bounded", [False, True])
def test_filter_selection_identity(V, k, bounded):
    """The identity K5 (and K4, whose tau comes from lower bounds) rests
    on: on every row the kernel does not flag, the exact top-k of the
    candidates equals ``top_k_vocab_plain`` (values bit for bit, indices)
    and is served from the candidate space shared memory was sized for
    (``ops/topk.filter_capacity``) -- past it (K4 only) the kernel makes
    every score exact and selects again, as K5 does -- so every row where
    they differ is flagged; and the flag is needed (the dead row differs).
    K4's rows are logaddexp(a, b) of two such rows, bounded by max(a, b)."""
    x = _filter_rows(V, k, seed=V + k)
    low = None
    if bounded:
        b = _filter_rows(V, k, seed=V + k + 1) - 3
        low = torch.maximum(x, b)
        x = torch.logaddexp(x, b)
    vals, idx, degenerate, n_cand = _filter_model(x, k, low)
    cap = t_topk.filter_capacity(V, k)
    if bounded:
        retry = n_cand > cap
        exact = _filter_model(x, k)
        vals[retry], idx[retry], n_cand[retry] = (
            exact[0][retry], exact[1][retry], exact[3][retry])
    vp, ip = t_topk.top_k_vocab_plain(x, k)
    same = (idx == ip).all(-1) & (vals.view(torch.int32)
                                  == vp.view(torch.int32)).all(-1)
    assert bool(same[~degenerate].all())
    assert bool(degenerate[3]) and not bool(same[3])     # the dead row
    kept = n_cand[~degenerate]
    assert bool((kept >= k).all())
    assert bool((kept <= cap).all())


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
