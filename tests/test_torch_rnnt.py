"""The port's RNN-T loss and CTC loss against the JAX package, mirroring
``tests/test_rnnt.py``.

Inputs are numpy arrays from a seed, fed to both frameworks in f32: the
forward recursion (values and gradients, ragged T and U, an empty label
sequence), the T-chunked gather of the joint's log-probs (values, and the
gradients of the projected inputs and of the joint's weights through the
checkpointed chunks), the dense oracle, and the CTC loss (plain and focal)
on sequences that can be aligned.  Tolerances: 1e-5 relative on losses
(the same f32 recursion; the port's closed form over u against JAX's
associative scan), 1e-4 on gradients.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paper_accurate_fast_cheap_tpu.models import ctc_head as j_ctc
from paper_accurate_fast_cheap_tpu.ops import rnnt as j_rnnt
from paper_accurate_fast_cheap_tpu_torch.models import ctc_head as t_ctc
from paper_accurate_fast_cheap_tpu_torch.ops import rnnt as t_rnnt


def _case(seed, B=3, T=9, U=4, V=7):
    rng = np.random.RandomState(seed)
    logits = rng.randn(B, T, U + 1, V).astype(np.float32)
    labels = rng.randint(1, V, (B, U)).astype(np.int32)
    t_lens = np.asarray([T, T - 2, T - 4][:B], np.int32)
    u_lens = np.asarray([U, U - 1, 0][:B], np.int32)   # one empty sequence
    return logits, labels, t_lens, u_lens


def test_dense_loss_and_grads_match_jax():
    logits, labels, t_lens, u_lens = _case(0)

    def j_loss(lg):
        return jnp.sum(j_rnnt.rnnt_loss_dense(lg, jnp.asarray(labels),
                                              jnp.asarray(t_lens),
                                              jnp.asarray(u_lens))
                       * jnp.asarray([1.0, 2.0, 3.0]))

    want, gj = jax.jit(jax.value_and_grad(j_loss))(jnp.asarray(logits))
    lg = torch.from_numpy(logits).requires_grad_()
    per = t_rnnt.rnnt_loss_dense(lg, torch.from_numpy(labels),
                                 torch.from_numpy(t_lens),
                                 torch.from_numpy(u_lens))
    got = (per * torch.tensor([1.0, 2.0, 3.0])).sum()
    (gt,) = torch.autograd.grad(got, lg)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-4,
                               atol=1e-4)
    assert np.isfinite(gt.numpy()).all()


def test_forward_recursion_matches_jax_on_log_probs():
    """rnnt_forward on arbitrary (label, blank) log-prob grids, with the
    NEG_INF masking of u >= U_b and per-sequence terminals."""
    rng = np.random.RandomState(1)
    B, T, U1 = 4, 12, 6
    lab = -np.abs(rng.randn(B, T, U1)).astype(np.float32) * 3
    blank = -np.abs(rng.randn(B, T, U1)).astype(np.float32) * 3
    t_lens = np.asarray([12, 7, 1, 10], np.int32)
    u_lens = np.asarray([5, 2, 0, 5], np.int32)
    want = jax.jit(j_rnnt.rnnt_forward)(*map(jnp.asarray, (lab, blank,
                                                           t_lens, u_lens)))
    got = t_rnnt.rnnt_forward(*map(torch.from_numpy, (lab, blank, t_lens,
                                                      u_lens)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_chunked_gather_matches_jax_values_and_grads():
    """The checkpointed T-chunks (t_chunk 4 over T = 11: a ragged last
    chunk) against the JAX gather; gradients of the projected inputs and of
    the joint's weights, which the chunks close over."""
    rng = np.random.RandomState(2)
    B, T, U, V, J = 2, 11, 3, 8, 5
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    enc_p, pred_p, W, b = f(B, T, J), f(B, U + 1, J), f(J, V) * 0.5, f(V)
    labels = rng.randint(1, V, (B, U)).astype(np.int32)
    t_lens, u_lens = np.asarray([T, T - 3], np.int32), np.asarray([U, 2],
                                                                  np.int32)

    @jax.jit
    def j_total(e, p, W, b):
        def loss(e, p, W, b):
            lab, blank = j_rnnt.gather_rnnt_logprobs_chunked(
                e, p, jnp.asarray(labels),
                lambda x, y: jnp.tanh(x + y) @ W + b, t_chunk=4)
            nll = j_rnnt.rnnt_forward(lab, blank, jnp.asarray(t_lens),
                                      jnp.asarray(u_lens))
            return jnp.sum(nll), (lab, blank)

        return jax.value_and_grad(loss, argnums=(0, 1, 2, 3),
                                  has_aux=True)(e, p, W, b)

    (want, (jl, jb)), gj = j_total(*map(jnp.asarray, (enc_p, pred_p, W, b)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in
              (enc_p, pred_p, W, b)]
    lab, blank = t_rnnt.gather_rnnt_logprobs_chunked(
        leaves[0], leaves[1], torch.from_numpy(labels),
        lambda x, y: torch.tanh(x + y) @ leaves[2] + leaves[3], t_chunk=4)
    got = t_rnnt.rnnt_forward(lab, blank, torch.from_numpy(t_lens),
                              torch.from_numpy(u_lens)).sum()
    gt = torch.autograd.grad(got, leaves)
    np.testing.assert_allclose(lab.detach().numpy(), np.asarray(jl),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(blank.detach().numpy(), np.asarray(jb),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    for a, c in zip(gt, gj):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("focal", [False, True])
def test_ctc_loss_matches_jax(focal):
    rng = np.random.RandomState(3)
    B, T, U, V = 3, 20, 5, 9
    logits = rng.randn(B, T, V).astype(np.float32)
    labels = rng.randint(1, V, (B, U)).astype(np.int32)
    labels[0, 2] = labels[0, 1]                 # a repeat needs a blank
    t_lens = np.asarray([20, 15, 9], np.int32)
    u_lens = np.asarray([5, 3, 4], np.int32)
    want, gj = jax.jit(jax.value_and_grad(
        lambda lg: j_ctc.ctc_loss(lg, jnp.asarray(t_lens),
                                  jnp.asarray(labels), jnp.asarray(u_lens),
                                  use_focal_loss=focal)))(jnp.asarray(logits))
    lg = torch.from_numpy(logits).requires_grad_()
    got = t_ctc.ctc_loss(lg, torch.from_numpy(t_lens),
                         torch.from_numpy(labels), torch.from_numpy(u_lens),
                         use_focal_loss=focal)
    (gt,) = torch.autograd.grad(got, lg)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-4,
                               atol=1e-5)
