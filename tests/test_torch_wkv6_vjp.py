"""The port's analytic WKV6 backward against the JAX package and autograd.

``ops/wkv6.wkv6_backward`` (plain PyTorch) is held to the JAX package's
``wkv6_backward`` on the same numpy inputs, and ``wkv6_cuda``'s autograd
rule (its forward runs the plain version on the CPU) to torch autograd
through ``wkv6_chunked``: with and without a state, on ragged T (padding),
in the decay clamp's region and in bf16, mirroring
``tests/test_wkv6_vjp.py``.  Tolerances are relative to each gradient's
largest entry: 1e-4 in f32 (the JAX test's).  The decay gradient is a
difference of reverse cumulative sums over T, whose f32 cancellation noise
grows with T and with the clamp: 5e-4 over T = 300 (the JAX test's 1e-4 at
T = 70, scaled by the longer sum), 1e-3 against the JAX backward where the
clamp binds on most steps (the JAX test bounds each side's noise there by
5e-4).  2e-2 in bf16 (the chunk products take bf16 operands in both
frameworks, which round in different places).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paper_accurate_fast_cheap_tpu.ops import wkv6 as j_wkv6
from paper_accurate_fast_cheap_tpu_torch.ops import wkv6 as t_wkv6
from paper_accurate_fast_cheap_tpu_torch.ops.wkv6_cuda import wkv6_cuda

NAMES = ("r", "k", "v", "w", "u", "state")
# jitted: one compile per configuration costs less on the CPU than the eager
# op stream (it is the program the custom VJP runs inside a train step)
j_backward = jax.jit(j_wkv6.wkv6_backward,
                     static_argnames=("chunk_size", "inner_size"))


def _inputs(seed, B=2, T=70, H=2, N=8, wscale=1.0, wshift=-1.0):
    rng = np.random.RandomState(seed)
    mk = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    r, k, v = mk(B, T, H, N), mk(B, T, H, N), mk(B, T, H, N)
    w = mk(B, T, H, N) * wscale + wshift
    u = mk(H, N) * 0.5
    s0, gy, gs = mk(B, H, N, N), mk(B, T, H, N), mk(B, H, N, N)
    return r, k, v, w, u, s0, gy, gs


def _check(got, want, rtol, rtol_w=None):
    for n, a, b in zip(NAMES, want, got):
        if a is None:
            assert b is None, n
            continue
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        diff = float(np.max(np.abs(a - b)))
        if diff < 1e-5:  # an exactly-zero gradient must not amplify noise
            continue
        err = diff / (float(np.max(np.abs(a))) + 1e-9)
        tol = rtol_w if n == "w" and rtol_w else rtol
        assert err < tol, f"grad[{n}] rel err {err:.3e} >= {tol}"


@pytest.mark.parametrize("T,chunk,inner,state,wscale,wshift,rtol_w", [
    (70, 32, 8, True, 1.0, -1.0, 1e-4),     # state in and cotangent out
    (70, 32, 8, False, 1.0, -1.0, 1e-4),    # no state, padding 70 -> 96
    (64, 16, 8, False, 2.0, 2.5, 1e-3),     # the clamp binds on most steps
    (40, 256, 16, True, 1.0, -2.0, 1e-4),   # the model's chunk and inner
])
def test_backward_matches_jax(T, chunk, inner, state, wscale, wshift,
                              rtol_w):
    r, k, v, w, u, s0, gy, gs = _inputs(0, T=T, wscale=wscale,
                                        wshift=wshift)
    s0, gs = (s0, gs) if state else (None, None)
    gj = j_backward(
        *(None if x is None else jnp.asarray(x)
          for x in (r, k, v, w, u, s0, gy, gs)),
        chunk_size=chunk, inner_size=inner)
    gt = t_wkv6.wkv6_backward(
        *(None if x is None else torch.from_numpy(x)
          for x in (r, k, v, w, u, s0, gy, gs)),
        chunk_size=chunk, inner_size=inner)
    _check([None if g is None else g.numpy() for g in gt], gj, 1e-4, rtol_w)
    if wshift > 0:  # no decay gradient where the forward's clamp binds
        clamp = np.log(160.0 / (inner + 2))
        assert np.all(gt[3].numpy()[w > clamp] == 0.0)


def test_backward_bf16_matches_jax():
    r, k, v, w, u, s0, gy, gs = _inputs(1, T=50)
    bf = lambda x: x.astype(jnp.bfloat16)  # noqa: E731
    gj = j_backward(*(bf(jnp.asarray(x)) for x in (r, k, v, w)),
                              jnp.asarray(u), jnp.asarray(s0),
                              bf(jnp.asarray(gy)), jnp.asarray(gs),
                              chunk_size=32, inner_size=8)
    tb = lambda x: torch.from_numpy(x).bfloat16()  # noqa: E731
    gt = t_wkv6.wkv6_backward(*(tb(x) for x in (r, k, v, w)),
                              torch.from_numpy(u), torch.from_numpy(s0),
                              tb(gy), torch.from_numpy(gs),
                              chunk_size=32, inner_size=8)
    assert [g.dtype for g in gt] == [torch.bfloat16] * 4 + [torch.float32] * 2
    _check([g.float().numpy() for g in gt],
           [np.asarray(g, np.float32) for g in gj], 2e-2)


@pytest.mark.parametrize("state", [False, True])
def test_autograd_function_matches_autograd_of_chunked(state):
    """wkv6_cuda's rule (analytic backward, chunk 256 / inner 16) against
    torch autograd through the same forward, T = 300 (two chunks, padded)."""
    r, k, v, w, u, s0, gy, gs = _inputs(2, T=300, N=16, wshift=-0.5)
    base = [torch.from_numpy(x) for x in (r, k, v, w, u)]
    if state:
        base.append(torch.from_numpy(s0))
    grads = []
    for fn in (wkv6_cuda, t_wkv6.wkv6_chunked):
        leaves = [t.clone().requires_grad_() for t in base]
        out = fn(*leaves[:5], state=leaves[5] if state else None,
                 return_state=state)
        loss = ((out[0] * torch.from_numpy(gy)).sum()
                + (out[1] * torch.from_numpy(gs)).sum()
                if state else (out * torch.from_numpy(gy)).sum())
        grads.append([g.numpy() for g in torch.autograd.grad(loss, leaves)])
    _check(grads[0], grads[1], 1e-4, 5e-4)
    assert wkv6_cuda.launches == 0  # the CPU runs the plain version


def test_autograd_function_unused_state_cotangent():
    """With return_state and only y in the loss, the state's cotangent is
    absent (None), as a final state nobody reads."""
    r, k, v, w, u, s0, gy, _ = _inputs(3, T=40)
    leaves = [torch.from_numpy(x).requires_grad_() for x in
              (r, k, v, w, u, s0)]
    y, _ = wkv6_cuda(*leaves[:5], state=leaves[5], return_state=True)
    got = torch.autograd.grad((y * torch.from_numpy(gy)).sum(), leaves)
    want = t_wkv6.wkv6_backward(
        *(torch.from_numpy(x) for x in (r, k, v, w, u, s0, gy)), None)
    _check([g.numpy() for g in got], [g.numpy() for g in want], 1e-6)
