"""The port's plain WKV6 versions (K1's reference) against the JAX package.

Inputs come from numpy and go to both frameworks in f32.  Tolerances:
2e-5 against the JAX scan and chunked forms (the same f32 algorithm,
summation order aside), 3e-4 against the Pallas kernel in interpret mode
(the tolerance of its own test, ``tests/test_wkv6_pallas.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paper_accurate_fast_cheap_tpu.ops import wkv6 as j_wkv6
from paper_accurate_fast_cheap_tpu.ops.wkv6_pallas import wkv6_pallas
from paper_accurate_fast_cheap_tpu_torch.ops import wkv6 as t_wkv6
from paper_accurate_fast_cheap_tpu_torch.ops.wkv6_cuda import wkv6_cuda


def _inputs(seed, B=2, T=40, H=2, N=16, state=False):
    rng = np.random.RandomState(seed)
    mk = lambda: rng.randn(B, T, H, N).astype(np.float32)  # noqa: E731
    r, k, v = mk(), mk(), mk()
    w = mk() - 2.0       # some steps exceed the decay clamp log(160/18)
    u = (rng.randn(H, N) * 0.5).astype(np.float32)
    s0 = (rng.randn(B, H, N, N) * 0.3).astype(np.float32) if state else None
    return r, k, v, w, u, s0


def _t(*xs):
    return [None if x is None else torch.from_numpy(x) for x in xs]


def _j(*xs):
    return [None if x is None else jnp.asarray(x) for x in xs]


@pytest.mark.parametrize("T,state", [(40, False), (23, True)])
def test_ref_matches_jax_ref(T, state):
    r, k, v, w, u, s0 = _inputs(0, T=T, state=state)
    yj, sj = j_wkv6.wkv6_ref(*_j(r, k, v, w, u), state=_j(s0)[0],
                             return_state=True)
    yt, st = t_wkv6.wkv6_ref(*_t(r, k, v, w, u), state=_t(s0)[0],
                             return_state=True)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=2e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=2e-5)


@pytest.mark.parametrize("T,chunk,state", [
    (57, 32, False),    # ragged T: pad steps with w = -inf
    (100, 32, True),    # multi-chunk with a carried state in and out
    (64, 256, True),    # one chunk, larger than T
])
def test_chunked_matches_jax_chunked(T, chunk, state):
    r, k, v, w, u, s0 = _inputs(1, T=T, state=state)
    yj, sj = j_wkv6.wkv6_chunked(*_j(r, k, v, w, u), state=_j(s0)[0],
                                 chunk_size=chunk, return_state=True)
    yt, st = t_wkv6.wkv6_chunked(*_t(r, k, v, w, u), state=_t(s0)[0],
                                 chunk_size=chunk, return_state=True)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=2e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=2e-5)


def test_chunked_matches_jax_pallas_interpret():
    r, k, v, w, u, _ = _inputs(2, T=40, N=64)
    yj = wkv6_pallas(*_j(r, k, v, w, u), chunk_size=32, version=5)
    yt = t_wkv6.wkv6_chunked(*_t(r, k, v, w, u), chunk_size=32)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=3e-4,
                               rtol=3e-4)


@pytest.mark.parametrize("L", [64, 32])
def test_kernel_blocking_matches_jax_pallas_interpret(L):
    """The chunked form at K1's blocking (chunks of L = 64 steps, or 32 for
    f32 at N = 128; inner blocks of 16) with a ragged T (a partial last
    chunk) and a state in and out, against the two-pass Pallas kernel at
    the same chunk size in interpret mode."""
    r, k, v, w, u, s0 = _inputs(6, B=1, T=77, N=32, state=True)
    yj, sj = wkv6_pallas(*_j(r, k, v, w, u), state=jnp.asarray(s0),
                         chunk_size=L, return_state=True, version=5)
    yt, st = t_wkv6.wkv6_chunked(*_t(r, k, v, w, u), state=_t(s0)[0],
                                 chunk_size=L, inner_size=16,
                                 return_state=True)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=3e-4,
                               rtol=3e-4)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=3e-4,
                               rtol=3e-4)


def test_streaming_split_matches_one_pass():
    """Two calls carrying the state equal one call over the whole T."""
    r, k, v, w, u, s0 = _inputs(3, T=70, state=True)
    tr, tk, tv, tw, tu, ts = _t(r, k, v, w, u, s0)
    y_all, s_all = t_wkv6.wkv6_chunked(tr, tk, tv, tw, tu, state=ts,
                                       chunk_size=32, return_state=True)
    y1, s1 = t_wkv6.wkv6_chunked(tr[:, :33], tk[:, :33], tv[:, :33],
                                 tw[:, :33], tu, state=ts, chunk_size=32,
                                 return_state=True)
    y2, s2 = t_wkv6.wkv6_chunked(tr[:, 33:], tk[:, 33:], tv[:, 33:],
                                 tw[:, 33:], tu, state=s1, chunk_size=32,
                                 return_state=True)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y_all.numpy(),
                               atol=2e-5)
    np.testing.assert_allclose(s2.numpy(), s_all.numpy(), atol=2e-5)
    yj = j_wkv6.wkv6_chunked(*_j(r, k, v, w, u), state=jnp.asarray(s0),
                             chunk_size=32)
    np.testing.assert_allclose(y_all.numpy(), np.asarray(yj), atol=2e-5)


@pytest.mark.parametrize("impl", ["ref", "chunked", "kernel"])
def test_dispatcher_and_kernel_wrapper_on_cpu(impl):
    """The plain versions and the K1 wrapper (the model's one WKV entry,
    which runs the chunked plain version on CPU tensors) agree where the
    decay clamp is not reached."""
    fn = {"ref": t_wkv6.wkv6_ref, "chunked": t_wkv6.wkv6_chunked,
          "kernel": wkv6_cuda}[impl]
    r, k, v, w, u, s0 = _inputs(4, T=30, state=True)
    w = np.minimum(w, 1.0)
    args = _t(r, k, v, w, u)
    before = wkv6_cuda.launches
    y, s = fn(*args, state=_t(s0)[0], return_state=True)
    assert wkv6_cuda.launches == before         # the CPU path counts nothing
    y0, s0_ = t_wkv6.wkv6_ref(*args, state=_t(s0)[0], return_state=True)
    np.testing.assert_allclose(y.numpy(), y0.numpy(), atol=2e-5)
    np.testing.assert_allclose(s.numpy(), s0_.numpy(), atol=2e-5)
    if impl == "kernel":
        np.testing.assert_array_equal(
            wkv6_cuda(*args).numpy(), t_wkv6.wkv6_chunked(*args).numpy())


def test_common_helpers_match_jax():
    from paper_accurate_fast_cheap_tpu.ops import common as j_common
    from paper_accurate_fast_cheap_tpu_torch.ops import common as t_common

    x = np.random.RandomState(5).randn(3, 7, 4).astype(np.float32)
    for axis in (0, 1, 2):
        np.testing.assert_allclose(
            t_common.revcumsum(torch.from_numpy(x), axis).numpy(),
            np.asarray(j_common.revcumsum(jnp.asarray(x), axis)), atol=1e-6)
    (y,) = t_common.as_f32(torch.from_numpy(x).to(torch.bfloat16))
    assert y.dtype == torch.float32
