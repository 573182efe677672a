"""The port's Mamba-2 SSD (``ops/ssd.py``) against the JAX package's.

Forward (f32, within 1e-5 absolute plus 1e-5 relative: f32 sums of
another order): ``ssd_ref`` and ``ssd_chunked`` with T not a
multiple of the chunk, G = 2 groups, the state in and out.  Backward: the
``chunked`` Function's gradients (the analytic ``ssd_backward``) against
``jax.grad`` through JAX's custom VJP and against torch autograd through
``ssd_chunked`` (1e-4 of each gradient's scale), every input and the state
included.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paper_accurate_fast_cheap_tpu.ops import ssd as j_ssd
from paper_accurate_fast_cheap_tpu_torch.ops import ssd as t_ssd

NAMES = ("x", "dt", "A", "B", "C", "D", "state")
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(seed, Bt=2, T=37, H=4, P=8, G=2, N=6):
    """x, dt (post-softplus), A < 0, B, C, D, state, and cotangents of y and
    the final state, as numpy f32."""
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    x = f(Bt, T, H, P)
    dt = (np.abs(f(Bt, T, H)) + 0.05).astype(np.float32)
    A = (-np.abs(f(H)) - 0.1).astype(np.float32)
    return (x, dt, A, f(Bt, T, G, N), f(Bt, T, G, N), f(H), f(Bt, H, N, P),
            f(Bt, T, H, P), f(Bt, H, N, P))


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


@pytest.mark.parametrize("impl,chunk", [("ref", 16), ("chunked", 16),
                                        ("chunked", 64), ("chunked_ad", 8)])
def test_forward_matches_jax(impl, chunk):
    x, dt, A, B, C, D, S0, _, _ = _inputs(0)
    j_fn = {"ref": lambda *a, **k: j_ssd.ssd_ref(*a, state=k["state"],
                                                 return_state=True)}.get(
        impl, lambda *a, **k: j_ssd.ssd_chunked(*a, chunk_size=chunk,
                                                return_state=True, **k))
    jy, jS = j_fn(*map(jnp.asarray, (x, dt, A, B, C, D)),
                  state=jnp.asarray(S0))
    with torch.no_grad():
        ty, tS = t_ssd.ssd(*_t(x, dt, A, B, C, D), state=_t(S0)[0],
                           chunk_size=chunk, return_state=True, impl=impl)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(tS.numpy(), np.asarray(jS), **TOL)
    # no state in, no D: the zero state and the bare recurrence
    jy0 = j_ssd.ssd_chunked(*map(jnp.asarray, (x, dt, A, B, C)),
                            chunk_size=16)
    with torch.no_grad():
        ty0 = t_ssd.ssd(*_t(x, dt, A, B, C), chunk_size=16, impl=impl)
    np.testing.assert_allclose(ty0.numpy(), np.asarray(jy0), **TOL)


def test_pad_steps_do_not_touch_the_state():
    """T = 37 on chunks of 16 pads 11 steps with dt = 0: the final state
    equals the oracle's after exactly 37 steps."""
    x, dt, A, B, C, D, S0, _, _ = _inputs(1)
    args = _t(x, dt, A, B, C, D)
    with torch.no_grad():
        _, s_ref = t_ssd.ssd_ref(*args, state=_t(S0)[0], return_state=True)
        _, s_chk = t_ssd.ssd_chunked(*args, state=_t(S0)[0], chunk_size=16,
                                     return_state=True)
    np.testing.assert_allclose(s_chk.numpy(), s_ref.numpy(), **TOL)


def _rel_check(got, want, names=NAMES, rtol=1e-4):
    for n, a, b in zip(names, want, got):
        a, b = np.asarray(a), np.asarray(b)
        scale = float(np.abs(a).max()) + 1e-9
        err = float(np.abs(a - b).max())
        assert err < 1e-5 or err / scale < rtol, (n, err, scale)


@pytest.mark.parametrize("T", [1, 70])
def test_backward_matches_jax_and_autograd(T):
    x, dt, A, B, C, D, S0, gy, gS = _inputs(2, T=T)

    def j_loss(*a):
        y, S = j_ssd.ssd_chunked_vjp(*a[:6], state=a[6], chunk_size=16,
                                     return_state=True)
        return jnp.sum(y * gy) + jnp.sum(S * gS)

    want = jax.grad(j_loss, argnums=tuple(range(7)))(
        *map(jnp.asarray, (x, dt, A, B, C, D, S0)))

    def t_grads(impl):
        args = [a.requires_grad_() for a in _t(x, dt, A, B, C, D, S0)]
        y, S = t_ssd.ssd(*args[:6], state=args[6], chunk_size=16,
                         return_state=True, impl=impl)
        ((y * _t(gy)[0]).sum() + (S * _t(gS)[0]).sum()).backward()
        return [a.grad.numpy() for a in args]

    got = t_grads("chunked")
    _rel_check(got, want)
    _rel_check(got, t_grads("chunked_ad"))


def test_backward_without_state_or_d():
    """y's cotangent alone, no D and no state: the Function returns None for
    them and the rest matches autograd through the chunked form."""
    x, dt, A, B, C, _, _, gy, _ = _inputs(3, T=29)

    def grads(impl):
        args = [a.requires_grad_() for a in _t(x, dt, A, B, C)]
        y = t_ssd.ssd(*args, chunk_size=8, impl=impl)
        (y * _t(gy)[0]).sum().backward()
        return [a.grad.numpy() for a in args]

    _rel_check(grads("chunked"), grads("chunked_ad"), NAMES[:5])


def test_unknown_impl_raises():
    x, dt, A, B, C, *_ = _inputs(4, T=3)
    with pytest.raises(ValueError, match="unknown ssd impl"):
        t_ssd.ssd(*_t(x, dt, A, B, C), impl="pallas")
