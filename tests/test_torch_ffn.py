"""K6's plain version, ``fused_ffn`` and the feed-forward module of the port
against the JAX package, mirroring ``tests/test_ffn_pallas.py``.

On the CPU ``fused_ffn`` runs ``ffn_plain`` on the weights cast to x's
dtype; the JAX ``fused_ffn`` runs its Pallas kernel in interpret mode
(D and H multiples of 128, so it does not fall back).  Weights are the
JAX layout (in, out) on the JAX side and nn.Linear's (out, in) on the
port's.  Tolerances: f32 1e-5 (the same f32 products in two summation
orders), bf16 0.05 (the JAX test's rounding class: both round the hidden
and the output to bf16, at different points).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paper_accurate_fast_cheap_tpu.models import convolution as j_conv
from paper_accurate_fast_cheap_tpu.ops import ffn_pallas
from paper_accurate_fast_cheap_tpu_torch.models import convolution as t_conv
from paper_accurate_fast_cheap_tpu_torch.ops import ffn as t_ffn

ACTS = ["swish", "relu", "gelu", "hardtanh"]


def _mats(seed, D=128, H=256, R=150):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return (f(R, D), f(D, H) * 0.05, f(H), f(H, D) * 0.05, f(D))


def _port(x, w1, b1, w2, b2, dtype=torch.float32):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dtype)  # noqa
    return t(x), t(w1.T), t(b1), t(w2.T), t(b2)


@pytest.mark.parametrize("act", ACTS)
def test_plain_and_fused_match_jax_f32(act):
    x, w1, b1, w2, b2 = _mats(0)
    want = np.asarray(ffn_pallas.fused_ffn(*map(jnp.asarray,
                                                (x, w1, b1, w2, b2)), act))
    ref = np.asarray(ffn_pallas._ffn_ref(*map(jnp.asarray,
                                              (x, w1, b1, w2, b2)), act))
    args = _port(x, w1, b1, w2, b2)
    np.testing.assert_allclose(t_ffn.ffn_plain(*args, act).numpy(), ref,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t_ffn.fused_ffn(*args, act).numpy(), want,
                               rtol=1e-5, atol=1e-5)


def test_fused_bf16_rounding_class():
    x, w1, b1, w2, b2 = _mats(1)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    want = ffn_pallas.fused_ffn(*map(bf, (x, w1, b1, w2, b2)), "gelu")
    y = t_ffn.fused_ffn(*_port(x, w1, b1, w2, b2, torch.bfloat16), "gelu")
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=0.05, atol=0.05)


def test_fused_casts_weights_to_x_dtype():
    """f32 x with bf16 weights (the mixed-precision step) computes in f32
    on the bf16-valued weights, as the JAX wrapper's cast does."""
    x, w1, b1, w2, b2 = _mats(2)
    wb = [jnp.asarray(a, jnp.bfloat16) for a in (w1, b1, w2, b2)]
    want = ffn_pallas.fused_ffn(jnp.asarray(x), *wb, "swish")
    xt, *wt = _port(x, w1, b1, w2, b2)
    y = t_ffn.fused_ffn(xt, *(a.bfloat16() for a in wt), "swish")
    assert y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_grad_matches_jax_custom_vjp():
    """fused_ffn's backward recomputes through ffn_plain, as the JAX custom
    VJP recomputes through _ffn_ref: every input's gradient."""
    x, w1, b1, w2, b2 = _mats(3)

    def f_fused(*a):
        return jnp.sum(ffn_pallas.fused_ffn(*a, "swish") ** 2)

    gj = jax.grad(f_fused, argnums=(0, 1, 2, 3, 4))(
        *map(jnp.asarray, (x, w1, b1, w2, b2)))
    leaves = [a.requires_grad_() for a in _port(x, w1, b1, w2, b2)]
    gt = torch.autograd.grad((t_ffn.fused_ffn(*leaves, "swish") ** 2).sum(),
                             leaves)
    for a, b, transpose in zip(gt, gj, (False, True, False, True, False)):
        a = a.numpy().T if transpose else a.numpy()
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-4)


def _modules(act, dropout=0.1):
    D, H = 128, 256
    jm = j_conv.PositionwiseFeedForward(D, H, dropout, act)
    x = np.random.default_rng(4).normal(size=(2, 25, D)).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tm = t_conv.PositionwiseFeedForward(D, H, dropout, act)
    p = params["params"]
    with torch.no_grad():
        for name in ("Dense_0", "Dense_1"):
            lin = getattr(tm, name)
            lin.weight.copy_(torch.from_numpy(np.array(p[name]["kernel"]).T))
            lin.bias.copy_(torch.from_numpy(np.array(p[name]["bias"])))
    return jm, params, tm, x


@pytest.mark.parametrize("act", ACTS)
def test_module_activations_match_jax(act):
    """The port's feed-forward takes every activation of the JAX module
    (gelu in its tanh form), on both impls, in eval mode."""
    jm, params, tm, x = _modules(act)
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    tm.eval()
    for impl in ("xla", "pallas", "auto"):
        tm.impl = impl
        np.testing.assert_allclose(tm(torch.from_numpy(x)).detach().numpy(),
                                   want, rtol=1e-5, atol=1e-5)


def test_module_takes_the_kernel_only_without_dropout(monkeypatch):
    """impl="pallas" calls fused_ffn in eval mode or at rate 0, and the
    plain path with its dropout while dropout is active, as the JAX
    module does; "auto" resolves to "xla"."""
    calls = []

    def spy(*a):
        calls.append(1)
        return t_ffn.fused_ffn(*a)

    monkeypatch.setattr(t_conv, "fused_ffn", spy)
    _, _, tm, x = _modules("swish")
    xt = torch.from_numpy(x)
    tm.impl = "pallas"
    tm.eval()
    y_eval = tm(xt)
    assert len(calls) == 1
    tm.train()
    torch.manual_seed(0)
    y0 = tm(xt)
    torch.manual_seed(0)
    y0_again = tm(xt)
    torch.manual_seed(1)
    y1 = tm(xt)
    assert len(calls) == 1  # dropout active: the plain path
    assert torch.equal(y0, y0_again) and not torch.equal(y0, y1)
    assert not torch.allclose(y0, y_eval)
    tm.impl = "xla"
    torch.manual_seed(0)
    assert torch.equal(tm(xt), y0)  # the same plain path and masks
    tm.impl = "auto"
    tm.eval()
    tm(xt)
    assert len(calls) == 1
    tm.impl = "pallas"
    tm.dropout.p = 0.0
    tm.train()
    tm(xt)
    assert len(calls) == 2  # rate 0: dropout inactive, the kernel path


def test_unknown_activation_and_impl_raise():
    with pytest.raises(NotImplementedError):
        t_conv.PositionwiseFeedForward(8, 16, activation="mish")
    with pytest.raises(ValueError):
        t_conv.PositionwiseFeedForward(8, 16, impl="triton")
    assert t_ffn.fused_ffn.launches == 0  # the CPU runs the plain version


def test_kernel_shape_limits():
    """The CUDA kernels' widths, checked by a plain function before any
    launch: D = 512 and H a positive multiple of 256.  The CPU path runs
    the plain version, which takes any width."""
    t_ffn.check_kernel_shape(512, 2048)
    t_ffn.check_kernel_shape(512, 256)
    for D, H in ((256, 2048), (640, 2560), (512, 2000), (512, 128)):
        with pytest.raises(t_ffn.cuda_lib.KernelError, match="D = 512"):
            t_ffn.check_kernel_shape(D, H)
