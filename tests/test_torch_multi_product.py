"""K7's plain version and the crash-repro tool of the port against the JAX
package.

The JAX side is the tool's Pallas body (``tools/repro_tpu_worker_crash.py``,
``kernel`` inside ``case_pinned_bisect``), copied here and run through
``pl.pallas_call(..., interpret=True)`` with the tool's BlockSpecs but
without ``with_memory_space_constraint``, which the interpreter cannot take
(the JAX package's ``ops/lstm_pallas.py`` skips it on the CPU for the same
reason).  Tolerance: one bf16 ulp of the output's scale (both versions sum
exact bf16 products in f32, in different orders, and round once).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from paper_accurate_fast_cheap_tpu_torch.ops import multi_product as K
from paper_accurate_fast_cheap_tpu_torch.tools import (
    repro_tpu_worker_crash as tool)

R, D, H = 512, 128, 256


def _tool_kernel(x_ref, *refs, H):
    # the body of the JAX tool's pinned_bisect kernel
    o_ref = refs[-1]
    acc = jnp.zeros((x_ref.shape[0], H), jnp.float32)
    for w_ref in refs[:-1]:
        acc += jax.lax.dot_general(
            x_ref[...], w_ref[...], (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32)
    o_ref[...] = acc.astype(jnp.bfloat16)


def _pinned_call(x, ws):
    D, H = ws[0].shape
    return pl.pallas_call(
        functools.partial(_tool_kernel, H=H),
        grid=(x.shape[0] // 256,),
        in_specs=[pl.BlockSpec((256, D), lambda i: (i, 0))]
        + [pl.BlockSpec(memory_space=pltpu.VMEM)] * len(ws),
        out_specs=pl.BlockSpec((256, H), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((x.shape[0], H), jnp.bfloat16),
        interpret=True,
    )(x, *ws)


def _inputs(buffers, seed=0):
    rng = np.random.RandomState(seed)
    x = jnp.asarray(rng.randn(R, D), jnp.bfloat16)
    ws = [jnp.asarray(rng.randn(D, H) * 0.1, jnp.bfloat16)
          for _ in range(buffers)]
    to_t = lambda a: torch.from_numpy(  # noqa: E731
        np.array(a.astype(jnp.float32))).to(torch.bfloat16)
    return x, ws, to_t(x), [to_t(w) for w in ws]


@pytest.mark.parametrize("buffers", [1, 2, 3])
def test_plain_matches_tool_kernel(buffers):
    x, ws, tx, tws = _inputs(buffers)
    want = np.asarray(_pinned_call(x, ws).astype(jnp.float32))
    got = K.multi_product_plain(tx, tws)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (R, H)
    scale = np.abs(want).max()
    ulp = 2.0 ** (np.floor(np.log2(scale)) - 7)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= ulp, (err, ulp)
    # on a CPU tensor the wrapper runs the plain version, uncounted
    n = K.multi_product.launches
    assert torch.equal(K.multi_product(tx, tws), got)
    assert K.multi_product.launches == n


def test_wrapper_refuses_ragged_rows_and_bad_buffers():
    _, _, tx, tws = _inputs(2)
    with pytest.raises(ValueError, match="256-row tile"):
        K.multi_product(tx[:300], tws)
    with pytest.raises(ValueError, match="weight buffers"):
        K.multi_product(tx, [])
    with pytest.raises(ValueError, match="weight buffers"):
        K.multi_product(tx, tws * 5)
    with pytest.raises(ValueError, match="every buffer"):
        K.multi_product(tx, [tws[0], tws[1][:, :128]])


def test_tool_cli_pinned_bisect_on_cpu(capsys):
    argv = ["--case", "pinned_bisect", "--device", "cpu", "--no_encoder",
            "--pinned_mb", "0.25"]
    assert tool.main(argv + ["--i-accept-worker-loss"]) == 0
    out = capsys.readouterr().out
    assert "2 buffers x (512,128) bf16" in out
    assert "pinned_bisect survived:" in out and "no crash this run" in out
    with pytest.raises(SystemExit, match="refusing"):
        tool.main(argv)


def test_tool_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is available")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tool.main(["--case", "pinned_bisect", "--i-accept-worker-loss"])


def test_tool_sort_topk_and_pallas_lf_small_on_cpu():
    """The two cases at small sizes: sort_topk's loop through the port's
    exact top-k against a plain loop on ``stable_top_k`` (the
    ``jax.lax.top_k`` order), pallas_lf's WKV output finite and equal to
    the chunked plain version on the same RandomState(0) data."""
    from paper_accurate_fast_cheap_tpu_torch.ops.topk import stable_top_k
    from paper_accurate_fast_cheap_tpu_torch.ops.wkv6 import wkv6_chunked

    total, shape = tool.case_sort_topk(B=2, BEAM=4, V=300, STEPS=6,
                                       device="cpu")
    carry = torch.randn(2, 4, 300, generator=torch.Generator().manual_seed(0))
    for _ in range(6):
        vals, _ = stable_top_k(carry, 4)
        carry = carry * 0.999 + vals.sum(-1, keepdim=True) * 1e-6
    assert shape == (6, 2, 4, 4)
    np.testing.assert_allclose(total, float(carry.sum()), rtol=1e-6)

    y = tool.case_pallas_lf(B=1, T=300, H=2, N=16, device="cpu")
    rng = np.random.RandomState(0)
    mk = lambda s: torch.from_numpy(  # noqa: E731
        (rng.randn(1, 300, 2, 16) * s).astype(np.float32))
    r, k, v = mk(1.0), mk(0.5), mk(4.0)
    w = torch.from_numpy(-np.abs(rng.randn(1, 300, 2, 16) * 2.0 + 2.0)
                         .astype(np.float32))
    u = torch.from_numpy((rng.randn(2, 16) * 0.1).astype(np.float32))
    assert np.isfinite(y)
    np.testing.assert_allclose(y, float(wkv6_chunked(r, k, v, w, u).sum()),
                               rtol=1e-6)


def test_kernel_shape_limits():
    """The kernel's TMA loads need 16-byte rows: D and H multiples of 8,
    checked by a plain function before any launch; on the CPU the plain
    version takes any width."""
    K.check_kernel_shape(512, 5120)
    K.check_kernel_shape(8, 8)
    for D, H in ((500, 1280), (512, 1284)):
        with pytest.raises(K.cuda_lib.KernelError, match="multiples of 8"):
            K.check_kernel_shape(D, H)
    x = torch.ones(256, 12, dtype=torch.bfloat16)
    w = torch.ones(12, 20, dtype=torch.bfloat16)
    assert torch.equal(K.multi_product(x, [w]), K.multi_product_plain(x, [w]))
