"""``gradient_checkpointing`` in the port's encoder (``torch.utils.checkpoint``
per block), against the same step without it and against JAX's ``nn.remat``.

A 2-block bi-RWKV encoder and a direction-dropout (``dirdrop``) one, width
64 (2 heads of 32), dropout 0, f32, on the CPU.  The loss is a fixed
random projection of the encoder output over the valid frames.

- Port, checkpointing on against off: the same torch seed before each
  step, so direction dropout draws the same passes; the recomputation in
  the backward replays those draws (the checkpoint restores the host RNG
  state).  Gradients equal within 1e-5 of their scale, and the WKV6
  forward (K1 on the card) runs twice per pass with checkpointing: once
  in the forward, once in the recomputation.
- Port with checkpointing against JAX's remat on the same weights: for
  ``dirdrop`` the port takes the passes JAX drew (JAX draws with
  ``jax.random``, whose bits the port cannot reproduce).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paper_accurate_fast_cheap_tpu.models import conformer as j_conformer
from paper_accurate_fast_cheap_tpu.models import factory as j_factory
from paper_accurate_fast_cheap_tpu_torch.convert import state_dict_from_jax
from paper_accurate_fast_cheap_tpu_torch.models import conformer as t_conformer
from paper_accurate_fast_cheap_tpu_torch.models import factory as t_factory
from paper_accurate_fast_cheap_tpu_torch.models import rwkv as t_rwkv
from paper_accurate_fast_cheap_tpu_torch.ops import wkv6_cuda

KINDS = {"bi": "rwkv_tmix60_bidirectional",
         "dirdrop": "rwkv_tmix60_dir_layer_drop"}
DROPOUT_KEY = 5


def _conf(kind: str, remat: bool) -> dict:
    return dict(output_size=64, attention_heads=2, linear_units=64,
                num_blocks=2, dropout_rate=0.0, positional_dropout_rate=0.0,
                attention_dropout_rate=0.0, input_layer="conv2d",
                pos_enc_layer_type="rel_pos", cnn_module_kernel=7,
                selfattention_layer_type=KINDS[kind],
                rwkv_do_bfloat16=False, gradient_checkpointing=remat)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(0)
    feats = rng.randn(2, 46, 80).astype(np.float32)
    lens = np.asarray([46, 33], np.int32)
    T = ((feats.shape[1] - 1) // 2 - 1) // 2          # conv2d /4: 10 frames
    proj = rng.randn(2, T, 64).astype(np.float32)
    return feats, lens, proj


def _jax_loss(jenc, proj):
    def loss(p, f, l, key):
        out, olens = jenc.apply(p, f, l, deterministic=False,
                                rngs={"dropout": key})
        valid = jnp.arange(out.shape[1])[None, :] < olens[:, None]
        return jnp.sum(jnp.where(valid[..., None], out * proj, 0.0)), out
    return loss


@pytest.fixture(scope="module")
def jax_runs(inputs):
    """Per kind: JAX's weights (one init: the two kinds have the same
    parameters), its remat gradients and output, and the passes its
    direction dropout drew (keep R2L per layer)."""
    feats, lens, proj = inputs
    f, l = jnp.asarray(feats), jnp.asarray(lens)
    key = jax.random.PRNGKey(DROPOUT_KEY)
    params = None
    out = {}
    for kind in KINDS:
        jenc = j_conformer.ConformerEncoder(
            **j_factory.encoder_conf_from_yaml(_conf(kind, True)))
        if params is None:
            params = jax.jit(jenc.init)(jax.random.PRNGKey(1), f, l)
        (_, y), grads = jax.jit(jax.value_and_grad(
            _jax_loss(jenc, jnp.asarray(proj)), has_aux=True))(
            params, f, l, key)
        keeps = []
        if kind == "dirdrop":
            # the draws, returned by a forward without remat on the key
            plain = j_conformer.ConformerEncoder(
                **j_factory.encoder_conf_from_yaml(_conf(kind, False)))
            bern, drawn = jax.random.bernoulli, []

            def spy(*a, **k):
                drawn.append(bern(*a, **k))
                return drawn[-1]

            def draws(p, f, l, key):
                plain.apply(p, f, l, deterministic=False,
                            rngs={"dropout": key})
                return list(drawn)

            jax.random.bernoulli = spy
            try:
                keeps = [bool(b) for b in jax.jit(draws)(params, f, l, key)]
            finally:
                jax.random.bernoulli = bern
        out[kind] = (jax.tree.map(np.array, params),
                     state_dict_from_jax(jax.tree.map(np.array, grads)),
                     np.asarray(y), keeps)
    return out


def _port_step(kind, remat, params, inputs, seed=0):
    """One loss + backward of the port's encoder; returns (output, grads,
    WKV6 forward calls)."""
    feats, lens, proj = inputs
    enc = t_conformer.ConformerEncoder(
        **t_factory.encoder_conf_from_yaml(_conf(kind, remat)))
    enc.load_state_dict(state_dict_from_jax(params))
    enc.train()
    calls = [0]
    fwd = wkv6_cuda._forward

    def counted(*a, **k):
        calls[0] += 1
        return fwd(*a, **k)

    wkv6_cuda._forward = counted
    try:
        torch.manual_seed(seed)
        y, ylens = enc(torch.from_numpy(feats), torch.from_numpy(lens))
        valid = (torch.arange(y.shape[1])[None, :] < ylens[:, None])
        loss = torch.sum(torch.where(valid[..., None],
                                     y * torch.from_numpy(proj), 0.0))
        loss.backward()
    finally:
        wkv6_cuda._forward = fwd
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in enc.named_parameters()}
    return y.detach().numpy(), grads, calls[0]


def _assert_grads_close(got, want):
    assert set(got) == set(want)
    for name in want:
        w = np.asarray(want[name])
        scale = max(float(np.abs(w).max()), 1.0)
        np.testing.assert_allclose(got[name].numpy(), w, atol=1e-5 * scale,
                                   err_msg=name)


@pytest.mark.parametrize("kind", list(KINDS))
def test_checkpointing_matches_plain_backward(jax_runs, inputs, kind):
    params = jax_runs[kind][0]
    counts = set()
    # seeds 5 and 8 drop R2L in one block (layer 0, layer 1), 0 in neither
    for seed in (0, 5, 8):
        y0, g0, n0 = _port_step(kind, False, params, inputs, seed)
        y1, g1, n1 = _port_step(kind, True, params, inputs, seed)
        np.testing.assert_array_equal(y1, y0)
        _assert_grads_close(g1, {k: v.numpy() for k, v in g0.items()})
        # K1 runs in the forward and again in the backward's recomputation
        assert n1 == 2 * n0
        counts.add(n0)
    # 2 blocks x 2 directions, less the dropped R2L passes
    assert counts == ({4} if kind == "bi" else {3, 4})


@pytest.mark.parametrize("kind", list(KINDS))
def test_checkpointing_matches_jax_remat(jax_runs, inputs, kind,
                                         monkeypatch):
    params, want_grads, want_y, keeps = jax_runs[kind]
    if kind == "dirdrop":
        assert keeps == [True, False]      # one layer keeps R2L, one not
        passes = t_rwkv.RWKVAttention._passes

        def jax_passes(self):
            return (True, keeps[self.layer_id]) if self.training \
                else passes(self)

        monkeypatch.setattr(t_rwkv.RWKVAttention, "_passes", jax_passes)
    y, grads, _ = _port_step(kind, True, params, inputs)
    valid = (np.arange(y.shape[1])[None, :]
             < np.asarray([10, (((33 - 1) // 2 - 1) // 2)])[:, None])
    np.testing.assert_allclose(y[valid], want_y[valid], atol=1e-5)
    _assert_grads_close(grads, want_grads)
