"""The port's Mamba-2 modules (``models/mamba.py``) against the JAX package's.

Modules (f32, within 1e-5 absolute plus 1e-5 relative: f32 sums of another
order), weights carried by ``convert.state_dict_from_jax``:
``Mamba2Block`` (also its streaming form: the conv and SSD state carried
over a split, against JAX's states), ``MambaAttention`` uni and bi with
padded lengths.  In bf16 weights and input, the block within a stated
tolerance (dt and A rounded to bf16 where JAX rounds them).

Transducers (2 blocks, d = 32, vocab 40, f32): the uni and bi Mamba-2
transducers, encoder and CTC within 1e-4, device-beam tokens identical.
Training: ``train_bench`` on a tiny bi Mamba-2 transducer runs the step
through the SSD Function (mixed precision, the CPU).
"""
import copy
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paper_accurate_fast_cheap_tpu.decode import rnnt_search as j_search
from paper_accurate_fast_cheap_tpu.models import factory as j_factory
from paper_accurate_fast_cheap_tpu.models import mamba as j_mamba
from paper_accurate_fast_cheap_tpu_torch.bin import train_bench
from paper_accurate_fast_cheap_tpu_torch.convert import state_dict_from_jax
from paper_accurate_fast_cheap_tpu_torch.decode import rnnt_search as t_search
from paper_accurate_fast_cheap_tpu_torch.models import factory as t_factory
from paper_accurate_fast_cheap_tpu_torch.models import mamba as t_mamba

D, HS, N, L = 32, 8, 16, 8          # d_model, headdim, d_state, chunk
VOCAB, BEAM = 40, 4
TOL = dict(rtol=1e-5, atol=1e-5)


def _perturbed(params, seed):
    """The JAX init with its D skip, conv bias and norm scale moved off
    their constant inits, so their layouts matter (numpy tree)."""
    params = jax.tree.map(np.array, params)
    rng = np.random.RandomState(seed)

    def walk(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v)
            elif k in ("D", "scale") or (k == "bias" and v.ndim == 1):
                tree[k] = (v + rng.randn(*v.shape) * 0.3).astype(np.float32)
    walk(params["params"])
    return params


def _load(tmod, params):
    tmod.load_state_dict(state_dict_from_jax(params))
    return tmod.eval()


def _x(seed, T=23, B=2):
    return np.random.RandomState(seed).randn(B, T, D).astype(np.float32)


@pytest.fixture(scope="module")
def block():
    jmod = j_mamba.Mamba2Block(d_model=D, headdim=HS, d_state=N,
                               chunk_size=L)
    params = _perturbed(jmod.init(jax.random.PRNGKey(0),
                                  jnp.zeros((1, 4, D))), 1)
    return jmod, params, _load(
        t_mamba.Mamba2Block(D, d_state=N, headdim=HS, chunk_size=L),
        params)


def test_block_matches_jax(block):
    jmod, params, tmod = block
    x = _x(0)
    want = np.asarray(jmod.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_block_streaming_state_matches_jax(block):
    """Split at 10 of 23: the conv cache holds the last d_conv - 1
    pre-activation inputs, the SSD state (B, H, N, P); both halves and
    both states equal JAX's, and the halves equal the full forward."""
    jmod, params, tmod = block
    x = _x(1)
    j1, js = jmod.apply(params, jnp.asarray(x[:, :10]), None, True)
    j2, js2 = jmod.apply(params, jnp.asarray(x[:, 10:]), js, True)
    with torch.no_grad():
        t1, ts = tmod(torch.from_numpy(x[:, :10]), return_state=True)
        t2, ts2 = tmod(torch.from_numpy(x[:, 10:]), state=ts,
                       return_state=True)
        full = tmod(torch.from_numpy(x)).numpy()
    for got, want in ((t1, j1), (t2, j2), (ts["conv"], js["conv"]),
                      (ts2["ssd"], js2["ssd"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert tuple(ts["conv"].shape) == (2, 3, 2 * D + 2 * N)
    assert tuple(ts["ssd"].shape) == (2, 2 * D // HS, N, HS)
    np.testing.assert_allclose(torch.cat([t1, t2], 1).numpy(), full,
                               rtol=1e-4, atol=1e-4)


def test_block_bf16_matches_jax(block):
    """Weights and input in bf16 in both packages: dt and A are rounded to
    bf16 before the SSD lifts them to f32 (in both), and the chunk sums of
    the cumulative-sum segsum lose bits when |dt A| is large over a chunk.
    Held within 5e-2 absolute on an output scale of ~3 (2^-8 rounding
    through the block's products).  Measured: 3.1e-2, the size of JAX's
    own bf16 output against its f32 output (3.2e-2)."""
    jmod, params, tmod = block
    x = _x(2)
    bf = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    want = np.asarray(jmod.apply(bf, jnp.asarray(x, jnp.bfloat16)
                                 ).astype(jnp.float32))
    tm = copy.deepcopy(tmod).to(torch.bfloat16)
    with torch.no_grad():
        got = tm(torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=5e-2)


@pytest.mark.parametrize("direction", ["uni", "bi"])
def test_attention_matches_jax_with_padding(direction):
    jmod = j_mamba.MambaAttention(head_size=HS, d_model=D, n_layers=1,
                                  direction=direction, d_state=N,
                                  chunk_size=L)
    lens = np.asarray([23, 14], np.int32)
    params = _perturbed(jmod.init(jax.random.PRNGKey(3), jnp.zeros((1, 4, D)),
                                  lengths=jnp.asarray([4])), 4)
    tmod = _load(t_mamba.MambaAttention(HS, D, direction=direction,
                                        d_state=N, chunk_size=L), params)
    x = _x(5)
    want = np.asarray(jmod.apply(params, jnp.asarray(x),
                                 lengths=jnp.asarray(lens)))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), lengths=torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if direction == "bi":
        with pytest.raises(ValueError, match="uni"):
            tmod(torch.from_numpy(x), return_state=True)


def _config(direction: str) -> dict:
    return {
        "model": "transducer", "encoder": "conformer",
        "encoder_conf": dict(
            output_size=D, attention_heads=2, linear_units=64, num_blocks=2,
            cnn_module_kernel=15, selfattention_layer_type="mamba_att",
            rnn_att_version="mamba2", rnn_att_direction=direction),
        "predictor": "rnn",
        "predictor_conf": {"embed_size": D, "output_size": D,
                           "hidden_size": D, "num_layers": 1},
        "joint_conf": {"join_dim": D}, "decoder": None,
        "model_conf": {"ctc_weight": 0.3, "transducer_weight": 0.7,
                       "attention_weight": 0.0},
    }


@pytest.mark.parametrize("direction", ["uni", "bi"])
def test_transducer_matches_jax(direction):
    config = _config(direction)
    model, _ = j_factory.init_model(config, VOCAB, 80)
    params = _perturbed(model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 80)), jnp.asarray([64]),
        jnp.ones((1, 4), jnp.int32), jnp.asarray([4])), 6)
    params["params"]["joint"]["ffn_out"]["bias"][0] += 1.0
    params["params"]["ctc"]["ctc_lo"]["bias"][0] += 1.0
    tmodel, _ = t_factory.init_model(config, VOCAB, 80, device="cpu")
    _load(tmodel, params)
    rng = np.random.RandomState(4)
    feats = rng.randn(2, 120, 80).astype(np.float32)
    lens = np.asarray([120, 90], np.int32)

    jp = jax.tree.map(jnp.asarray, params)
    j_enc, j_el = jax.jit(functools.partial(
        model.apply, method=model.forward_encoder))(
            jp, jnp.asarray(feats), jnp.asarray(lens))
    j_ctc = model.apply(jp, j_enc, method=model.ctc_logprobs)
    j_res = j_search.rnnt_beam_search(
        *j_search.make_transducer_step_fns(model, jp), j_enc, j_el, j_ctc,
        beam_size=BEAM, ctc_weight=0.3, transducer_weight=0.7,
        impl="device", params=jp)
    t_enc, t_el = tmodel.forward_encoder(torch.from_numpy(feats),
                                         torch.from_numpy(lens))
    t_ctc = tmodel.ctc_logprobs(t_enc)
    t_res = t_search.rnnt_beam_search(
        *t_search.make_transducer_step_fns(tmodel), t_enc, t_el, t_ctc,
        beam_size=BEAM, ctc_weight=0.3, transducer_weight=0.7)
    np.testing.assert_allclose(t_enc.numpy(), np.asarray(j_enc), atol=1e-4)
    np.testing.assert_allclose(t_ctc.numpy(), np.asarray(j_ctc), atol=1e-4)
    assert any(r.tokens for r in j_res)
    for a, b in zip(j_res, t_res):
        assert a.tokens == b.tokens


def test_train_bench_runs_the_mamba_step(tmp_path):
    """One tiny bi Mamba-2 transducer step through ``train_bench`` (mixed
    precision): the SSD Function's analytic backward runs and the loss is
    finite."""
    cfg = dict(_config("bi"), vocab_size_for_bench=VOCAB)
    cfg["encoder_conf"] = dict(cfg["encoder_conf"], num_blocks=1)
    path = tmp_path / "mamba.json"
    path.write_text(json.dumps(cfg))
    out = tmp_path / "train.bench"
    assert train_bench.main([
        "--config", str(path), "--batch_size", "2", "--frames", "120",
        "--label_len", "6", "--warmup", "1", "--iters", "1", "--output",
        str(out), "--mixed_precision", "--device", "cpu"]) == 0
    rep = dict(ln.split(None, 1) for ln in out.read_text().splitlines())
    assert np.isfinite(float(rep["final_loss"]))
