"""Chunk masks in the port's full encoder forward, against the JAX package.

``utils/masks`` against JAX's for several (T, chunk, nleft), the dynamic
chunk with JAX's draw fixed (JAX draws with ``jax.random``, whose bits the
port cannot reproduce, so the port takes the same ``(chunk, nleft)``).
Then a 2-block rel-pos MHA conformer encoder and its LCA twin (context 3,
one global token; width 32, 2 heads, dropout 0) in f32 against JAX's on
the same weights: in eval with ``static_chunk_size=4``, with
``decoding_chunk_size=4, num_decoding_left_chunks=1``, and in the training
forward with ``use_dynamic_chunk`` on one fixed draw.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paper_accurate_fast_cheap_tpu.models import conformer as j_conformer
from paper_accurate_fast_cheap_tpu.models import factory as j_factory
from paper_accurate_fast_cheap_tpu.utils import masks as j_masks
from paper_accurate_fast_cheap_tpu_torch.convert import state_dict_from_jax
from paper_accurate_fast_cheap_tpu_torch.models import conformer as t_conformer
from paper_accurate_fast_cheap_tpu_torch.models import factory as t_factory
from paper_accurate_fast_cheap_tpu_torch.utils import masks as t_masks


@pytest.mark.parametrize("T,chunk,nleft", [
    (13, 4, -1), (13, 4, 0), (13, 4, 1), (16, 1, 2), (7, 7, -1), (9, 20, 1)])
def test_chunk_masks_match_jax(T, chunk, nleft):
    np.testing.assert_array_equal(
        t_masks.subsequent_chunk_mask(T, chunk, nleft).numpy(),
        np.asarray(j_masks.subsequent_chunk_mask(T, chunk, nleft)))
    np.testing.assert_array_equal(
        t_masks.causal_or_lookahead_mask(T, chunk, nleft).numpy(),
        np.asarray(j_masks.causal_or_lookahead_mask(T, chunk, nleft)))
    lens = np.asarray([T, max(T - 3, 1)])
    pad = j_masks.make_pad_mask(jnp.asarray(lens), T)
    tpad = t_masks.make_pad_mask(torch.from_numpy(lens), T)
    for dcs, static in ((0, chunk), (chunk, 3), (chunk, 0), (0, 0), (-1, 0)):
        np.testing.assert_array_equal(
            t_masks.add_optional_chunk_mask(tpad, False, False, max(dcs, 0),
                                            static, nleft).numpy(),
            np.asarray(j_masks.add_optional_chunk_mask(
                pad, False, False, max(dcs, 0), static, nleft)))


def _jax_draw(key, T, dynamic_left, cap=25):
    """The (chunk, nleft) JAX's ``add_optional_chunk_mask`` draws."""
    k1, k2, k3 = jax.random.split(key, 3)
    full = bool(jax.random.bernoulli(k1, 0.5))
    chunk = T if full else int(jax.random.randint(k2, (), 1, cap + 1))
    nleft = -1
    if dynamic_left:
        nleft = int(jax.random.randint(k3, (), 0, max(T // chunk - 1, 1)))
    return chunk, nleft


def test_dynamic_chunk_mask_matches_jax_on_its_draw(monkeypatch):
    T = 40
    lens = np.asarray([40, 31, 7])
    pad = j_masks.make_pad_mask(jnp.asarray(lens), T)
    tpad = t_masks.make_pad_mask(torch.from_numpy(lens), T)
    fulls = 0
    for seed in range(8):
        key = jax.random.PRNGKey(seed)
        for left in (False, True):
            draw = _jax_draw(key, T, left)
            fulls += draw[0] == T
            want = j_masks.add_optional_chunk_mask(pad, True, left, 0, 0, -1,
                                                   rng=key)
            monkeypatch.setattr(t_masks, "draw_dynamic_chunk",
                                lambda *a, d=draw: d)
            got = t_masks.add_optional_chunk_mask(
                tpad, True, left, 0, 0, -1, generator=torch.Generator())
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < fulls < 16


def test_dynamic_chunk_draw_distribution():
    g = torch.Generator().manual_seed(0)
    draws = [t_masks.draw_dynamic_chunk(40, True, g) for _ in range(400)]
    full = [c for c, _ in draws if c == 40]
    assert 150 < len(full) < 250
    part = [(c, n) for c, n in draws if c != 40]
    assert {c for c, _ in part} <= set(range(1, 26))
    assert all(0 <= n < max(40 // c - 1, 1) for c, n in part)
    assert len({c for c, _ in part}) > 15
    # the same generator state gives the same draw; no left chunk is -1
    g1, g2 = (torch.Generator().manual_seed(3) for _ in range(2))
    assert (t_masks.draw_dynamic_chunk(40, False, g1)
            == t_masks.draw_dynamic_chunk(40, False, g2))
    assert t_masks.draw_dynamic_chunk(40, False, g1)[1] == -1


def _enc_conf(kind: str, **chunk):
    conf = dict(output_size=32, attention_heads=2, linear_units=64,
                num_blocks=2, dropout_rate=0.0, positional_dropout_rate=0.0,
                attention_dropout_rate=0.0, input_layer="conv2d",
                pos_enc_layer_type="rel_pos", cnn_module_kernel=7,
                selfattention_layer_type=kind, **chunk)
    if kind == "limited_rel_selfattn":
        conf.update(att_context_size=[3, 3], global_tokens=1)
    return conf


@pytest.fixture(scope="module")
def encoders():
    """JAX's rel-pos MHA encoder and its weights (numpy), once; LCA has the
    same parameters under its own attention names."""
    rng = np.random.RandomState(0)
    feats = rng.randn(2, 70, 80).astype(np.float32)
    lens = np.asarray([70, 51], np.int32)
    jenc = j_conformer.ConformerEncoder(
        **j_factory.encoder_conf_from_yaml(_enc_conf("rel_selfattn")))
    params = jax.tree.map(np.array, jax.jit(jenc.init)(
        jax.random.PRNGKey(1), jnp.asarray(feats), jnp.asarray(lens)))
    return feats, lens, params


def _pair(encoders, kind, **chunk):
    feats, lens, params = encoders
    conf = _enc_conf(kind, **chunk)
    jenc = j_conformer.ConformerEncoder(
        **j_factory.encoder_conf_from_yaml(conf))
    tenc = t_conformer.ConformerEncoder(
        **t_factory.encoder_conf_from_yaml(conf))
    if kind == "limited_rel_selfattn":
        params = {"params": {
            k.replace("RelPositionMultiHeadedAttention_",
                      "LimitedRelPositionAttention_"): v
            for k, v in params["params"].items()}}
    tenc.load_state_dict(state_dict_from_jax(params))
    return jenc, tenc, params, feats, lens


KINDS = ["rel_selfattn", "limited_rel_selfattn"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("chunk,dcs,nleft", [(4, 0, -1), (0, 4, 1)])
def test_encoder_eval_chunk_mask_matches_jax(encoders, kind, chunk, dcs,
                                             nleft):
    jenc, tenc, params, feats, lens = _pair(encoders, kind,
                                            static_chunk_size=chunk)
    want, wlens = jax.jit(lambda p, f, l: jenc.apply(
        p, f, l, dcs, nleft, deterministic=True))(
        params, jnp.asarray(feats), jnp.asarray(lens))
    tenc.eval()
    with torch.no_grad():
        got, glens = tenc(torch.from_numpy(feats), torch.from_numpy(lens),
                          dcs, nleft)
        tenc.static_chunk_size = 0
        full, _ = tenc(torch.from_numpy(feats), torch.from_numpy(lens))
    np.testing.assert_array_equal(glens.numpy(), np.asarray(wlens))
    valid = np.arange(got.shape[1])[None, :] < np.asarray(wlens)[:, None]
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid],
                               atol=1e-5)
    # the mask changes the output (not a trivially unmasked pass)
    assert np.abs(got.numpy() - full.numpy())[valid].max() > 1e-3


@pytest.mark.parametrize("kind", KINDS)
def test_encoder_training_dynamic_chunk_matches_jax(encoders, kind,
                                                    monkeypatch):
    jenc, tenc, params, feats, lens = _pair(
        encoders, kind, use_dynamic_chunk=True, use_dynamic_left_chunk=True)
    # flax derives the module's "chunk" key from the stream: catch the key
    # JAX's mask draws from
    seen = []
    draw_mask = j_masks.add_optional_chunk_mask

    def spy(*args, rng=None, **kw):
        seen.append(rng)
        return draw_mask(*args, rng=rng, **kw)

    monkeypatch.setattr(j_conformer.mask_utils, "add_optional_chunk_mask",
                        spy)
    run = jax.jit(lambda p, f, l, k: (jenc.apply(
        p, f, l, deterministic=False,
        rngs={"chunk": k, "dropout": jax.random.PRNGKey(9)})[0], seen[-1]))
    T = ((feats.shape[1] - 1) // 2 - 1) // 2   # conv2d /4 frames: 16
    for seed in range(20):
        want, key = run(params, jnp.asarray(feats), jnp.asarray(lens),
                        jax.random.PRNGKey(seed))
        draw = _jax_draw(key, T, True)
        if draw[0] < T // 2:
            break
    # the port's forward takes JAX's draw (its own is from chunk_generator)
    monkeypatch.setattr(t_masks, "draw_dynamic_chunk", lambda *a: draw)
    tenc.train()
    got, glens = tenc(torch.from_numpy(feats), torch.from_numpy(lens))
    valid = np.arange(T)[None, :] < glens.numpy()[:, None]
    np.testing.assert_allclose(got.detach().numpy()[valid],
                               np.asarray(want)[valid], atol=1e-5)
    # the eval forward ignores the dynamic chunk
    tenc.eval()
    with torch.no_grad():
        full, _ = tenc(torch.from_numpy(feats), torch.from_numpy(lens))
    assert np.abs(got.detach().numpy() - full.numpy())[valid].max() > 1e-3
