"""The port's encoder attention types against the JAX package.

Modules (f32, within 1e-5): ``selfattn``, ``rel_selfattn`` and
``espnet_rel_selfattn`` (also with 2T-1 positions, its rel_shift against
JAX's), and LCA over a grid of contexts, lengths and global tokens,
weights carried by ``convert.state_dict_from_jax``.  A property: LCA whose
window covers the sequence, without global tokens, is the rel-pos MHA.

Transducers (2 blocks, d = 32, vocab 40, f32): the MHA baseline, LCA with
a global token, and direction-dropout RWKV at eval (default, with
``bidirectional_layers`` and with ``alt_decoding``; two JAX inits, LCA
taking the MHA's weights): encoder and CTC within 1e-4, device-beam
tokens identical and n-best scores within 1e-4 relative.  The MHA transducer also in bf16 weights and
features at a stated tolerance.  Direction dropout in ``.train()`` is
checked by the frequencies of the passes it runs (JAX's dropout bits cannot
be drawn by torch).
"""
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paper_accurate_fast_cheap_tpu.decode import rnnt_search as j_search
from paper_accurate_fast_cheap_tpu.models import attention as j_att
from paper_accurate_fast_cheap_tpu.models import factory as j_factory
from paper_accurate_fast_cheap_tpu.models.lca import (
    LimitedRelPositionAttention as JLCA)
from paper_accurate_fast_cheap_tpu_torch.convert import state_dict_from_jax
from paper_accurate_fast_cheap_tpu_torch.decode import rnnt_search as t_search
from paper_accurate_fast_cheap_tpu_torch.models import attention as t_att
from paper_accurate_fast_cheap_tpu_torch.models import factory as t_factory
from paper_accurate_fast_cheap_tpu_torch.models.conformer import (
    ConformerEncoder)
from paper_accurate_fast_cheap_tpu_torch.models.lca import (
    LimitedRelPositionAttention as TLCA)
from paper_accurate_fast_cheap_tpu_torch.models.rwkv import RWKVAttention

D, HEADS, VOCAB, BEAM = 32, 4, 40, 4
_MODULES = {
    "selfattn": (j_att.MultiHeadedAttention, t_att.MultiHeadedAttention),
    "rel_selfattn": (j_att.RelPositionMultiHeadedAttention,
                     t_att.RelPositionMultiHeadedAttention),
    "espnet_rel_selfattn": (j_att.ESPnetRelPositionMultiHeadedAttention,
                            t_att.ESPnetRelPositionMultiHeadedAttention),
}


@pytest.fixture(scope="module")
def rel_params():
    """One JAX init of the rel-pos MHA's weights (numpy): the MHA types and
    LCA share them (``selfattn`` takes the subset it has)."""
    x = jnp.zeros((1, 4, D))
    params = j_att.RelPositionMultiHeadedAttention(
        heads=HEADS, d_model=D).init(jax.random.PRNGKey(0), x, x, None, x)
    params = jax.tree.map(np.array, params)
    # non-zero biases, so their layout matters
    rng = np.random.RandomState(5)
    for name, leaf in params["params"].items():
        if "bias" in leaf:
            leaf["bias"] = rng.randn(D).astype(np.float32) * 0.1
    return params


def _carry(params, jmod, tmod, *args):
    """The JAX module's output (numpy) on ``args`` and the port's module
    with the same weights."""
    names = set(tmod.state_dict())
    sd = {k: v for k, v in state_dict_from_jax(params).items()
          if k in names}
    tmod.load_state_dict(sd)
    params = {"params": {k: v for k, v in params["params"].items()
                         if any(n.split(".")[0] == k for n in names)}}
    return np.asarray(jmod.apply(params, *map(jnp.asarray, args))), tmod


def _inputs(seed, T, lengths, n_pos=None):
    rng = np.random.RandomState(seed)
    x = rng.randn(len(lengths), T, D).astype(np.float32)
    mask = (np.arange(T)[None, :] < np.asarray(lengths)[:, None])[:, None]
    pos = (rng.randn(1, n_pos or T, D) * 0.5).astype(np.float32)
    return x, mask, pos


def _port(tmod, x, mask, pos):
    with torch.no_grad():
        return tmod(*(torch.from_numpy(a) for a in (x, x, mask, pos))).numpy()


@pytest.mark.parametrize("kind,n_pos", [
    ("selfattn", None), ("rel_selfattn", None),
    ("espnet_rel_selfattn", None), ("espnet_rel_selfattn", 21)])
def test_mha_module_matches_jax(rel_params, kind, n_pos):
    x, mask, pos = _inputs(0, 11, [11, 7], n_pos)
    jcls, tcls = _MODULES[kind]
    want, tmod = _carry(rel_params, jcls(heads=HEADS, d_model=D),
                        tcls(HEADS, D), x, x, mask, pos)
    np.testing.assert_allclose(_port(tmod, x, mask, pos), want, atol=1e-5)


def test_rel_shift_matches_jax():
    x = np.random.RandomState(1).randn(2, 3, 5, 9).astype(np.float32)
    want = j_att.ESPnetRelPositionMultiHeadedAttention.rel_shift(
        jnp.asarray(x))
    np.testing.assert_array_equal(
        t_att.rel_shift(torch.from_numpy(x)).numpy(), np.asarray(want))


@pytest.mark.parametrize("left,right,T,lengths,G", [
    (4, 4, 16, [16, 16], 0),     # left = right, T a multiple of W
    (3, 5, 13, [13, 13], 0),     # left != right, T not a multiple of W
    (4, 4, 13, [13, 10], 2),     # global tokens, spacing 3
    (4, 2, 19, [19, 6], 0),      # a whole band of the short row masked
    (4, 2, 19, [19, 6], 2),
])
def test_lca_module_matches_jax(rel_params, left, right, T, lengths, G):
    x, mask, pos = _inputs(2, T, lengths)
    kw = dict(context_size=(left, right), global_tokens=G,
              global_tokens_spacing=3)
    want, tmod = _carry(rel_params, JLCA(heads=HEADS, d_model=D, **kw),
                        TLCA(HEADS, D, **kw), x, x, mask, pos)
    np.testing.assert_allclose(_port(tmod, x, mask, pos), want, atol=1e-5)


def test_lca_full_window_is_rel_mha():
    """W >= T and no global tokens: every valid key is in the band."""
    x, mask, pos = _inputs(3, 13, [13, 9])
    torch.manual_seed(0)
    mha = t_att.RelPositionMultiHeadedAttention(HEADS, D)
    torch.nn.init.normal_(mha.pos_bias_u)
    torch.nn.init.normal_(mha.pos_bias_v)
    lca = TLCA(HEADS, D, context_size=(16, 16))
    lca.load_state_dict(mha.state_dict())
    np.testing.assert_allclose(_port(lca, x, mask, pos),
                               _port(mha, x, mask, pos), atol=1e-5)


def _config(attn: str, **enc) -> dict:
    heads = 2 if attn.startswith("rwkv") else HEADS
    return {
        "model": "transducer", "encoder": "conformer",
        "encoder_conf": dict(
            output_size=D, attention_heads=heads, linear_units=64,
            num_blocks=2, cnn_module_kernel=15,
            selfattention_layer_type=attn, rwkv_do_bfloat16=False, **enc),
        "predictor": "rnn",
        "predictor_conf": {"embed_size": D, "output_size": D,
                           "hidden_size": D, "num_layers": 1},
        "joint_conf": {"join_dim": D}, "decoder": None,
        "model_conf": {"ctc_weight": 0.3, "transducer_weight": 0.7,
                       "attention_weight": 0.0},
    }


FAMILIES = {
    "mha": _config("rel_selfattn"),
    "lca_gt": _config("limited_rel_selfattn", att_context_size=[4, 4],
                      global_tokens=1),
    "dirdrop_both": _config("rwkv_tmix60_dir_layer_drop_both"),
}
# the direction-dropout encoder's eval controls, through rwkv_conf
CONTROLS = {"default": {}, "bidirectional_layers": {
    "bidirectional_layers": (1,)}, "alt_decoding": {"alt_decoding": True}}


def _feats():
    rng = np.random.RandomState(4)
    feats = rng.randn(2, 120, 80).astype(np.float32)
    return feats, np.asarray([120, 90], np.int32)


def _decode_jax(model, params, feats, lens):
    enc, elens = jax.jit(functools.partial(
        model.apply, method=model.forward_encoder))(
            params, jnp.asarray(feats), jnp.asarray(lens))
    ctc = model.apply(params, enc, method=model.ctc_logprobs)
    res = j_search.rnnt_beam_search(
        *j_search.make_transducer_step_fns(model, params), enc, elens, ctc,
        beam_size=BEAM, ctc_weight=0.3, transducer_weight=0.7,
        impl="device", params=params)
    return np.asarray(enc), np.asarray(ctc), res


def _decode_port(tmodel, feats, lens):
    enc, elens = tmodel.forward_encoder(torch.from_numpy(feats),
                                        torch.from_numpy(lens))
    ctc = tmodel.ctc_logprobs(enc)
    res = t_search.rnnt_beam_search(
        *t_search.make_transducer_step_fns(tmodel), enc, elens, ctc,
        beam_size=BEAM, ctc_weight=0.3, transducer_weight=0.7)
    return enc.float().numpy(), ctc.float().numpy(), res


@pytest.fixture(scope="module")
def families():
    """Per family: the JAX model and weights (blank bias +1 on both heads)
    and the port's model on the same weights.  LCA takes the MHA's weights
    under its own names (the same parameters)."""
    out, mha = {}, None
    for name, config in FAMILIES.items():
        model, _ = j_factory.init_model(config, VOCAB, 80)
        if name == "lca_gt":
            enc = {k.replace("RelPositionMultiHeadedAttention_",
                             "LimitedRelPositionAttention_"): v
                   for k, v in mha["params"]["encoder"].items()}
            params = {"params": dict(mha["params"], encoder=enc)}
        else:
            params = jax.tree.map(np.array, model.init(
                jax.random.PRNGKey(0), jnp.zeros((1, 64, 80)),
                jnp.asarray([64]), jnp.ones((1, 4), jnp.int32),
                jnp.asarray([4])))
            params["params"]["joint"]["ffn_out"]["bias"][0] += 1.0
            params["params"]["ctc"]["ctc_lo"]["bias"][0] += 1.0
        if name == "mha":
            mha = params
        tmodel, _ = t_factory.init_model(config, VOCAB, 80, device="cpu")
        tmodel.load_state_dict(state_dict_from_jax(params))
        out[name] = (model, jax.tree.map(jnp.asarray, params), tmodel)
    return out


def _with_controls(model, tmodel, controls):
    """The JAX and port models with ``controls`` added to rwkv_conf."""
    conf = dict(model.encoder_conf)
    conf["rwkv_conf"] = dict(conf.get("rwkv_conf") or {}, **controls)
    tconf = t_factory.encoder_conf_from_yaml(
        FAMILIES["dirdrop_both"]["encoder_conf"], 80)
    tconf["rwkv_conf"] = dict(tconf["rwkv_conf"], **controls)
    tmodel = copy.deepcopy(tmodel)
    enc = ConformerEncoder(**tconf)
    enc.load_state_dict(tmodel.encoder.state_dict())
    tmodel.encoder = enc.eval()
    return model.clone(encoder_conf=conf), tmodel


@pytest.mark.parametrize("family,controls", [
    ("mha", "default"), ("lca_gt", "default"),
    ("dirdrop_both", "default"), ("dirdrop_both", "bidirectional_layers"),
    ("dirdrop_both", "alt_decoding")])
def test_transducer_family_matches_jax(families, family, controls):
    model, params, tmodel = families[family]
    if controls != "default":
        model, tmodel = _with_controls(model, tmodel, CONTROLS[controls])
    feats, lens = _feats()
    j_enc, j_ctc, j_res = _decode_jax(model, params, feats, lens)
    t_enc, t_ctc, t_res = _decode_port(tmodel, feats, lens)
    np.testing.assert_allclose(t_enc, j_enc, atol=1e-4)
    np.testing.assert_allclose(t_ctc, j_ctc, atol=1e-4)
    assert any(r.tokens for r in j_res)
    for a, b in zip(j_res, t_res):
        assert a.tokens == b.tokens
        assert a.nbest == b.nbest
        np.testing.assert_allclose(b.nbest_scores, a.nbest_scores,
                                   rtol=1e-4)


def test_bf16_mha_matches_jax(families):
    """Weights and features in bf16 in both packages.  The port keeps the
    rel-pos scores in bf16 where JAX promotes them to f32 (through the f32
    sinusoids), and the two round the products in other orders: encoder
    and CTC log-probs within 5e-2 absolute on an output scale of ~3 (the
    rounding of bf16, 2^-8, through two blocks).  Measured: 2.8e-2
    (encoder) and 3.2e-2 (CTC); the port's own bf16 encoder differs from
    its f32 one by 2.6e-2, so the gap is the cast's, not the order's."""
    model, params, tmodel = families["mha"]
    feats, lens = _feats()
    bf = jax.tree.map(lambda a: a.astype(jnp.bfloat16), params)
    j_enc, _ = jax.jit(functools.partial(
        model.apply, method=model.forward_encoder))(
            bf, jnp.asarray(feats, jnp.bfloat16), jnp.asarray(lens))
    j_ctc = model.apply(bf, j_enc, method=model.ctc_logprobs)
    tm = copy.deepcopy(tmodel).to(torch.bfloat16)
    t_enc, _ = tm.forward_encoder(torch.from_numpy(feats).bfloat16(),
                                  torch.from_numpy(lens))
    t_ctc = tm.ctc_logprobs(t_enc)
    j_enc = np.asarray(j_enc.astype(jnp.float32))
    assert t_enc.dtype == torch.bfloat16 and np.abs(j_enc).max() > 1.0
    np.testing.assert_allclose(t_enc.float().numpy(), j_enc, atol=5e-2)
    np.testing.assert_allclose(t_ctc.float().numpy(),
                               np.asarray(j_ctc.astype(jnp.float32)),
                               atol=5e-2)


@pytest.mark.parametrize("direction,want", [
    ("dirdrop", {"both": 0.8, "l2r": 0.2, "r2l": 0.0}),
    ("dirdrop_both", {"both": 0.8, "l2r": 0.1, "r2l": 0.1})])
def test_dirdrop_train_frequencies(direction, want):
    """In .train(), each call runs both passes or one; over 400 calls the
    shares of each lie within 4.5 binomial standard deviations of the
    reference's probabilities (drop R2L 0.2; keep both 0.8, else a fair
    coin)."""
    torch.manual_seed(0)
    att = RWKVAttention(16, D, 2, direction=direction, do_bfloat16=False)
    for p in att.parameters():
        torch.nn.init.normal_(p, std=0.2)
    x = torch.randn(1, 6, D)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)     # 400 calls of tiny ops: threads only wait
    try:
        with torch.no_grad():
            att.eval()
            l2r = att.tmix(x)
            r2l = att.tmix_rev(x.flip(1)).flip(1)
            refs = {"both": (l2r + r2l) / 2, "l2r": l2r, "r2l": r2l}
            att.train()
            n = 400
            seen = dict.fromkeys(refs, 0)
            for _ in range(n):
                y = att(x)
                hit = [k for k, r in refs.items() if torch.allclose(y, r)]
                assert len(hit) == 1
                seen[hit[0]] += 1
    finally:
        torch.set_num_threads(threads)
    for k, p in want.items():
        tol = 4.5 * np.sqrt(max(p * (1 - p), 1e-12) / n)
        assert abs(seen[k] / n - p) <= tol, (k, seen)
