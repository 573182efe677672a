"""The port's other model families against the JAX package's, on the same
weights: the bidirectional transducer, the context adaptor, the
teacher-student loss, CTL, Paraformer (CIF, SAN-M, the sampler, the
timestamp branch, recognition), wav2vec2, w2v-BERT, BestRQ (its fixed-key
targets through ``utils/jax_prng``) and Whisper (``whisper_log_mel``, the
positional encoding, the model, greedy decoding, the transformers loader).

Tiny sizes: 16 input features, width 32, 2 heads, 2 encoder blocks of the
flagship's kind (bi RWKV-6 attention, rel_pos, conv module) unless a case
says otherwise, ragged lengths, f32.  JAX's parameters come from
``jax.eval_shape`` filled by numpy (``test_torch_encoder_families.
seeded_params``) and reach the port through
``convert.state_dict_from_jax`` with ``strict`` loading: every case is
also the weight bridge's round trip for its model.  The training draws
(span starts, Gumbel uniforms, negative offsets, the sampler's uniforms,
BestRQ's noise) are the port's named draw functions, replaced here by
JAX's draws from the same key.  Dropout is 0 where a JAX loss runs with
``deterministic=False``.

Tolerances: losses within 1e-5 relative, gradient norms within 1e-4
relative, outputs within 1e-5 (Whisper's log-mel within 2e-4 where both
FFTs' quiet bins differ, and its greedy tokens identical); BestRQ's
targets identical; JAX's normals within 2 ulp (XLA's float32 ``log``
differs from its Cephes form in the last bit of ~1 value in 3000), its
uniforms and ``randint`` bit for bit.  Paraformer's alphas are checked
to stay 1e-4 away from every CIF threshold crossing, so a fire cannot turn
on the last bit.
"""
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paper_accurate_fast_cheap_tpu.frontend import features as j_feat
from paper_accurate_fast_cheap_tpu.models import bitransducer as j_bi
from paper_accurate_fast_cheap_tpu.models import context_adaptor as j_ca
from paper_accurate_fast_cheap_tpu.models import ctl_model as j_ctl
from paper_accurate_fast_cheap_tpu.models import embedding as j_emb
from paper_accurate_fast_cheap_tpu.models import factory as j_factory
from paper_accurate_fast_cheap_tpu.models import paraformer as j_para
from paper_accurate_fast_cheap_tpu.models import ssl_bestrq as j_brq
from paper_accurate_fast_cheap_tpu.models import ssl_w2vbert as j_w2vb
from paper_accurate_fast_cheap_tpu.models import ssl_wav2vec2 as j_w2v
from paper_accurate_fast_cheap_tpu.models import teacher_student as j_ts
from paper_accurate_fast_cheap_tpu.models import whisper as j_wh
from paper_accurate_fast_cheap_tpu.models.conformer import (
    ConformerEncoder as JEncoder)
from paper_accurate_fast_cheap_tpu.models.transducer import (
    Transducer as JTransducer)
from paper_accurate_fast_cheap_tpu_torch.convert import state_dict_from_jax
from paper_accurate_fast_cheap_tpu_torch.frontend import features as t_feat
from paper_accurate_fast_cheap_tpu_torch.models import bitransducer as t_bi
from paper_accurate_fast_cheap_tpu_torch.models import context_adaptor as t_ca
from paper_accurate_fast_cheap_tpu_torch.models import ctl_model as t_ctl
from paper_accurate_fast_cheap_tpu_torch.models import embedding as t_emb
from paper_accurate_fast_cheap_tpu_torch.models import paraformer as t_para
from paper_accurate_fast_cheap_tpu_torch.models import ssl_bestrq as t_brq
from paper_accurate_fast_cheap_tpu_torch.models import ssl_w2vbert as t_w2vb
from paper_accurate_fast_cheap_tpu_torch.models import ssl_wav2vec2 as t_w2v
from paper_accurate_fast_cheap_tpu_torch.models import teacher_student as t_ts
from paper_accurate_fast_cheap_tpu_torch.models import whisper as t_wh
from paper_accurate_fast_cheap_tpu_torch.models.conformer import (
    ConformerEncoder as TEncoder)
from paper_accurate_fast_cheap_tpu_torch.models.transducer import (
    Transducer as TTransducer)
from paper_accurate_fast_cheap_tpu_torch.train.train_step import global_norm
from paper_accurate_fast_cheap_tpu_torch.utils import jax_prng
from test_torch_encoder_families import seeded_params

IDIM, V = 16, 23
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4)
OUT_TOL = dict(rtol=1e-5, atol=1e-5)
ENC_YAML = dict(output_size=32, attention_heads=2, linear_units=64,
                num_blocks=2, cnn_module_kernel=15, dropout_rate=0.0,
                positional_dropout_rate=0.0,
                selfattention_layer_type="rwkv_tmix60_bidirectional",
                rwkv_do_bfloat16=False)
ENC = j_factory.encoder_conf_from_yaml(ENC_YAML, IDIM)
PRED = dict(embed_size=32, hidden_size=32, output_size=32, num_layers=2,
            embed_dropout=0.0, dropout=0.0)
JOINT = dict(join_dim=32)


def _batch(seed, T=64, lens=(64, 41), U=5):
    rng = np.random.RandomState(seed)
    feats = rng.randn(len(lens), T, IDIM).astype(np.float32)
    labels = rng.randint(1, V - 1, (len(lens), U)).astype(np.int32)
    ulens = np.asarray([U, U - 2], np.int32)
    return feats, np.asarray(lens, np.int32), labels, ulens


def _train_params(module, rng, *args):
    """``seeded_params`` of a tree initialised in training mode (flax
    creates the Paraformer sampler's embedding only there)."""
    keys = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}
    holder = type("Holder", (), {"init": staticmethod(
        lambda key, *a: module.init(keys, *a, deterministic=False))})
    return seeded_params(holder, rng, *args)


def _j(xs):
    return tuple(jnp.asarray(x) for x in xs)


def _t(xs):
    return tuple(torch.from_numpy(np.asarray(x)) for x in xs)


def _port(tmodel, params):
    tmodel.load_state_dict(state_dict_from_jax(params), strict=True)
    return tmodel.eval()


def _jax_loss_and_gnorm(jmodel, params, args, key="loss", **kw):
    def loss(p):
        out = jmodel.apply(p, *args, **kw)
        return out[key], out

    (val, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    gn = float(jnp.sqrt(sum(jnp.sum(jnp.square(g))
                            for g in jax.tree.leaves(grads))))
    return float(val), gn, out


def _torch_loss_and_gnorm(tmodel, args, key="loss", **kw):
    out = tmodel(*args, **kw)
    out[key].backward()
    gn = float(global_norm([p.grad for p in tmodel.parameters()
                            if p.grad is not None]))
    return float(out[key].detach()), gn, out


def _check_loss(j, t):
    np.testing.assert_allclose(t[0], j[0], **LOSS_TOL)
    np.testing.assert_allclose(t[1], j[1], **GRAD_TOL)


# ---- bidirectional transducer ----

def test_bitransducer_loss_and_gradients():
    batch = _batch(0)
    jm = j_bi.BiTransducer(vocab_size=V, encoder_conf=ENC,
                           predictor_conf=PRED, joint_conf=JOINT)
    params = seeded_params(jm, np.random.RandomState(1), *_j(batch))
    j = _jax_loss_and_gnorm(jm, params, _j(batch))
    tm = _port(t_bi.BiTransducer(V, ENC, predictor_conf=PRED,
                                 joint_conf=JOINT), params)
    t = _torch_loss_and_gnorm(tm, _t(batch))
    _check_loss(j, t)
    np.testing.assert_allclose(float(t[2]["loss_rnnt_r"]),
                               float(j[2]["loss_rnnt_r"]), **LOSS_TOL)
    x = np.random.RandomState(2).randn(2, 7, 3).astype(np.float32)
    lens = np.asarray([7, 4], np.int32)
    np.testing.assert_array_equal(
        t_bi.reverse_features_pad_list(*_t((x, lens))).numpy(),
        np.asarray(j_bi.reverse_features_pad_list(*_j((x, lens)))))


# ---- context adaptor ----

def test_context_adaptor_on_encoder_taps():
    feats, lens, _, _ = _batch(3)
    jenc = JEncoder(**ENC)
    eparams = seeded_params(jenc, np.random.RandomState(4),
                            *_j((feats, lens)), return_layers=True)
    _, _, j_taps = jax.jit(functools.partial(
        jenc.apply, return_layers=True))(eparams, *_j((feats, lens)))
    tenc = _port(TEncoder(**ENC), eparams)
    with torch.no_grad():
        _, _, t_taps = tenc(*_t((feats, lens)), return_layers=True)
    for a, b in zip(t_taps, j_taps):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **OUT_TOL)
    rng = np.random.RandomState(5)
    cv = rng.randint(1, V, (3, 4)).astype(np.int32)
    cv_lens = np.asarray([4, 2, 3], np.int32)
    jca = j_ca.ContextAdaptor(vocab_size=V, d_model=32, embed_size=16,
                              heads=2, num_combine_layers=2)
    cparams = seeded_params(jca, rng, list(j_taps), *_j((cv, cv_lens)))
    want = jca.apply(cparams, list(j_taps), *_j((cv, cv_lens)))
    tca = _port(t_ca.ContextAdaptor(V, 32, 16, 2, 2), cparams)
    with torch.no_grad():
        got = tca(t_taps, *_t((cv, cv_lens)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)


# ---- teacher-student ----

def test_teacher_student_loss_and_gradients():
    batch = _batch(6)
    jt = JTransducer(vocab_size=V, encoder_conf=ENC, predictor_conf=PRED,
                     joint_conf=JOINT)
    sp = seeded_params(jt, np.random.RandomState(7), *_j(batch))
    tp = seeded_params(jt, np.random.RandomState(8), *_j(batch))
    j_loss_fn = j_ts.make_ts_loss_fn(jt, jt, tp, distill_weight=0.5,
                                     encoder_l2_weight=0.1)
    (jl, jm), jg = jax.jit(jax.value_and_grad(j_loss_fn, has_aux=True))(
        sp, _j(batch), jax.random.PRNGKey(0))
    j_gn = float(jnp.sqrt(sum(jnp.sum(jnp.square(g))
                              for g in jax.tree.leaves(jg))))

    def port(p):
        return _port(TTransducer(V, ENC, predictor_conf=PRED,
                                 joint_conf=JOINT), p)

    student, teacher = port(sp), port(tp)
    loss_fn = t_ts.make_ts_loss_fn(student, teacher, distill_weight=0.5,
                                   encoder_l2_weight=0.1)
    params = {n: p.detach().requires_grad_(True)
              for n, p in student.named_parameters()}
    tl, tm = loss_fn(params, _t(batch), 0)
    grads = torch.autograd.grad(tl, list(params.values()),
                                allow_unused=True)
    t_gn = float(global_norm([g for g in grads if g is not None]))
    _check_loss((float(jl), j_gn), (float(tl), t_gn))
    np.testing.assert_allclose(float(tm["loss_distill"]),
                               float(jm["loss_distill"]), **LOSS_TOL)
    assert not any(p.grad is not None for p in teacher.parameters())


# ---- CTL ----

CTL_ASR = dict(vocab_size=V, encoder_conf=j_factory.encoder_conf_from_yaml(
    dict(ENC_YAML, selfattention_layer_type="rel_selfattn"), IDIM),
    ctc_weight=0.3, decoder_conf=dict(attention_heads=2, linear_units=32,
                                      num_blocks=1, r_num_blocks=1,
                                      dropout_rate=0.0,
                                      positional_dropout_rate=0.0),
    reverse_weight=0.3)


@pytest.fixture(scope="module")
def ctl():
    batch = _batch(9, T=80, lens=(80, 57))
    jm = j_ctl.CTLModel(asr_conf=CTL_ASR, n_negatives=5, chunk_size=4)
    params = seeded_params(jm, np.random.RandomState(10), *_j(batch))
    tm = _port(t_ctl.CTLModel(CTL_ASR, n_negatives=5, chunk_size=4), params)
    return jm, params, tm, batch


def test_ctl_eval_loss_on_the_fixed_key(ctl):
    """At eval JAX draws the negatives from PRNGKey(0) (jax_prng)."""
    jm, params, tm, batch = ctl
    j = _jax_loss_and_gnorm(jm, params, _j(batch))
    t = _torch_loss_and_gnorm(tm, _t(batch))
    _check_loss(j, t)
    for k in ("loss_full", "loss_chunk", "loss_ctl"):
        np.testing.assert_allclose(float(t[2][k]), float(j[2][k]),
                                   **LOSS_TOL)
    # the rel-pos encoder reads the chunk mask: the views differ
    assert abs(float(t[2]["loss_full"]) - float(t[2]["loss_chunk"])) > 1e-4


def test_ctl_training_negatives_injected(ctl, monkeypatch):
    jm, params, tm, _ = ctl
    rng = np.random.RandomState(11)
    x = rng.randn(2, 20, 32).astype(np.float32)
    y = rng.randn(2, 20, 32).astype(np.float32)
    valid = np.arange(20)[None] < np.asarray([[20], [13]])
    key = jax.random.PRNGKey(5)
    want = jm.apply(params, *_j((x, y, valid)), key, method=jm._ctl)
    drawn = []

    def jax_draw(shape, lo, hi, generator):
        drawn.append(shape)
        return torch.from_numpy(np.asarray(
            jax.random.randint(key, shape, lo, hi)))

    monkeypatch.setattr(t_ctl, "draw_negative_offsets", jax_draw)
    tm.train()
    offs = tm._offsets((2, 20, 5), 19)
    got = tm._ctl(*_t((x, y, valid)), offs)
    tm.eval()
    assert drawn == [(2, 20, 5)]
    np.testing.assert_allclose(float(got), float(want), **LOSS_TOL)


# ---- Paraformer ----

PARA = dict(vocab_size=V, encoder_conf=ENC, decoder_blocks=2,
            decoder_heads=2, decoder_linear_units=32, max_tokens=12)


def _cif_margin(alpha, threshold=1.0):
    """The least |acc + a_t - threshold| over the CIF loop (float64)."""
    margin = np.inf
    for row in np.asarray(alpha, np.float64):
        acc = 0.0
        for a in row:
            new = acc + a
            margin = min(margin, abs(new - threshold))
            acc = new - threshold if new >= threshold else new
    return margin


@pytest.fixture(scope="module")
def para():
    batch = _batch(12, lens=(64, 45))
    jm = j_para.Paraformer(**PARA)
    params = _train_params(jm, np.random.RandomState(13), *_j(batch))
    tm = _port(t_para.Paraformer(**PARA), params)
    return jm, params, tm, batch


def test_paraformer_loss_recognize_and_peaks(para, monkeypatch):
    """The training path scales alpha so its mass is exactly the label
    count: at threshold 1.0 the last fire is a tie that each side's
    summation order decides (JAX's own jitted and eager runs differ on
    it).  So the loss is held with both sides' ``cif`` at threshold 0.999,
    1e-4 clear of every crossing; recognition runs at 1.0."""
    jm, params, tm, batch = para
    seen = []

    def at_0999(cif):
        def run(enc, alpha, max_tokens):
            if isinstance(alpha, torch.Tensor):
                seen.append(alpha.detach().numpy())
            return cif(enc, alpha, max_tokens, threshold=0.999)
        return run

    monkeypatch.setattr(j_para, "cif", at_0999(j_para.cif))
    monkeypatch.setattr(t_para, "cif", at_0999(t_para.cif))
    j = _jax_loss_and_gnorm(jm, params, _j(batch))
    t = _torch_loss_and_gnorm(tm, _t(batch))
    assert _cif_margin(seen[-1].astype(np.float64), 0.999) > 1e-4
    monkeypatch.undo()
    _check_loss(j, t)
    for k in ("loss_decoder", "loss_quantity", "loss_ctc"):
        np.testing.assert_allclose(float(t[2][k]), float(j[2][k]),
                                   **LOSS_TOL)
    feats, lens = batch[:2]
    with torch.no_grad():
        enc, elens = tm.encoder(*_t((feats, lens)))
        alpha = tm._alphas(enc, elens)
    assert _cif_margin(alpha.numpy()) > 1e-4
    ids, n = tm.recognize(*_t((feats, lens)))
    jids, jn = jm.apply(params, *_j((feats, lens)), method=jm.recognize)
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    assert n.numpy().min() > 0
    for b in range(len(lens)):
        assert (ids[b, :n[b]].tolist()
                == np.asarray(jids)[b, :int(jn[b])].tolist())
    nums = np.asarray([4, 3], np.int32)
    np.testing.assert_array_equal(
        tm.forward_cif_peaks(*_t((feats, lens, nums))).numpy(),
        np.asarray(jm.apply(params, *_j((feats, lens, nums)),
                            method=jm.forward_cif_peaks)))


def test_paraformer_sampler_injected(para, monkeypatch):
    jm, params, tm, batch = para
    rng = np.random.RandomState(14)
    B, D = 2, 32
    enc = rng.randn(B, 16, D).astype(np.float32)
    elens = np.asarray([16, 11], np.int32)
    embs = rng.randn(B, 12, D).astype(np.float32)
    tgt = np.full((B, 12), -1, np.int32)
    tgt[0, :5] = rng.randint(1, V, 5)
    tgt[1, :3] = rng.randint(1, V, 3)
    llens = np.asarray([5, 3], np.int32)
    key = jax.random.PRNGKey(3)
    want = jm.apply(params, *_j((enc, elens, embs, tgt, llens)), key,
                    method=jm._sampler)
    monkeypatch.setattr(t_para, "draw_sampler_uniform", lambda shape, g: (
        torch.from_numpy(np.asarray(jax.random.uniform(key, shape)))))
    tm.train()
    with torch.no_grad():
        got = tm._sampler(*_t((enc, elens, embs, tgt, llens)))
    tm.eval()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)


def test_cif_and_sanm():
    rng = np.random.RandomState(15)
    enc = rng.randn(2, 30, 8).astype(np.float32)
    alpha = rng.uniform(0.05, 0.6, (2, 30)).astype(np.float32)
    assert _cif_margin(alpha) > 1e-4
    we, wn = j_para.cif(*_j((enc, alpha)), 20)
    ge, gn = t_para.cif(*_t((enc, alpha)), 20)
    np.testing.assert_array_equal(gn.numpy(), np.asarray(wn))
    np.testing.assert_allclose(ge.numpy(), np.asarray(we), **OUT_TOL)
    x = rng.randn(2, 9, 16).astype(np.float32)
    pad = np.arange(9)[None] < np.asarray([[9], [6]])
    mask = pad[:, None, :]
    js = j_para.SANMAttention(heads=2, d_model=16, kernel_size=5,
                              sanm_shift=1)
    sp = seeded_params(js, rng, *_j((x, mask, pad)))
    want = js.apply(sp, *_j((x, mask, pad)))
    ts_ = _port(t_para.SANMAttention(2, 16, 5, 1), sp)
    with torch.no_grad():
        got = ts_(*_t((x, mask, pad)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)


# ---- wav2vec2 and w2v-BERT ----

def _inject_w2v_draws(monkeypatch, key, num_negatives):
    """The port's three draws replaced by JAX's from ``key``."""
    k_mask, k_gumbel, k_neg = jax.random.split(key, 3)

    def starts(shape, prob, g):
        return torch.from_numpy(np.asarray(
            jax.random.bernoulli(k_mask, prob, shape)))

    def gumbel(shape, g):
        return torch.from_numpy(np.asarray(jax.random.uniform(
            k_gumbel, shape, minval=1e-6, maxval=1.0 - 1e-6)))

    def offsets(n, lo, hi, g):
        assert n == num_negatives
        return torch.from_numpy(np.asarray(
            jax.random.randint(k_neg, (n,), 1, jnp.maximum(hi, 2))))

    monkeypatch.setattr(t_w2v, "draw_span_starts", starts)
    monkeypatch.setattr(t_w2v, "draw_gumbel_uniform", gumbel)
    monkeypatch.setattr(t_w2v, "draw_negative_offsets", offsets)


SSL = dict(proj_dim=16, num_negatives=6, mask_prob=0.2, mask_length=3)


@pytest.mark.parametrize("family", ["wav2vec2", "w2vbert"])
def test_ssl_contrastive_losses(family, monkeypatch):
    feats, lens, _, _ = _batch(16, T=80, lens=(80, 61))
    key = jax.random.PRNGKey(17)
    if family == "wav2vec2":
        jm = j_w2v.Wav2Vec2Model(encoder_conf=ENC, **SSL)
        tm_cls = functools.partial(t_w2v.Wav2Vec2Model, ENC, **SSL)
        extra, kw = (), {}
    else:
        conf = dict(SSL, num_codebooks=2, codebook_entries=24,
                    diversity_weight=0.1, warmup_steps=200)
        jm = j_w2vb.W2VBertModel(encoder_conf=ENC, **conf)
        tm_cls = functools.partial(t_w2vb.W2VBertModel, ENC, **conf)
        extra, kw = (100,), {"steps": 100}
    params = seeded_params(jm, np.random.RandomState(18),
                           *_j((feats, lens)), key, *extra)
    j = _jax_loss_and_gnorm(jm, params, (*_j((feats, lens)), key, *extra))
    _inject_w2v_draws(monkeypatch, key, SSL["num_negatives"])
    tm = _port(tm_cls(), params)
    t = _torch_loss_and_gnorm(tm, _t((feats, lens)), **kw)
    _check_loss(j, t)
    assert int(t[2]["num_masked"]) == int(j[2]["num_masked"]) > 0
    for k in t[2]:
        np.testing.assert_allclose(float(t[2][k]), float(j[2][k]),
                                   **LOSS_TOL)


def test_encoder_pre_embedded():
    """w2v-BERT's second pass: no subsampling, lengths min(lens, T)."""
    x = np.random.RandomState(19).randn(2, 11, 32).astype(np.float32)
    lens = np.asarray([11, 14], np.int32)
    jenc = JEncoder(**ENC)
    fl = (np.zeros((2, 48, IDIM), np.float32), lens)
    params = seeded_params(jenc, np.random.RandomState(20), *_j(fl))
    want, wl = jenc.apply(params, *_j((x, lens)), pre_embedded=True)
    tenc = _port(TEncoder(**ENC), params)
    with torch.no_grad():
        got, gl = tenc(*_t((x, lens)), pre_embedded=True)
    assert gl.tolist() == np.asarray(wl).tolist() == [11, 11]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)


# ---- BestRQ and JAX's fixed keys ----

def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("seed,shape", [(0, (64, 16)), (0, (320, 16)),
                                        (100, (8192, 16)), (101, (512, 16))])
def test_jax_prng_normal(seed, shape):
    """BestRQ's projection (64 = 4 x 16 here, 320 = 4 x 80 on the
    flagship's features) and codebooks."""
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
    got = jax_prng.normal(jax_prng.key(seed), shape)
    assert got.dtype == np.float32
    d = _ulps(got, want)
    assert d.max() <= 2 and (d > 0).mean() < 1e-3


@pytest.mark.parametrize("shape,hi", [((2, 30, 5), 29), ((4, 375, 50), 374),
                                      ((7,), 2)])
def test_jax_prng_randint_split_uniform(shape, hi):
    k = jax.random.PRNGKey(0)
    np.testing.assert_array_equal(
        jax_prng.randint(jax_prng.key(0), shape, 1, hi),
        np.asarray(jax.random.randint(k, shape, 1, hi)))
    np.testing.assert_array_equal(jax_prng.split(jax_prng.key(0), 3),
                                  np.asarray(jax.random.split(k, 3)))
    np.testing.assert_array_equal(
        jax_prng.uniform(jax_prng.key(0), shape, 1e-6, 1 - 1e-6),
        np.asarray(jax.random.uniform(k, shape, minval=1e-6,
                                      maxval=1 - 1e-6)))


def test_bestrq_fixed_key_targets_and_loss(monkeypatch):
    feats, lens, _, _ = _batch(21, T=64, lens=(64, 50))
    conf = dict(input_size=IDIM, num_codebooks=2, codebook_size=512,
                mask_prob=0.1, mask_length=4)
    jm = j_brq.BestRQModel(encoder_conf=ENC, **conf)
    key = jax.random.PRNGKey(22)
    params = seeded_params(jm, np.random.RandomState(23),
                           *_j((feats, lens)), key)
    tm = _port(t_brq.BestRQModel(ENC, **conf), params)
    want = jm.apply(params, jnp.asarray(feats), method=jm._quantize)
    got = tm._quantize(torch.from_numpy(feats))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    j = _jax_loss_and_gnorm(jm, params, (*_j((feats, lens)), key),
                            deterministic=True)
    monkeypatch.setattr(t_brq, "draw_span_starts", lambda shape, p, g: (
        torch.from_numpy(np.asarray(jax.random.bernoulli(key, p, shape)))))
    monkeypatch.setattr(t_brq, "draw_noise", lambda shape, g: (
        torch.from_numpy(np.asarray(jax.random.normal(
            jax.random.fold_in(key, 1), shape)))))
    t = _torch_loss_and_gnorm(tm, _t((feats, lens)))
    _check_loss(j, t)
    assert int(t[2]["num_masked"]) == int(j[2]["num_masked"]) > 0


# ---- Whisper ----

WH = dict(vocab_size=50, n_mels=16, d_model=32, heads=2, encoder_blocks=2,
          decoder_blocks=2, max_target_positions=24)


@pytest.fixture(scope="module")
def whisper():
    rng = np.random.RandomState(24)
    mel = rng.randn(2, 30, 16).astype(np.float32)
    mel_lens = np.asarray([30, 21], np.int32)
    ys_in = rng.randint(0, 50, (2, 6)).astype(np.int32)
    ys_out = ys_in.copy()
    ys_out[1, 4:] = -1
    ys_lens = np.asarray([6, 4], np.int32)
    args = (mel, mel_lens, ys_in, ys_out, ys_lens)
    jm = j_wh.WhisperModel(**WH)
    params = seeded_params(jm, np.random.RandomState(25), *_j(args))
    tm = _port(t_wh.WhisperModel(**WH), params)
    return jm, params, tm, args


def test_whisper_loss_and_greedy_decode(whisper):
    jm, params, tm, args = whisper
    j = _jax_loss_and_gnorm(jm, params, _j(args))
    t = _torch_loss_and_gnorm(tm, _t(args))
    _check_loss(j, t)
    mel, mel_lens = args[:2]
    want = j_wh.whisper_greedy_decode(jm, params, *_j((mel, mel_lens)),
                                      [1, 2, 3], eot_id=0, max_len=12)
    got = t_wh.whisper_greedy_decode(tm, *_t((mel, mel_lens)), [1, 2, 3],
                                     eot_id=0, max_len=12)
    assert got == want and any(got)


def test_whisper_log_mel_and_positions():
    rng = np.random.RandomState(26)
    wav = (0.3 * np.sin(np.arange(8000) * 0.05)
           + 0.05 * rng.randn(8000)).astype(np.float32)
    want = np.asarray(j_feat.whisper_log_mel(jnp.asarray(wav),
                                             num_mel_bins=16))
    got = t_feat.whisper_log_mel(torch.from_numpy(wav),
                                 num_mel_bins=16).numpy()
    assert got.shape == want.shape == (50, 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)
    np.testing.assert_array_equal(t_emb.sinusoid_table(40, 8),
                                  j_emb.sinusoid_table(40, 8))
    x = rng.randn(2, 5, 8).astype(np.float32)
    jpe = j_emb.WhisperPositionalEncoding(d_model=8, max_len=40)
    wy, wp = jpe.apply({}, jnp.asarray(x), offset=3)
    ty, tp = t_emb.WhisperPositionalEncoding(8, max_len=40).eval()(
        torch.from_numpy(x), offset=3)
    np.testing.assert_array_equal(ty.numpy(), np.asarray(wy))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(wp))


def _unstub_modules(monkeypatch):
    """Some JAX-package tests put empty modules in ``sys.modules`` (stubs
    for the reference's imports: ``sentencepiece``, ``torchaudio``, ...);
    transformers' import asks for their specs and fails on them.  Hide the
    stubs for this test."""
    for name, mod in list(sys.modules.items()):
        if ("." not in name and name != "__main__" and mod is not None
                and getattr(mod, "__spec__", None) is None
                and not getattr(mod, "__file__", None)):
            monkeypatch.delitem(sys.modules, name)


def test_load_hf_whisper_params(whisper, monkeypatch):
    _unstub_modules(monkeypatch)
    transformers = pytest.importorskip("transformers")
    jm, params, _, args = whisper
    cfg = transformers.WhisperConfig(
        vocab_size=50, num_mel_bins=16, d_model=32, encoder_layers=2,
        decoder_layers=2, encoder_attention_heads=2,
        decoder_attention_heads=2, encoder_ffn_dim=128, decoder_ffn_dim=128,
        max_source_positions=15, max_target_positions=24,
        pad_token_id=0, bos_token_id=1, eos_token_id=0,
        decoder_start_token_id=1)
    torch.manual_seed(0)
    hf = transformers.WhisperForConditionalGeneration(cfg).eval()
    state = {k: v.detach().numpy() for k, v in hf.state_dict().items()}
    jp = j_wh.load_hf_whisper_params(state, jm, params)
    want = _jax_loss_and_gnorm(jm, jp, _j(args))
    tm = t_wh.load_hf_whisper_params(
        {k: torch.from_numpy(v) for k, v in state.items()},
        _port(t_wh.WhisperModel(**WH), params))
    got = _torch_loss_and_gnorm(tm, _t(args))
    _check_loss(want, got)
    np.testing.assert_array_equal(
        tm.encoder.conv1.weight.detach().numpy(),
        state["model.encoder.conv1.weight"])
