"""The port's time-synchronous joint CTC/attention decoding and its HLG
surface (``models/k2_model.py``) against the JAX package's.

A tiny hybrid model of the paper's kind (2 conformer blocks of width 32,
the bitransformer decoder, V 23) on seeded weights (``jax.eval_shape``
filled by numpy) through ``convert.state_dict_from_jax``; the port's
encoder output and CTC log-probs (f32) are handed to both sides, so each
case tests the search and the decoder step alone.

- ``joint_decoding`` at beams 3 and 6, with and without the lexicon
  constraint (a word list under which the reference's fallback both
  prunes and keeps every candidate): tokens identical, score within 1e-5.
- ``k2_model``: k2 is absent on both sides (``k2_available`` False);
  ``hlg_onebest`` falls back to the CTC prefix beam (n-best identical);
  ``hlg_rescore`` with an n-gram (``decode/lm.NGramLM``), the decoder's
  left and right path scores and their scales: n-best identical, every
  combined score within 1e-5; ``export_posteriors`` writes JAX's arrays.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paper_accurate_fast_cheap_tpu.decode import joint_decoding as j_jd
from paper_accurate_fast_cheap_tpu.decode import lm as j_lm
from paper_accurate_fast_cheap_tpu.models import factory as j_factory
from paper_accurate_fast_cheap_tpu.models import k2_model as j_k2
from paper_accurate_fast_cheap_tpu.models.asr_model import (
    ASRModel as JASRModel)
from paper_accurate_fast_cheap_tpu_torch.convert import state_dict_from_jax
from paper_accurate_fast_cheap_tpu_torch.decode import joint_decoding as t_jd
from paper_accurate_fast_cheap_tpu_torch.decode import lm as t_lm
from paper_accurate_fast_cheap_tpu_torch.models import k2_model as t_k2
from paper_accurate_fast_cheap_tpu_torch.models.asr_model import (
    ASRModel as TASRModel)
from test_torch_encoder_families import seeded_params

V = 23
SCORE_TOL = 1e-5
ASR = dict(vocab_size=V, ctc_weight=0.3, reverse_weight=0.3,
           encoder_conf=j_factory.encoder_conf_from_yaml(dict(
               output_size=32, attention_heads=2, linear_units=64,
               num_blocks=2, cnn_module_kernel=15, dropout_rate=0.0,
               selfattention_layer_type="rwkv_tmix60_bidirectional",
               rwkv_do_bfloat16=False), 16),
           decoder_conf=dict(attention_heads=2, linear_units=32,
                             num_blocks=1, r_num_blocks=1))
# token pieces: 1..20 spell words; "▁" starts a word
PIECES = {i: ("▁" if i % 3 == 1 else "") + "abcdefghijklmnopqrst"[i - 1]
          for i in range(1, 21)}
ARPA = "\\data\\\nngram 1=4\nngram 2=2\n\n\\1-grams:\n" + "".join(
    f"-{0.5 + 0.1 * i:.2f}\t{t}\t-0.20\n" for i, t in enumerate(
        (1, 4, 7, 9))) + ("\n\\2-grams:\n-0.10\t1 4\n-0.30\t4 7\n\n"
                          "\\end\\\n")


@pytest.fixture(scope="module")
def model():
    rng = np.random.RandomState(0)
    feats = (rng.randn(2, 120, 16) * 2).astype(np.float32)
    lens = np.asarray([120, 87], np.int32)
    labels = rng.randint(1, V - 1, (2, 4)).astype(np.int32)
    jm = JASRModel(**ASR)
    params = seeded_params(jm, np.random.RandomState(1), jnp.asarray(feats),
                           jnp.asarray(lens), jnp.asarray(labels),
                           jnp.asarray([4, 3], np.int32))
    # a CTC head that emits varied tokens (a random one emits blanks)
    params["params"]["ctc"]["ctc_lo"]["kernel"] *= 6.0
    params["params"]["ctc"]["ctc_lo"]["bias"][0] = -2.0
    tm = TASRModel(**ASR)
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    tm.eval()
    enc, elens = tm.forward_encoder(torch.from_numpy(feats),
                                    torch.from_numpy(lens))
    ctc = tm.ctc_logprobs(enc).numpy()
    return jm, params, tm, enc, elens, ctc


def _j_one_step(jm, params):
    return lambda e, l, y, yl: jm.apply(
        params, e, l, y, yl,
        method=lambda m, *a: m.decoder.forward_one_step(*a))


def _lexicon(kind):
    if kind is None:
        return {}
    words = {"adg": 1, "jm": 2, "ps": 3, "a": 4}
    prefixes = {w[:i]: 1 for w in words for i in range(1, len(w) + 1)}
    if kind == "tight":
        words, prefixes = {"zz": 1}, {"z": 1}
    return dict(words=words, word_prefixes=prefixes, tok_to_str=PIECES)


@pytest.mark.parametrize("lexicon", [None, "words", "tight"])
@pytest.mark.parametrize("beam", [3, 6])
def test_joint_decoding_matches_jax(model, beam, lexicon):
    jm, params, tm, enc, elens, ctc = model
    for b in range(2):
        kw = dict(sos=V - 1, eos=V - 1, beam_size=beam, ctc_weight=0.4,
                  att_weight=0.6, **_lexicon(lexicon))
        want = j_jd.joint_decoding(
            _j_one_step(jm, params), jnp.asarray(enc[b:b + 1].numpy()),
            np.asarray(elens[b:b + 1]), ctc[b], **kw)
        got = t_jd.joint_decoding(tm.decoder_one_step, enc[b:b + 1],
                                  elens[b:b + 1], ctc[b], **kw)
        assert got.tokens == want.tokens and got.tokens
        assert abs(got.score - want.score) < SCORE_TOL


def test_hlg_onebest_falls_back_to_the_ctc_beam(model):
    *_, elens, ctc = model
    assert t_k2.k2_available() is j_k2.k2_available() is False
    want = j_k2.hlg_onebest(ctc, elens.numpy(), hlg_path="HLG.pt",
                            beam_size=4)
    got = t_k2.hlg_onebest(ctc, elens.numpy(), hlg_path="HLG.pt",
                           beam_size=4)
    assert [r.nbest for r in got] == [r.nbest for r in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.nbest_scores, w.nbest_scores, rtol=0,
                                   atol=SCORE_TOL)


@pytest.mark.parametrize("scales", [(0.0, 0.0, 0.0), (0.7, 0.0, 0.0),
                                    (0.5, 1.0, 0.5)])
def test_hlg_rescore_matches_jax(model, tmp_path, scales):
    jm, params, tm, enc, elens, ctc = model
    (tmp_path / "g.arpa").write_text(ARPA)
    lm_scale, dec_scale, r_scale = scales

    def j_apply(e, l, y, yl, ry, rw):
        return jm.apply(params, e, l, y, yl, ry, rw,
                        method=jm.decoder_forward)

    kw = dict(sos=V - 1, eos=V - 1, lm_scale=lm_scale,
              decoder_scale=dec_scale, r_decoder_scale=r_scale,
              beam_size=4)
    want = j_k2.hlg_rescore(
        ctc, elens.numpy(), j_apply, enc_out=enc.numpy(),
        enc_lens=elens.numpy(),
        ngram_lm=j_lm.NGramLM.from_arpa(str(tmp_path / "g.arpa"), None, V),
        **kw)
    got = t_k2.hlg_rescore(
        ctc, elens.numpy(), tm.decoder_forward, enc_out=enc,
        enc_lens=elens,
        ngram_lm=t_lm.NGramLM.from_arpa(str(tmp_path / "g.arpa"), None, V),
        **kw)
    for g, w in zip(got, want):
        assert g.nbest == w.nbest and g.tokens == w.tokens
        np.testing.assert_allclose(g.nbest_scores, w.nbest_scores, rtol=0,
                                   atol=SCORE_TOL)


def test_export_posteriors(model, tmp_path):
    *_, elens, ctc = model
    j_k2.export_posteriors(str(tmp_path / "j.npz"), ctc, elens.numpy())
    t_k2.export_posteriors(str(tmp_path / "t.npz"), ctc, elens.numpy(),
                           keys=["0", "1"])
    j, t = np.load(tmp_path / "j.npz"), np.load(tmp_path / "t.npz")
    for k in ("ctc_logp", "lengths", "keys"):
        np.testing.assert_array_equal(t[k], j[k])
