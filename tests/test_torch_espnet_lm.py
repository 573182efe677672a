"""The port's shallow-fusion scorers, WFST stack, FST CLI and ESPnet-style
transducer searches against the JAX package's.

- ``decode/lm.py``: the ARPA parse (every n-gram and backoff), the score
  vectors along token paths, ``batch_score``, ``sequence_logp`` and
  ``UniformLM``, equal to the last bit (host numpy on both sides).
- ``decode/wfst.py``: ``arpa_to_g`` and ``lexicon_to_l`` arcs and finals
  equal, the AT&T text byte for byte and read back, ``LGScorer`` vectors
  along token paths equal; ``bin/fst_tools.py``: both subcommands write
  JAX's ``L.fst.txt``, ``words.txt`` and ``G.fst.txt`` byte for byte.
- ``decode/transducer_espnet.py``: the five searches (default, TSD, ALSD,
  NSC, mAES) with no LM, with ``UniformLM``, with ``NGramLM`` and with
  ``LGScorer``, on the random recurrent harness of the JAX package's
  parity test (a tanh predictor, a linear joint, V 7); with no LM on its
  synthetic one-hot harness (JAX ``tests/test_transducer_espnet.py``,
  which recovers the sequence) and on a tiny transducer's real LSTM
  predictor and joint through each side's ``make_transducer_step_fns``.
  The n-best token lists are identical and their scores within 1e-5.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paper_accurate_fast_cheap_tpu.bin import fst_tools as j_fst_tools
from paper_accurate_fast_cheap_tpu.decode import lm as j_lm
from paper_accurate_fast_cheap_tpu.decode import rnnt_search as j_rnnt
from paper_accurate_fast_cheap_tpu.decode import transducer_espnet as j_esp
from paper_accurate_fast_cheap_tpu.decode import wfst as j_wfst
from paper_accurate_fast_cheap_tpu.models import factory as j_factory
from paper_accurate_fast_cheap_tpu.models.transducer import (
    Transducer as JTransducer)
from paper_accurate_fast_cheap_tpu_torch.bin import fst_tools as t_fst_tools
from paper_accurate_fast_cheap_tpu_torch.convert import state_dict_from_jax
from paper_accurate_fast_cheap_tpu_torch.decode import lm as t_lm
from paper_accurate_fast_cheap_tpu_torch.decode import rnnt_search as t_rnnt
from paper_accurate_fast_cheap_tpu_torch.decode import (
    transducer_espnet as t_esp)
from paper_accurate_fast_cheap_tpu_torch.decode import wfst as t_wfst
from paper_accurate_fast_cheap_tpu_torch.models.transducer import (
    Transducer as TTransducer)
from test_torch_encoder_families import seeded_params

SEARCHES = ["default", "tsd", "alsd", "nsc", "maes"]
SCORE_TOL = 1e-5
V = 7
# JAX tests/test_lm_fusion.py's ARPA over token ids
ARPA = """\\data\\
ngram 1=7
ngram 2=5
ngram 3=2

\\1-grams:
-0.90\t0\t-0.30
-0.70\t1\t-0.40
-0.80\t2\t-0.20
-1.00\t3\t-0.10
-1.10\t4
-1.20\t5\t-0.50
-1.30\t6

\\2-grams:
-0.20\t0 1\t-0.15
-0.30\t1 2\t-0.25
-0.40\t2 3
-0.50\t1 5\t-0.35
-0.60\t5 1

\\3-grams:
-0.10\t0 1 2
-0.15\t1 2 3

\\end\\
"""
# JAX tests/test_wfst.py's lexicon (word id -> token ids) and word ARPA
LEXICON = {1: [1, 2], 2: [1, 3], 3: [4]}
WORD_ARPA = """\\data\\
ngram 1=3
ngram 2=2

\\1-grams:
-0.60\t1\t-0.30
-0.90\t2\t-0.20
-0.50\t3\t-0.40

\\2-grams:
-0.10\t1 3
-0.20\t3 2

\\end\\
"""


@pytest.fixture(scope="module")
def arpa(tmp_path_factory):
    d = tmp_path_factory.mktemp("lm")
    (d / "tok.arpa").write_text(ARPA)
    (d / "word.arpa").write_text(WORD_ARPA)
    return d


def _lms(arpa, mod, wfst_mod):
    """The four scorers of one side: None, uniform, n-gram, LG."""
    ng = mod.NGramLM.from_arpa(str(arpa / "tok.arpa"), None, V)
    g = mod.NGramLM.from_arpa(str(arpa / "word.arpa"), None, 4)
    lg = wfst_mod.LGScorer(wfst_mod.lexicon_to_l(LEXICON),
                           wfst_mod.arpa_to_g(g), vocab_size=V)
    return {"none": None, "uniform": mod.UniformLM(V), "ngram": ng,
            "lg": lg}


# ---- decode/lm.py ----

PATHS = [(), (0,), (0, 1), (1, 2), (5, 1, 2), (6, 6), (3, 2, 1, 0)]


def test_ngram_lm_matches_jax(arpa):
    j = j_lm.NGramLM.from_arpa(str(arpa / "tok.arpa"), None, V)
    t = t_lm.NGramLM.from_arpa(str(arpa / "tok.arpa"), None, V)
    assert t.ngrams == j.ngrams and t.order == j.order == 3
    for path in PATHS:
        jst, tst = j.init_state(), t.init_state()
        for tok in path + (None,):
            jv, jst = j.score(jst, tok)
            tv, tst = t.score(tst, tok)
            assert tst == jst
            np.testing.assert_array_equal(tv, jv)
        assert t.sequence_logp(path) == j.sequence_logp(path)
        assert t.advance(tst, 4) == j.advance(jst, 4)
    tb, ts_ = t.batch_score([(), (1,), (1, 2)], [None, 2, 3])
    jb, js = j.batch_score([(), (1,), (1, 2)], [None, 2, 3])
    np.testing.assert_array_equal(tb, jb)
    assert ts_ == js
    u = t_lm.UniformLM(V).batch_score([(), (2,)], [1, None])
    np.testing.assert_array_equal(
        u[0], j_lm.UniformLM(V).batch_score([(), (2,)], [1, None])[0])
    assert u[0][0, 0] == np.float32(-math.log(V))


# ---- decode/wfst.py and bin/fst_tools.py ----

def test_wfst_graphs_text_and_lg_scorer(arpa, tmp_path):
    jg = j_lm.NGramLM.from_arpa(str(arpa / "word.arpa"), None, 4)
    tg = t_lm.NGramLM.from_arpa(str(arpa / "word.arpa"), None, 4)
    for build, args in ((lambda w, g: w.arpa_to_g(g), (jg, tg)),
                        (lambda w, _: w.lexicon_to_l(LEXICON), (None, None))):
        jf, tf = build(j_wfst, args[0]), build(t_wfst, args[1])
        assert tf.arcs == jf.arcs and tf.finals == jf.finals
        j_wfst.write_fst_text(jf, str(tmp_path / "j.txt"))
        t_wfst.write_fst_text(tf, str(tmp_path / "t.txt"))
        assert ((tmp_path / "t.txt").read_bytes()
                == (tmp_path / "j.txt").read_bytes())
        back = t_wfst.read_fst_text(str(tmp_path / "t.txt"))
        assert back.arcs == j_wfst.read_fst_text(str(tmp_path / "j.txt")).arcs
    jsc = j_wfst.build_tlg_scorer({"ab": [1, 2], "ac": [1, 3], "d": [4]},
                                  {"ab": 1, "ac": 2, "d": 3}, jg,
                                  vocab_size=V)
    tsc = t_wfst.build_tlg_scorer({"ab": [1, 2], "ac": [1, 3], "d": [4]},
                                  {"ab": 1, "ac": 2, "d": 3}, tg,
                                  vocab_size=V)
    for path in ((), (4,), (4, 1), (4, 1, 3), (1, 2, 4), (2,)):
        jst, tst = jsc.init_state(), tsc.init_state()
        for tok in path + (None,):
            jv, jst = jsc.score(jst, tok)
            tv, tst = tsc.score(tst, tok)
            assert tst == jst
            np.testing.assert_array_equal(tv, jv)


def test_fst_tools_cli_writes_jax_bytes(arpa, tmp_path):
    (tmp_path / "lexicon.txt").write_text(
        "ab a b\nac a c\nd d\nbad a z\nab a c\n")
    (tmp_path / "units.txt").write_text("<blank> 0\na 1\nb 2\nc 3\nd 4\n")
    (tmp_path / "g.arpa").write_text(WORD_ARPA.replace("\t1", "\tab")
                                     .replace("\t2", "\tac")
                                     .replace("\t3", "\td")
                                     .replace(" 3", " d").replace(" 2", " ac"))
    for side, main in (("j", j_fst_tools.main), ("t", t_fst_tools.main)):
        d = tmp_path / side
        d.mkdir()
        assert main(["compile_lexicon", "--lexicon",
                     str(tmp_path / "lexicon.txt"), "--units",
                     str(tmp_path / "units.txt"), "--out",
                     str(d / "L.fst.txt")]) == 0
        assert main(["arpa_to_g", "--arpa", str(tmp_path / "g.arpa"),
                     "--words", str(d / "words.txt"), "--out",
                     str(d / "G.fst.txt")]) == 0
    for name in ("L.fst.txt", "words.txt", "G.fst.txt"):
        got = (tmp_path / "t" / name).read_bytes()
        assert got == (tmp_path / "j" / name).read_bytes() and got


# ---- decode/transducer_espnet.py ----

class _Harness:
    """JAX ``tests/test_transducer_espnet.py``'s random harness: a tanh
    recurrence predictor over H, a linear joint, V 7."""

    def __init__(self, seed, T=8, H=6, De=4):
        rng = np.random.RandomState(seed)
        self.H = H
        self.E = (rng.randn(V, H) * 0.5).astype(np.float32)
        self.W = (rng.randn(H, H) * 0.3).astype(np.float32)
        self.A = rng.randn(De, V).astype(np.float32)
        self.Bm = rng.randn(H, V).astype(np.float32)
        self.enc = rng.randn(T, De).astype(np.float32)

    def jax_fns(self):
        E, W, A, Bm = map(jnp.asarray, (self.E, self.W, self.A, self.Bm))

        @jax.jit
        def pstep(tok, s):
            s = jnp.tanh(s @ W + E[tok])
            return s, s

        return (pstep, lambda e, p: jax.nn.log_softmax(e @ A + p @ Bm),
                lambda n: jnp.zeros((n, self.H)))

    def torch_fns(self):
        E, W, A, Bm = map(torch.from_numpy, (self.E, self.W, self.A,
                                             self.Bm))

        def pstep(tok, s):
            s = torch.tanh(s @ W + E[tok.long()])
            return s, s

        return (pstep, lambda e, p: torch.log_softmax(e @ A + p @ Bm, -1),
                lambda n: torch.zeros(n, self.H))


def _both(jfns, tfns, jenc, tenc, stype, jlm=None, tlm=None, **kw):
    jr = j_esp.BeamSearchTransducer(*jfns, search_type=stype, lm=jlm,
                                    **kw).decode(jenc)
    tr = t_esp.BeamSearchTransducer(*tfns, search_type=stype, lm=tlm,
                                    **kw).decode(tenc)
    assert tr.nbest == jr.nbest and tr.tokens == jr.tokens
    np.testing.assert_allclose(tr.nbest_scores, jr.nbest_scores, rtol=0,
                               atol=SCORE_TOL)
    return tr


@pytest.mark.parametrize("lm_kind", ["none", "uniform", "ngram", "lg"])
@pytest.mark.parametrize("stype", SEARCHES)
def test_searches_with_each_lm(arpa, stype, lm_kind):
    h = _Harness(0)
    jlm = _lms(arpa, j_lm, j_wfst)[lm_kind]
    tlm = _lms(arpa, t_lm, t_wfst)[lm_kind]
    tr = _both(h.jax_fns(), h.torch_fns(), jnp.asarray(h.enc),
               torch.from_numpy(h.enc), stype, jlm, tlm, beam_size=3,
               lm_weight=0.5)
    assert len(tr.nbest) == 3


@pytest.mark.parametrize("stype", SEARCHES)
def test_searches_recover_the_one_hot_sequence(stype):
    D = 10

    @jax.jit
    def jp(tok, s):
        return jax.nn.one_hot(tok, D), s

    def jj(e, p):
        same = jnp.sum(e * p, -1, keepdims=True) > 0.5
        logits = (e * 10.0).at[:, 0].set(jnp.where(same, 20.0, -20.0)[:, 0])
        return jax.nn.log_softmax(logits)

    def tp(tok, s):
        return torch.nn.functional.one_hot(tok.long(), D).float(), s

    def tj(e, p):
        same = (e * p).sum(-1) > 0.5
        logits = e * 10.0
        logits[:, 0] = torch.where(same, 20.0, -20.0)
        return torch.log_softmax(logits, -1)

    seq = [5, 7, 3]
    enc = np.eye(D, dtype=np.float32)[seq + [3]]
    tr = _both((jp, jj, lambda n: jnp.zeros((n,))),
               (tp, tj, lambda n: torch.zeros(n)), jnp.asarray(enc),
               torch.from_numpy(enc), stype, beam_size=4)
    assert tr.tokens == seq


@pytest.fixture(scope="module")
def transducer():
    conf = dict(output_size=32, attention_heads=2, linear_units=64,
                num_blocks=1, cnn_module_kernel=15, input_layer="linear",
                selfattention_layer_type="rel_selfattn")
    enc_conf = j_factory.encoder_conf_from_yaml(conf, 16)
    pred = dict(embed_size=32, hidden_size=32, output_size=32, num_layers=2)
    jm = JTransducer(vocab_size=V, encoder_conf=enc_conf,
                     predictor_conf=pred, joint_conf=dict(join_dim=32))
    rng = np.random.RandomState(3)
    feats = rng.randn(1, 9, 16).astype(np.float32)
    lens = np.asarray([9], np.int32)
    labels = np.asarray([[1, 2]], np.int32)
    params = seeded_params(jm, np.random.RandomState(4), jnp.asarray(feats),
                           jnp.asarray(lens), jnp.asarray(labels),
                           jnp.asarray([2], np.int32))
    tm = TTransducer(V, enc_conf, predictor_conf=pred,
                     joint_conf=dict(join_dim=32))
    tm.load_state_dict(state_dict_from_jax(params))
    tm.eval()
    with torch.no_grad():
        enc, _ = tm.forward_encoder(torch.from_numpy(feats),
                                    torch.from_numpy(lens))
    pj, jj, ij = j_rnnt.make_transducer_step_fns(jm, params)
    jfns = (functools.partial(pj, params), functools.partial(jj, params), ij)
    return jfns, t_rnnt.make_transducer_step_fns(tm), enc[0]


@pytest.mark.parametrize("stype", SEARCHES)
def test_searches_on_a_transducer(transducer, stype):
    """The LSTM predictor steps through the port's K3 wrapper (its plain
    version on the CPU); the encoder output is the port's, given to both."""
    jfns, tfns, enc = transducer
    _both(jfns, tfns, jnp.asarray(enc.numpy()), enc, stype, beam_size=3)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_maes_expansion_selection_matches_jax(seed):
    """``_select_k_expansions`` (numpy in the port, a Python walk in JAX)
    on float32 rows with repeated values: the same tokens, order and
    scores."""
    rng = np.random.RandomState(seed)
    logps = np.round(rng.randn(3, 50), 1).astype(np.float32)
    hyps = [j_esp.Hypothesis(score=float(s), yseq=[0], pred_out=None,
                             state_idx=0) for s in (-1.5, 0.0, -0.25)]
    want = j_esp._select_k_expansions(hyps, logps, 4, 2.3, 2)
    got = t_esp._select_k_expansions(hyps, logps, 4, 2.3, 2)
    assert got == want and all(len(w) == 6 for w in want)
