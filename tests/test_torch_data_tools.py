"""The port's data tools against the JAX package's, on one tiny seeded
checkpoint.

A tiny CTC model (a rel-pos MHA conformer, 2 blocks, width 32, static
chunk 8, whitespace units, global JSON CMVN) is initialised once in JAX
and loaded into the port through ``convert.state_dict_from_jax``.  The JAX
CLIs' ``main`` run as they are, with ``build_decode_assets`` handing them
this fixture's model and parameters (so JAX's model init is paid once);
the port's CLIs run with ``--device cpu`` on the saved state_dict.  Three
WAVs (tone bursts over noise, 1.3-2.4 s):

* ``bin/align.py``: the CTM and the per-frame path files byte-identical;
* ``bin/compute_fbank_feats.py`` (whole files and segments): the same
  keys, shapes and scp offsets, matrices within 1e-3 wherever the mel
  energy is above e^2 (one quiet frame's lowest bins are held relative to
  the frame's energy instead);
* ``bin/compute_cmvn_stats.py``: the frame count equal, the sums within
  1e-6 relative but for the bin of the quiet frame above (1e-5);
* ``bin/write_embeddings.py --build_index``: ``sample_names`` identical,
  each layer within 1e-4 of its scale, and the indexes' names and
  vectors;
* ``data/kaldi_io``: every writer's bytes equal JAX's, and each reader
  reads the other package's files (ASCII and compressed matrices too);
* ``ops/ctc_utils.get_blank_id`` and ``tools/vector_index`` (exact and IVF
  hits, identical to JAX's).
"""
import functools
import io
import json
import os
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paper_accurate_fast_cheap_tpu.bin import align as j_align
from paper_accurate_fast_cheap_tpu.bin import compute_cmvn_stats as j_cmvn
from paper_accurate_fast_cheap_tpu.bin import compute_fbank_feats as j_fbank
from paper_accurate_fast_cheap_tpu.bin import recognize as j_recognize
from paper_accurate_fast_cheap_tpu.bin import write_embeddings as j_emb
from paper_accurate_fast_cheap_tpu.data import kaldi_io as j_kio
from paper_accurate_fast_cheap_tpu.frontend import cmvn as j_cmvn_lib
from paper_accurate_fast_cheap_tpu.frontend.features import fbank as j_fb
from paper_accurate_fast_cheap_tpu.frontend.pipeline import (
    make_feature_fn as j_make_feature_fn)
from paper_accurate_fast_cheap_tpu.models import factory as j_factory
from paper_accurate_fast_cheap_tpu.ops import ctc_utils as j_ctc
from paper_accurate_fast_cheap_tpu.text.tokenizers import (
    init_tokenizer as j_init_tokenizer)
from paper_accurate_fast_cheap_tpu.tools import vector_index as j_vi
from paper_accurate_fast_cheap_tpu_torch.bin import align as t_align
from paper_accurate_fast_cheap_tpu_torch.bin import (
    compute_cmvn_stats as t_cmvn)
from paper_accurate_fast_cheap_tpu_torch.bin import (
    compute_fbank_feats as t_fbank)
from paper_accurate_fast_cheap_tpu_torch.bin import write_embeddings as t_emb
from paper_accurate_fast_cheap_tpu_torch.convert import state_dict_from_jax
from paper_accurate_fast_cheap_tpu_torch.data import kaldi_io as t_kio
from paper_accurate_fast_cheap_tpu_torch.ops import ctc_utils as t_ctc
from paper_accurate_fast_cheap_tpu_torch.tools import vector_index as t_vi

VOCAB = 30


def _wav_bytes(wav):
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((wav * 32767).astype(np.int16).tobytes())
    return buf.getvalue()


class _Jitted:
    """A flax model whose ``apply(params, ..., method=model.<name>)`` for
    the encoder and the CTC head runs jitted (the JAX align CLI applies
    them eagerly, op by op); other methods pass through."""

    def __init__(self, model):
        self._m = model
        self._fns = {name: jax.jit(functools.partial(
            self._apply, method=getattr(model, name)))
            for name in ("forward_encoder", "ctc_logprobs")}
        for name in self._fns:
            setattr(self, name, name)

    def _apply(self, params, *args, method):
        return self._m.apply(params, *args, method=method)

    def apply(self, params, *args, method):
        if isinstance(method, str):
            return self._fns[method](params, *args)
        return self._m.apply(params, *args, method=method)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    d = tmp_path_factory.mktemp("data_tools")
    units = d / "units.txt"
    units.write_text("<blank> 0\n<unk> 1\n" + "".join(
        f"{'▁w' if i % 3 == 0 else 'c'}{i} {i}\n" for i in range(2, VOCAB)))
    rng = np.random.RandomState(21)
    lines, scp, waves = [], [], []
    for i, secs in enumerate((2.4, 1.3, 1.9)):
        t = np.arange(int(16000 * secs)) / 16000.0
        pitch = rng.uniform(150, 3000, t.size // 3200 + 1).repeat(3200)
        wav = (0.3 * np.sin(np.pi * (t * 5 % 1.0)) ** 2
               * np.sin(2 * np.pi * np.cumsum(pitch[:t.size]) / 16000)
               + rng.randn(t.size) * 0.01).astype(np.float32)
        path = d / f"utt{i}.wav"
        path.write_bytes(_wav_bytes(wav))
        waves.append(wav)
        lines.append(json.dumps({"key": f"utt{i}", "wav": str(path),
                                 "txt": "c4 ▁w6 c7 c8"}))
        scp.append(f"utt{i} {path}\n")
    (d / "data.list").write_text("\n".join(lines) + "\n")
    (d / "wav.scp").write_text("".join(scp))
    (d / "segments").write_text("seg0 utt0 0.10 1.30\nseg1 utt2 0.5 1.9\n")
    feats = np.concatenate([np.asarray(j_fb(jnp.asarray(w) * 32768.0),
                                       np.float64) for w in waves])
    cmvn = d / "cmvn.json"
    cmvn.write_text(json.dumps({"mean_stat": feats.sum(0).tolist(),
                                "var_stat": (feats ** 2).sum(0).tolist(),
                                "frame_num": len(feats)}))
    config = {
        "model": "asr_model", "encoder": "conformer",
        "encoder_conf": dict(output_size=32, attention_heads=2,
                             linear_units=32, num_blocks=2,
                             cnn_module_kernel=7, static_chunk_size=8),
        "model_conf": {"ctc_weight": 1.0},
        "tokenizer": "whitespace",
        "tokenizer_conf": {"symbol_table_path": str(units)},
        "cmvn": "global_cmvn",
        "cmvn_conf": {"cmvn_file": str(cmvn), "is_json_cmvn": True},
        "dataset_conf": {"fbank_conf": {"num_mel_bins": 80, "frame_shift": 10,
                                        "frame_length": 25, "dither": 1.0}},
    }
    cfg = d / "conf.json"
    cfg.write_text(json.dumps(config))
    model, model_type = j_factory.init_model(config, VOCAB, 80)
    params = jax.tree.map(np.array, jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 80)), jnp.asarray([64]),
        jnp.ones((1, 4), jnp.int32), jnp.asarray([4])))
    params["params"]["ctc"]["ctc_lo"]["kernel"] *= 3.0
    pt = d / "model.pt"
    torch.save(state_dict_from_jax(params), str(pt))
    params = jax.tree.map(jnp.asarray, params)

    def jax_assets(config, checkpoint, input_dim=80):
        """The JAX CLIs' assets on this fixture's model and parameters
        (JAX's ``build_decode_assets`` less its model init and restore)."""
        conf = dict(config["dataset_conf"], spec_aug=False, spec_sub=False,
                    speed_perturb=False)
        conf["fbank_conf"] = dict(conf["fbank_conf"], dither=0.0)
        stats = j_cmvn_lib.load_cmvn(str(cmvn), True)
        return (j_init_tokenizer(config), _Jitted(model), model_type, params,
                j_make_feature_fn(conf, stats), conf)

    return dict(d=d, cfg=cfg, pt=pt, jax_assets=jax_assets)


def test_align_ctm_matches_jax_cli(assets, monkeypatch):
    d = assets["d"]
    monkeypatch.setattr(j_recognize, "build_decode_assets",
                        assets["jax_assets"])
    common = ["--config", str(assets["cfg"]), "--input_data",
              str(d / "data.list")]
    assert j_align.main(common + [
        "--checkpoint", "unused", "--output", str(d / "j.ctm"),
        "--frames_path", str(d / "j.frames")]) == 0
    assert t_align.main(common + [
        "--checkpoint", str(assets["pt"]), "--output", str(d / "t.ctm"),
        "--frames_path", str(d / "t.frames"), "--device", "cpu"]) == 0
    want = (d / "j.ctm").read_bytes()
    assert want.count(b"\n") == 12
    assert (d / "t.ctm").read_bytes() == want
    assert (d / "t.frames").read_bytes() == (d / "j.frames").read_bytes()


@pytest.mark.parametrize("segments", [False, True])
def test_fbank_ark_matches_jax_cli(assets, segments):
    d = assets["d"]
    extra = ["--segments", str(d / "segments")] if segments else []
    out = {}
    for side, mod, dev in (("j", j_fbank, []), ("t", t_fbank,
                                                ["--device", "cpu"])):
        ark, scp = d / f"{side}{segments}.ark", d / f"{side}{segments}.scp"
        assert mod.main([str(d / "wav.scp"), str(ark), str(scp)] + extra
                        + dev) == 0
        out[side] = (dict(j_kio.read_ark(str(ark))),
                     [ln.split()[0] + " " + ln.rsplit(":", 1)[1]
                      for ln in scp.read_text().splitlines()])
    (j_mats, j_scp), (t_mats, t_scp) = out["j"], out["t"]
    assert list(t_mats) == list(j_mats) and t_scp == j_scp
    assert len(j_mats) == (2 if segments else 3)
    for k in j_mats:
        t, j = t_mats[k], j_mats[k]
        assert t.dtype == np.float32 and t.shape == j.shape
        # 1e-3 on the log-mel wherever the bin's energy is above e^2.  In a
        # quiet frame's lowest bins (1 entry of these 15040: log-mel -0.89,
        # the bin's mean 9.98) the two f32 FFTs' rounding, which scales
        # with the frame's energy, exceeds it (0.027); every entry's mel
        # energy is held to 1e-5 of its frame's total (1.5e-6 measured)
        loud = j >= 2.0
        assert loud.mean() > 0.999
        np.testing.assert_allclose(t[loud], j[loud], atol=1e-3)
        e_t, e_j = np.exp(t.astype(np.float64)), np.exp(j.astype(np.float64))
        assert np.all(np.abs(e_t - e_j)
                      <= 1e-5 * e_j.sum(-1, keepdims=True))


def test_cmvn_stats_match_jax_cli(assets):
    d = assets["d"]
    common = ["--data", str(d / "data.list"), "--data_type", "raw"]
    assert j_cmvn.main(common + ["--out_cmvn", str(d / "j.json")]) == 0
    assert t_cmvn.main(common + ["--out_cmvn", str(d / "t.json"),
                                 "--device", "cpu"]) == 0
    want = json.loads((d / "j.json").read_text())
    got = json.loads((d / "t.json").read_text())
    assert got["frame_num"] == want["frame_num"] > 0
    # the fbank test's quiet-frame entry (0.027 off) moves its bin's sum
    # by 4.4e-6 relative; every other bin agrees within 1e-6
    for k in ("mean_stat", "var_stat"):
        rel = np.abs(np.subtract(got[k], want[k])) / np.abs(want[k])
        assert rel.max() <= 1e-5 and np.sum(rel > 1e-6) <= 1, rel.max()


def test_write_embeddings_match_jax_cli(assets, monkeypatch):
    d = assets["d"]
    monkeypatch.setattr(j_recognize, "build_decode_assets",
                        assets["jax_assets"])
    common = ["--config", str(assets["cfg"]), "--test_data",
              str(d / "data.list"), "--data_type", "raw", "--batch_size",
              "2", "--build_index", "--index_nlist", "2"]
    assert j_emb.main(common + ["--checkpoint", "unused", "--output_name",
                                str(d / "j_emb")]) == 0
    assert t_emb.main(common + ["--checkpoint", str(assets["pt"]),
                                "--output_name", str(d / "t_emb"),
                                "--device", "cpu"]) == 0
    names = (d / "j_emb" / "sample_names").read_text()
    assert (d / "t_emb" / "sample_names").read_text() == names
    assert sorted(names.split()) == ["utt0", "utt1", "utt2"]
    for i in range(2):
        want = np.loadtxt(d / "j_emb" / f"embeddings_layer_{i}")
        got = np.loadtxt(d / "t_emb" / f"embeddings_layer_{i}")
        assert got.shape == want.shape == (3, 32)
        # 1e-4 of the layer's scale (the quiet frame's feature reaches it:
        # 1.0e-4 at a largest magnitude of 1.3)
        np.testing.assert_allclose(got, want,
                                   atol=1e-4 * np.abs(want).max())
        j_idx = j_vi.VectorIndex.load(str(d / "j_emb" /
                                          f"index_layer_{i}.npz"))
        t_idx = t_vi.VectorIndex.load(str(d / "t_emb" /
                                          f"index_layer_{i}.npz"))
        assert t_idx.names == j_idx.names and t_idx.nlist == j_idx.nlist
        np.testing.assert_allclose(t_idx._vecs, j_idx._vecs, atol=1e-4)
    assert not (d / "t_emb" / "embeddings_layer_2").exists()


def test_kaldi_io_round_trips(tmp_path):
    rng = np.random.RandomState(3)
    m32 = rng.randn(7, 5).astype(np.float32)
    m64 = rng.randn(3, 4)
    vi = rng.randint(-5, 50, 9).astype(np.int32)
    v32 = rng.randn(6).astype(np.float32)
    v64 = rng.randn(4)
    cm = rng.randn(40, 6).astype(np.float32) * 3

    def write_all(kio, path):
        with open(path, "wb") as f:
            offs = [kio.write_mat(f, m32, "a"), kio.write_mat(f, m64, "b"),
                    kio.write_vec_int(f, vi, "c"),
                    kio.write_vec_flt(f, v32, "d"),
                    kio.write_vec_flt(f, v64, "e"),
                    kio.write_compressed_mat(f, cm, "f")]
        return offs

    jp, tp = str(tmp_path / "j.ark"), str(tmp_path / "t.ark")
    offs = write_all(t_kio, tp)
    assert write_all(j_kio, jp) == offs
    with open(tp, "rb") as f, open(jp, "rb") as g:
        assert f.read() == g.read()
    readers = ("read_mat", "read_mat", "read_vec_int", "read_vec_flt",
               "read_vec_flt", "read_mat")
    decoded = []
    for kio in (t_kio, j_kio):
        with open(tp, "rb") as f:
            for off, name in zip(offs, readers):
                f.seek(off)
                decoded.append(getattr(kio, name)(f))
    for got, want in zip(decoded[:5] + decoded[6:11],
                         [m32, m64, vi, v32, v64] * 2):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(decoded[5], decoded[11])
    np.testing.assert_allclose(decoded[5], cm, atol=0.2)
    # arks and scps across the packages, an ASCII matrix included
    mats = {"u1": m32, "u2": rng.randn(2, 5).astype(np.float32)}
    t_kio.write_ark_scp(str(tmp_path / "t2.ark"), mats,
                        str(tmp_path / "t2.scp"))
    j_kio.write_ark_scp(str(tmp_path / "j2.ark"), mats,
                        str(tmp_path / "j2.scp"))
    assert ((tmp_path / "t2.ark").read_bytes()
            == (tmp_path / "j2.ark").read_bytes())
    for reader in (t_kio.read_scp, j_kio.read_scp):
        for k, m in reader(str(tmp_path / "t2.scp")):
            np.testing.assert_array_equal(m, mats[k])
    (tmp_path / "a.ark").write_bytes(
        b"x1  [\n 1 2 3\n 4 5 6 ]\nx2 [ 7 8 ]\n")
    t_read = list(t_kio.read_ark(str(tmp_path / "a.ark")))
    j_read = list(j_kio.read_ark(str(tmp_path / "a.ark")))
    assert [k for k, _ in t_read] == [k for k, _ in j_read] == ["x1", "x2"]
    for (_, a), (_, b) in zip(t_read, j_read):
        np.testing.assert_array_equal(a, b)
    with open(tmp_path / "v.ark", "wb") as f:
        j_kio.write_vec_int(f, vi, "k1")
        j_kio.write_vec_int(f, vi[::-1], "k2")
    assert [(k, v.tolist()) for k, v in t_kio.read_ali_ark(
        str(tmp_path / "v.ark"))] == [("k1", vi.tolist()),
                                      ("k2", vi[::-1].tolist())]


def test_get_blank_id():
    for conf, table in (({}, {}), ({}, {"<blank>": 3}),
                        ({"ctc_conf": {"ctc_blank_id": 5}}, {"<blank>": 3}),
                        ({"ctc_conf": {}}, {"<b>": 1})):
        assert t_ctc.get_blank_id(conf, table) == j_ctc.get_blank_id(
            conf, table)


@pytest.mark.parametrize("nlist", [0, 8])
def test_vector_index_hits_match_jax(tmp_path, nlist):
    rng = np.random.RandomState(4)
    vecs = rng.randn(300, 16).astype(np.float32)
    names = [f"n{i}" for i in range(300)]
    t_idx, j_idx = t_vi.VectorIndex(16, nlist), j_vi.VectorIndex(16, nlist)
    for idx in (t_idx, j_idx):
        idx.add(names[:200], vecs[:200])
        idx.add(names[200:], vecs[200:], [f"p{i}" for i in range(100)])
    path = str(tmp_path / "t.npz")
    t_idx.save(path)
    loaded = j_vi.VectorIndex.load(path)
    for q in rng.randn(5, 16):
        want = [(h.name, h.payload) for h in j_idx.search(q, k=7, nprobe=3)]
        assert [(h.name, h.payload)
                for h in t_idx.search(q, k=7, nprobe=3)] == want
        assert [(h.name, h.payload)
                for h in loaded.search(q, k=7, nprobe=3)] == want
    os.remove(path)
