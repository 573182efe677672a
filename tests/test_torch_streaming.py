"""The port's streaming surface against the JAX package's.

Causal CTC models (2 blocks, d = 32, 23 mel bins, f32), the JAX package's
weights carried by ``convert.state_dict_from_jax``:
- streaming encoders: the uni RWKV (its WKV state through K1's wrapper) and
  the uni Mamba-2 equal their full forward, at two chunk sizes, and JAX's
  chunked output, within 1e-4; the MHA KV cache (``att_cache_size`` 16)
  against JAX's chunked output;
- sessions: ``StreamingSession`` and ``StreamingBatch`` (staggered joins,
  three lengths, a reused slot) finals identical to the offline greedy CTC
  of the whole utterance and to the JAX session's tokens; the batch refuses
  MHA;
- serving: ``api.Model.from_dir`` on a model directory, and one websocket
  round trip each way through ``bin/serve.py`` and ``bin/ws_client.py`` on
  localhost (per-connection sessions and a ``--streaming_batch`` slot):
  the streaming text equals the session's, the whole-buffer text
  ``transcribe_batch``'s;
- ``bin/streaming_bench.py`` on the CPU, both modes, with JAX's report keys.
"""
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paper_accurate_fast_cheap_tpu import streaming as j_streaming
from paper_accurate_fast_cheap_tpu.decode import streaming as j_dstream
from paper_accurate_fast_cheap_tpu.frontend.pipeline import (
    make_feature_fn as j_feature_fn)
from paper_accurate_fast_cheap_tpu.models import factory as j_factory
from paper_accurate_fast_cheap_tpu.models.conformer import (
    ConformerEncoder as JEncoder)
from paper_accurate_fast_cheap_tpu_torch import api
from paper_accurate_fast_cheap_tpu_torch import streaming as t_streaming
from paper_accurate_fast_cheap_tpu_torch.bin import serve as t_serve
from paper_accurate_fast_cheap_tpu_torch.bin import streaming_bench
from paper_accurate_fast_cheap_tpu_torch.bin import ws_client
from paper_accurate_fast_cheap_tpu_torch.convert import state_dict_from_jax
from paper_accurate_fast_cheap_tpu_torch.decode import search as t_search
from paper_accurate_fast_cheap_tpu_torch.decode import (
    streaming as t_dstream)
from paper_accurate_fast_cheap_tpu_torch.frontend.pipeline import (
    make_feature_fn as t_feature_fn)
from paper_accurate_fast_cheap_tpu_torch.models import factory as t_factory
from paper_accurate_fast_cheap_tpu_torch.models.conformer import (
    ConformerEncoder as TEncoder)

MELS, VOCAB, C = 23, 11, 8
FBANK = {"fbank_conf": {"num_mel_bins": MELS, "frame_shift": 10,
                        "frame_length": 25, "dither": 0.0},
         "spec_aug": False, "spec_sub": False}
EXTRAS = {"rwkv": ("rwkv_tmix60", {"rwkv_do_bfloat16": False,
                                   "wkv_chunk_size": 16}),
          "mamba": ("mamba_att", {"rnn_att_direction": "uni"}),
          "mha": ("rel_selfattn", {})}


class _Tok:
    def detokenize(self, ids):
        return " ".join(f"T{i}" for i in ids), [f"T{i}" for i in ids]

    def vocab_size(self):
        return VOCAB


def _config(family: str) -> dict:
    att, extras = EXTRAS[family]
    return {"model": "asr_model", "encoder": "conformer",
            "encoder_conf": dict(
                output_size=32, attention_heads=2, linear_units=64,
                num_blocks=2, dropout_rate=0.0, positional_dropout_rate=0.0,
                selfattention_layer_type=att, causal=True,
                input_layer="conv2d", cnn_module_kernel=7, **extras),
            "decoder": None, "model_conf": {"ctc_weight": 1.0}}


@pytest.fixture(scope="module")
def families():
    """Per family (rwkv, mamba): the JAX model, its weights (numpy) and the
    port's model on them, one JAX init each."""
    out = {}
    for fam in ("rwkv", "mamba"):
        model, _ = j_factory.init_model(_config(fam), VOCAB, MELS)
        params = jax.tree.map(np.array, model.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 64, MELS)),
            jnp.asarray([64]), jnp.ones((1, 4), jnp.int32),
            jnp.asarray([4])))
        tmodel, _ = t_factory.init_model(_config(fam), VOCAB, MELS,
                                         device="cpu")
        tmodel.load_state_dict(state_dict_from_jax(params))
        out[fam] = (model, jax.tree.map(jnp.asarray, params), tmodel)
    return out


def _wav(seed, t_frames):
    n = (t_frames - 1) * 160 + 400
    return (np.random.RandomState(seed).randn(n) * 0.1).astype(np.float32)


def _port_offline(tmodel, featurize, wav):
    with torch.no_grad():
        feats, flens = featurize(torch.from_numpy(wav[None]),
                                 torch.tensor([len(wav)]))
        enc, el = tmodel.forward_encoder(feats, flens)
        logp = tmodel.ctc_logprobs(enc)
    return t_search.ctc_greedy_search(logp.numpy(), el.numpy())[0].tokens


def _chunked(enc_fn, **kw):
    def apply(xs, lens, state, offset):
        return enc_fn(xs, lens, streaming_state=state, return_state=True,
                      offset=offset, **kw)
    return apply


@pytest.mark.parametrize("fam", ["rwkv", "mamba"])
def test_streaming_encoder_matches_full_and_jax(families, fam):
    model, params, tmodel = families[fam]
    feats = np.random.RandomState(2).randn(1, 135, MELS).astype(np.float32)
    tf = torch.from_numpy(feats)
    with torch.no_grad():
        full, flen = tmodel.encoder(tf, torch.tensor([135]))
        outs = {c: t_dstream.forward_chunk_by_chunk(
            _chunked(tmodel.encoder), tf, c) for c in (8, 4)}

    def j_enc(xs, lens, **kw):
        return model.apply(params, xs, lens, method=lambda m, *a: m.encoder(
            *a, **kw))

    jys, jl = j_dstream.forward_chunk_by_chunk(
        _chunked(j_enc), jnp.asarray(feats), 8)
    n = int(outs[8][1][0])
    assert n > 0 and n == int(jl[0])
    np.testing.assert_allclose(outs[8][0][0, :n].numpy(),
                               np.asarray(jys)[0, :n], atol=1e-4)
    for c, (ys, ln) in outs.items():
        m = min(int(ln[0]), int(flen[0]))
        np.testing.assert_allclose(ys[0, :m].numpy(), full[0, :m].numpy(),
                                   atol=1e-4)


def test_mha_kv_cache_matches_jax():
    """rel_selfattn, causal conv, a 16-key cache over chunks of 8: the
    port's chunked output equals JAX's (positions from offset - 16, zero
    rows before 0)."""
    kw = dict(input_size=16, output_size=32, attention_heads=2,
              linear_units=64, num_blocks=2,
              selfattention_layer_type="rel_selfattn", dropout_rate=0.0,
              positional_dropout_rate=0.0, causal=True)
    jenc = JEncoder(**kw)
    feats = np.random.RandomState(7).randn(1, 135, 16).astype(np.float32)
    params = jenc.init(jax.random.PRNGKey(8), jnp.asarray(feats),
                       jnp.asarray([135]))
    tenc = TEncoder(**kw).eval()
    tenc.load_state_dict(state_dict_from_jax(jax.tree.map(np.array,
                                                          params)))
    jys, jl = j_dstream.forward_chunk_by_chunk(
        _chunked(lambda *a, **k: jenc.apply(params, *a, **k),
                 att_cache_size=16), jnp.asarray(feats), 8)
    with torch.no_grad():
        tys, tl = t_dstream.forward_chunk_by_chunk(
            _chunked(tenc, att_cache_size=16),
            torch.from_numpy(feats), 8)
    n = int(jl[0])
    assert n > 16 and int(tl[0]) == n
    np.testing.assert_allclose(tys[0].numpy(), np.asarray(jys)[0, :n],
                               atol=1e-4)


@pytest.mark.parametrize("fam", ["rwkv", "mamba"])
def test_session_matches_offline_and_jax(families, fam):
    model, params, tmodel = families[fam]
    t_feat = t_feature_fn(FBANK, None, device="cpu")
    j_sessions = j_streaming.make_session_factory(
        model, params, _Tok(), j_feature_fn(FBANK, None),
        decoding_chunk_size=C)
    t_sessions = t_streaming.make_session_factory(
        tmodel, _Tok(), t_feat, decoding_chunk_size=C)
    # a 3-frame tail (below the context: dropped, as offline) and a
    # 20-frame tail (flushed through the padded window)
    for tail in (3, 20):
        wav = _wav(5, 4 * 3 * C + tail)
        offline = _port_offline(tmodel, t_feat, wav)
        sess = t_sessions()
        for p in np.array_split(wav, 7):
            sess.accept_waveform(p)
        final = sess.finalize()
        js = j_sessions()
        js.accept_waveform(wav)
        assert final.final and final.tokens == offline
        assert final.tokens == js.finalize().tokens
        assert len(final.times) == len(final.tokens)
        assert all(abs(t / 0.04 - round(t / 0.04)) < 1e-6
                   for t in final.times)
    assert final.tokens


def test_batch_matches_offline_and_jax(families):
    """Three utterances with staggered joins, then a new one in a freed
    slot: each final equals the offline greedy CTC and the JAX session's
    tokens."""
    model, params, tmodel = families["rwkv"]
    t_feat = t_feature_fn(FBANK, None, device="cpu")
    j_sessions = j_streaming.make_session_factory(
        model, params, _Tok(), j_feature_fn(FBANK, None),
        decoding_chunk_size=C)
    batch = t_streaming.StreamingBatch(tmodel, _Tok(), t_feat,
                                       max_sessions=3,
                                       decoding_chunk_size=C)
    wavs = [_wav(11, 4 * 3 * C + 20), _wav(12, 4 * 4 * C),
            _wav(13, 4 * 2 * C + 3)]
    sids = [batch.open() for _ in wavs]
    pieces = [list(np.array_split(w, 5)) for w in wavs]
    for rounds in range(7):
        for j, sid in enumerate(sids):
            if rounds >= j and pieces[j]:
                batch.accept_waveform(sid, pieces[j].pop(0))
        while batch.any_ready():
            batch.step()
    finals = [batch.finalize(sid) for sid in sids]
    w_new = _wav(14, 4 * 3 * C)
    sid = batch.open()
    batch.accept_waveform(sid, w_new)
    finals.append(batch.finalize(sid))
    for w, f in zip(wavs + [w_new], finals):
        js = j_sessions()
        js.accept_waveform(w)
        assert f.final
        assert f.tokens == _port_offline(tmodel, t_feat, w)
        assert f.tokens == js.finalize().tokens
    assert any(f.tokens for f in finals)


def test_batch_refuses_mha():
    tmodel, _ = t_factory.init_model(_config("mha"), VOCAB, MELS,
                                     device="cpu")
    with pytest.raises(ValueError, match="recurrent-attention"):
        t_streaming.StreamingBatch(tmodel, _Tok(), None)


@pytest.fixture(scope="module")
def model_dir(families, tmp_path_factory):
    """A model directory: train.yaml (char units), units.txt and the
    rwkv family's weights as the port's state_dict."""
    d = tmp_path_factory.mktemp("model")
    (d / "units.txt").write_text("".join(f"u{i} {i}\n"
                                         for i in range(VOCAB)))
    config = dict(_config("rwkv"), tokenizer="char",
                  tokenizer_conf={"symbol_table_path": "units.txt"},
                  dataset_conf=FBANK)
    (d / "train.yaml").write_text(json.dumps(config))
    torch.save(families["rwkv"][2].state_dict(), str(d / "epoch_0000.pt"))
    return d


def test_api_model_from_dir(model_dir, tmp_path, monkeypatch):
    monkeypatch.setenv("PAFC_HOME", str(tmp_path / "hub"))
    m = api.load_model(str(model_dir), device="cpu")
    wav = _wav(21, 4 * 3 * C)
    out = m.transcribe(wav, tokens_info=True)
    assert out["text"] == m.transcribe_batch([wav])[0]
    assert len(out["times"]) == len(out["token_ids"])
    # a name that is neither a model directory nor registered: the hub's
    # KeyError, as JAX's
    with pytest.raises(KeyError, match="unknown model 'wenetspeech'"):
        api.load_model("wenetspeech", device="cpu")


@pytest.mark.parametrize("streaming_batch", [0, 2])
def test_websocket_round_trip(model_dir, streaming_batch):
    m = api.load_model(str(model_dir), device="cpu")
    srv = t_serve.serve(m, host="127.0.0.1", port=0, streaming_chunk=C,
                        streaming_batch=streaming_batch)
    port = srv.server_address[1]
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    wav = _wav(31, 4 * 3 * C + 20)
    pcm = ws_client.pcm16(wav)
    wav_q = np.frombuffer(pcm, "<i2").astype(np.float32) / 32768.0
    sess = t_streaming.StreamingSession(m.model, m.tokenizer, m.featurize,
                                        decoding_chunk_size=C)
    sess.accept_waveform(wav_q)
    want = sess.finalize().text
    try:
        final, partials = ws_client.transcribe_pcm("127.0.0.1", port, pcm,
                                                   streaming=True)
        whole, _ = ws_client.transcribe_pcm("127.0.0.1", port, pcm)
    finally:
        srv.stop()
    assert want and final == want
    assert partials and partials[-1] == want
    assert whole == m.transcribe_batch([wav_q])[0]


@pytest.mark.parametrize("concurrent", [1, 2])
def test_streaming_bench_on_cpu(tmp_path, capsys, concurrent):
    cfg = tmp_path / "c.json"
    cfg.write_text(json.dumps(dict(_config("rwkv"), dataset_conf=FBANK,
                                   vocab_size_for_bench=VOCAB)))
    rep = streaming_bench.main([
        "--config", str(cfg), "--chunk", "4", "--utt_seconds", "1.5",
        "--n_utts", "1", "--no-bf16", "--device", "cpu",
        "--concurrent", str(concurrent), "--json",
        str(tmp_path / "r.jsonl")])
    keys = ["metric", "chunk", "stride_ms", "mode", "window_compute_ms",
            "streaming_rtf", "concurrent_realtime_sessions",
            "emission_latency_ms", "compile_s", "n_utts", "utt_seconds",
            "piece_ms", "device"]
    if concurrent > 1:
        keys.insert(1, "concurrent")
    assert list(rep) == keys
    assert rep["streaming_rtf"] > 0 and rep["stride_ms"] == 160.0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == json.loads(
        (tmp_path / "r.jsonl").read_text())
