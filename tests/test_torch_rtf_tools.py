"""The port's RTF harnesses on the CPU at tiny sizes, against the JAX
package where the two compute the same thing.

* ``bin/encoder_rtf.py`` (one run and the sweep mode) and
  ``bin/decode_rtf.py`` (both modes) with ``--device cpu``: their ``.rtf``
  lines carry JAX's keys in JAX's order (JAX ``bin/encoder_rtf.py:136-145``,
  ``bin/decode_rtf.py:152-163``), and the sweep's rows are
  ``tools/rtf_tables.aggregate``'s.
* ``tools/rtf_tables``: ``aggregate`` and the printed table equal JAX's on
  the same files.
* ``bin/beam_bench.py``: the CLI runs both merges, and its toy predictor
  and joint in the port's device beam give JAX ``rnnt_beam_search``'s
  beam (tokens identical, scores within 1e-5) on the same numpy weights
  and posteriors, in f32.
* ``bin/scan_op_bench.py``: every component runs; ``approx_topk`` raises.
* Every CLI this slice adds raises without ``--device cpu`` when no card
  is present.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paper_accurate_fast_cheap_tpu.decode import rnnt_search as j_rnnt
from paper_accurate_fast_cheap_tpu.tools import rtf_tables as j_tables
from paper_accurate_fast_cheap_tpu_torch.bin import (
    align, beam_bench, compute_cmvn_stats, compute_fbank_feats, decode_rtf,
    encoder_rtf, scan_op_bench, write_embeddings)
from paper_accurate_fast_cheap_tpu_torch.decode import rnnt_search as t_rnnt
from paper_accurate_fast_cheap_tpu_torch.tools import rtf_tables as t_tables

ENC_KEYS = ["model", "final_rtf", "minutes_audio_per_sec", "batch",
            "warmup_plus_compile_s", "max_cpu_ram_mb", "max_vram_mb",
            "device"]
DEC_KEYS = ["model", "final_rtf", "minutes_audio_per_sec", "batch", "beam",
            "fuse", "warmup_plus_compile_s", "max_cpu_ram_mb",
            "max_vram_mb", "device"]
ENCODER = dict(output_size=32, attention_heads=2, linear_units=32,
               num_blocks=2, cnn_module_kernel=7,
               selfattention_layer_type="rwkv_tmix60_bidirectional")


def _keys_in_order(text, keys):
    firsts = [ln.split()[0] for ln in text.splitlines() if ln.strip()]
    assert [k for k in firsts if k in keys] == keys, firsts


@pytest.fixture(scope="module")
def configs(tmp_path_factory):
    d = tmp_path_factory.mktemp("rtf")
    common = {"vocab_size_for_bench": 40, "encoder": "conformer",
              "encoder_conf": ENCODER,
              "dataset_conf": {"fbank_conf": {"num_mel_bins": 80}}}
    enc = d / "tiny_enc.json"
    enc.write_text(json.dumps(dict(common, model="asr_model",
                                   model_conf={"ctc_weight": 1.0})))
    dec = d / "tiny_trans.json"
    dec.write_text(json.dumps(dict(
        common, model="transducer", predictor="rnn",
        predictor_conf={"embed_size": 16, "hidden_size": 16,
                        "output_size": 16, "num_layers": 2},
        joint_conf={"join_dim": 16})))
    return d, enc, dec


def test_encoder_rtf_cli(configs, capsys):
    d, enc, _ = configs
    out = d / "one.rtf"
    assert encoder_rtf.main(["--config", str(enc), "--batch_size", "2",
                             "--chunk_size", "64", "--warmup", "1",
                             "--iters", "2", "--output", str(out),
                             "--device", "cpu"]) == 0
    text = out.read_text()
    _keys_in_order(text, ENC_KEYS)
    assert "model tiny_enc\n" in text and "batch 2 chunk 64 iters 2\n" in text
    assert t_tables.parse_rtf_file(str(out))["final_rtf"] > 0
    sweep = d / "sweep"
    capsys.readouterr()
    assert encoder_rtf.main(["--config", str(enc), "--sweep_batches", "1,2",
                             "--sweep_chunks", "48,64", "--warmup", "1",
                             "--iters", "1", "--sweep_dir", str(sweep),
                             "--no-bf16", "--device", "cpu"]) == 0
    files = sorted(str(p) for p in sweep.glob("*.rtf"))
    assert len(files) == 4
    rows = t_tables.aggregate(files)
    assert [(r["batch"], r["chunk"]) for r in rows] == [
        (1, 48), (1, 64), (2, 48), (2, 64)]
    printed = capsys.readouterr().out
    for r in rows:
        assert str(r) in printed


@pytest.mark.parametrize("mode", ["rnnt_beam_search", "ctc_greedy_search"])
def test_decode_rtf_cli(configs, mode):
    d, _, dec = configs
    out = d / f"{mode}.rtf"
    assert decode_rtf.main(["--config", str(dec), "--mode", mode,
                            "--batch_size", "2", "--chunk_size", "48",
                            "--beam_size", "3", "--warmup", "1", "--iters",
                            "1", "--output", str(out), "--fuse", "on",
                            "--device", "cpu"]) == 0
    text = out.read_text()
    _keys_in_order(text, DEC_KEYS)
    assert f"model tiny_trans.decode_{mode}\n" in text
    assert "fuse on beam_unroll 1\n" in text


def test_rtf_tables_match_jax(tmp_path, capsys):
    rows = [("m1", 4, 9000, 0.001), ("m1", 4, 9000, 0.0012),
            ("m1", 1, 2000, 0.003), ("m2", 4, 9000, 0.0005)]
    for i, (m, b, c, rtf) in enumerate(rows):
        (tmp_path / f"r{i}.rtf").write_text(
            f"model {m}\nfinal_rtf {rtf:.8f}\nminutes_audio_per_sec 1.0\n"
            f"batch {b} chunk {c} iters 10\nmax_cpu_ram_mb 12.5\n")
    (tmp_path / "bad.rtf").write_text("model m3\nbatch 1 chunk 1 iters 1\n")
    paths = sorted(str(p) for p in tmp_path.glob("*.rtf"))
    assert t_tables.aggregate(paths) == j_tables.aggregate(paths)
    for p in paths:
        assert t_tables.parse_rtf_file(p) == j_tables.parse_rtf_file(p)
    pattern = str(tmp_path / "*.rtf")
    t_tables.main([pattern])
    t_out = capsys.readouterr().out
    j_tables.main([pattern])
    assert t_out == capsys.readouterr().out


def test_beam_bench_cli(capsys):
    for merge in ("sort", "pairwise"):
        assert beam_bench.main(["--batch_size", "2", "--frames", "10",
                                "--vocab", "30", "--enc_dim", "16",
                                "--pred_dim", "16", "--beam_size", "3",
                                "--warmup", "1", "--iters", "1", "--merge",
                                merge, "--device", "cpu"]) == 0
        out = capsys.readouterr().out
        assert f"merge={merge} unroll=1 B=2 T=10 beam=3:" in out
        assert "ms/frame" in out


@pytest.mark.parametrize("merge", ["sort", "pairwise"])
def test_beam_bench_toy_beam_matches_jax(merge):
    """The toy model of both harnesses, in f32, through both device beams."""
    rng = np.random.RandomState(7)
    B, T, V, De, H, N = 2, 14, 24, 16, 16, 4
    enc = rng.randn(B, T, De).astype(np.float32)
    logits = rng.randn(B, T, V)
    logits[..., 0] += 4.0
    ctc = (logits - np.log(np.exp(logits).sum(-1, keepdims=True))).astype(
        np.float32)
    w = {"E": rng.randn(V, H), "W": rng.randn(H, H) * 0.02,
         "A": rng.randn(De, V) * 0.3, "Bm": rng.randn(H, V) * 0.3}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    lens = np.asarray([T, T - 4], np.int32)

    # JAX bin/beam_bench.py's toy predictor and joint
    def j_pred(p, tokens, state):
        s = jnp.tanh(state @ p["W"] + p["E"][tokens])
        return s, s

    def j_joint(p, enc_t, pred):
        z = (enc_t @ p["A"] + pred @ p["Bm"]).astype(jnp.float32)
        return jax.nn.log_softmax(z)

    want = j_rnnt.rnnt_beam_search(
        j_pred, j_joint, lambda n: jnp.zeros((n, H), jnp.float32),
        jnp.asarray(enc), jnp.asarray(lens), jnp.asarray(ctc), beam_size=N,
        blank_id=0, ctc_weight=0.3, transducer_weight=0.7, impl="device",
        params={k: jnp.asarray(v) for k, v in w.items()}, defer=True,
        merge=merge)
    got = t_rnnt.rnnt_beam_search(
        *beam_bench.toy_step_fns({k: torch.from_numpy(v)
                                  for k, v in w.items()}),
        torch.from_numpy(enc), torch.from_numpy(lens),
        torch.from_numpy(ctc), beam_size=N, blank_id=0, ctc_weight=0.3,
        transducer_weight=0.7, impl="device", defer=True, merge=merge)
    j_len = np.asarray(want["hyp_len"])
    assert np.array_equal(got["hyp_len"].numpy(), j_len)
    j_hyps = np.asarray(want["hyps"])
    for b in range(B):
        for n in range(N):
            assert np.array_equal(got["hyps"][b, n, :j_len[b, n]].numpy(),
                                  j_hyps[b, n, :j_len[b, n]])
    assert j_len.max() > 0
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(want["scores"]), atol=1e-5)


def test_scan_op_bench_components(capsys):
    small = ["--batch_size", "2", "--frames", "4", "--vocab", "300",
             "--enc_dim", "16", "--pred_dim", "16", "--beam_size", "4",
             "--warmup", "1", "--iters", "1", "--device", "cpu"]
    names = ["noop", "joint", "fuse", "topk", "lax_topk", "pallas_topk",
             "merge", "gather", "pred", "hypbuf", "bookkeep"]
    assert scan_op_bench.main(small + ["--only", ",".join(names)]) == 0
    out = capsys.readouterr().out
    for name in names:
        assert f"{name:12s}: " in out
    assert "sum(core)" in out
    with pytest.raises(NotImplementedError, match="TPU approximate op"):
        scan_op_bench.main(small + ["--only", "approx_topk"])


NEED_NO_FILES = {
    "encoder_rtf": (encoder_rtf, ["--config", "c.json"]),
    "decode_rtf": (decode_rtf, ["--config", "c.json"]),
    "beam_bench": (beam_bench, []),
    "scan_op_bench": (scan_op_bench, []),
    "align": (align, ["--config", "c.json", "--checkpoint", "m.pt",
                      "--input_data", "d.list", "--output", "a.ctm"]),
    "compute_fbank_feats": (compute_fbank_feats, ["w.scp", "f.ark",
                                                  "f.scp"]),
    "compute_cmvn_stats": (compute_cmvn_stats, ["--data", "d.list",
                                                "--out_cmvn", "c.json"]),
    "write_embeddings": (write_embeddings, [
        "--config", "c.json", "--checkpoint", "m.pt", "--test_data",
        "d.list", "--output_name", "emb"]),
}


@pytest.mark.parametrize("cli", list(NEED_NO_FILES))
def test_cli_needs_the_card_or_cpu(cli):
    """Without --device cpu the CLI asks for the card before it reads
    anything (the paths need not exist)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI would run on it")
    mod, argv = NEED_NO_FILES[cli]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main(argv)


def test_profiling_utils(tmp_path):
    """utils/profiling on the CPU: the trace file and a named range, the
    card's memory stats empty without a card, the timer's arithmetic as
    JAX's on the same times, the RSS monitor."""
    from paper_accurate_fast_cheap_tpu.utils import profiling as j_prof
    from paper_accurate_fast_cheap_tpu_torch.utils import profiling as t_prof

    with t_prof.trace(str(tmp_path / "prof")) as prof:
        with t_prof.annotate("tiny_matmul"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    assert "tiny_matmul" in {e.key for e in prof.key_averages()}
    assert t_prof.device_memory_stats("cpu") == {}
    t_t, j_t = t_prof.StepTimer(), j_prof.StepTimer()
    t_t.times = j_t.times = [0.5, 0.2, 0.3]
    assert (t_t.mean(), t_t.rtf(2.0)) == (j_t.mean(), j_t.rtf(2.0))
    assert t_t.mean(skip_warmup=5) == j_t.mean(skip_warmup=5)
    with t_prof.MemoryMonitor(interval_s=0.01) as mon:
        pass
    assert mon.max_rss_mb > 0
