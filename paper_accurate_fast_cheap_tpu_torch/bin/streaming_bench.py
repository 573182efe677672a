"""Streaming-decode latency and RTF benchmark (port of the JAX
``bin/streaming_bench.py``).

Measures the true-streaming serving path (``streaming.StreamingSession``:
fbank-exact sample windows, the encoder state carried, greedy-CTC partials)
at the reference's U2 streaming operating points (chunk 8/16, <= 480 ms
algorithmic latency) and reports:

- the per-window compute latency (p50/p90/p99/max/mean, ms);
- the streaming RTF (compute seconds per audio second) and its inverse
  (concurrent real-time sessions one card sustains);
- emission latency: a token's emission time against its own audio time
  (the greedy-CTC peak frame), FirstToken/LastToken/AvgToken percentiles.

Modes: by default the feed runs as fast as the card allows and emission is
derived as ``arrival of the window's last packet + the utterance's median
window compute - the token's audio time`` (exact while RTF < 1);
``--realtime`` paces the feed at real time and wall-clocks each partial.
``--concurrent N`` (N > 1) serves N sessions through ``StreamingBatch``
(one batched step advances all N windows) and reports the aggregate RTF.

Random weights (seed 0) unless ``--checkpoint`` names the port's
state_dict: latency and RTF do not depend on the weights.  ``causal: true``
is forced into the encoder conf (streaming needs the cached causal conv
module).  Runs on ``cuda`` unless ``--device cpu``; ``--platform`` is
accepted and does nothing.

Usage:
  python -m paper_accurate_fast_cheap_tpu_torch.bin.streaming_bench \\
      --config streaming.yaml --chunk 16 --utt_seconds 30 --n_utts 5 \\
      [--concurrent 8] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import logging
import sys
import time
from typing import List

import numpy as np
import torch

from paper_accurate_fast_cheap_tpu_torch import resolve_device


class _BenchTokenizer:
    def detokenize(self, ids):
        return " ".join(f"T{i}" for i in ids), [f"T{i}" for i in ids]


def get_args(argv=None):
    p = argparse.ArgumentParser(description="streaming latency benchmark")
    p.add_argument("--config", required=True)
    p.add_argument("--checkpoint", default=None,
                   help="the port's state_dict; random weights if omitted")
    p.add_argument("--chunk", type=int, default=16,
                   help="decoding chunk in encoder frames (ds4: 16 -> 640 "
                        "ms stride)")
    p.add_argument("--utt_seconds", type=float, default=30.0)
    p.add_argument("--n_utts", type=int, default=5)
    p.add_argument("--piece_ms", type=float, default=100.0,
                   help="simulated packet size (websocket frame)")
    p.add_argument("--realtime", action="store_true",
                   help="pace the feed at real time and wall-clock "
                        "emissions (utt_seconds wall per utterance)")
    p.add_argument("--concurrent", type=int, default=1,
                   help=">1: serve N sessions via StreamingBatch; reports "
                        "the aggregate streaming RTF")
    p.add_argument("--bf16", action="store_true", default=True)
    p.add_argument("--no-bf16", dest="bf16", action="store_false")
    p.add_argument("--json", dest="json_out", default=None,
                   help="also append the report as one JSON line here")
    p.add_argument("--platform", default=None,
                   help="accepted and unused (a JAX platform switch)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def _percentiles(vals: List[float]):
    a = np.asarray(vals, np.float64)
    return {"p50": float(np.percentile(a, 50)),
            "p90": float(np.percentile(a, 90)),
            "p99": float(np.percentile(a, 99)),
            "max": float(a.max()), "mean": float(a.mean())}


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _analytic_emits(refs, comp, args, sub, shift, flen, piece):
    """Emission wall times when the feed runs flat out: the window holding
    frame f is w = f // chunk; its last sample lands at packet boundary
    ceil(win_end / piece); add the utterance's median window compute."""
    out = []
    for f in [t / (sub * shift / 16000.0) for t in refs]:
        w = int(f) // args.chunk
        win_end = ((w + 1) * args.chunk * sub - 1) * shift + flen
        out.append(np.ceil(win_end / piece) * piece / 16000.0 + comp)
    return out


def _report(args, window_lat, per_utt, total_compute, total_audio,
            compile_s, stride_sec, dev, concurrent=None):
    from paper_accurate_fast_cheap_tpu_torch.tools import latency_metrics

    rtf = total_compute / total_audio
    report = {"metric": "streaming"}
    if concurrent is not None:
        report["concurrent"] = concurrent
    report.update({
        "chunk": args.chunk,
        "stride_ms": stride_sec * 1000.0,
        "mode": "realtime" if args.realtime else "analytic",
        "window_compute_ms": {k: v * 1000.0 for k, v in
                              _percentiles(window_lat).items()},
        "streaming_rtf": rtf,
        "concurrent_realtime_sessions": int(1.0 / rtf) if rtf > 0 else -1,
        "emission_latency_ms": {
            k: {kk: vv * 1000.0 for kk, vv in d.items()}
            for k, d in latency_metrics.latency_report(per_utt).items()},
        "compile_s": compile_s,
        "n_utts": args.n_utts,
        "utt_seconds": args.utt_seconds,
        "piece_ms": args.piece_ms,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    })
    line = json.dumps(report)
    print(line)
    if args.json_out:
        with open(args.json_out, "a", encoding="utf-8") as f:
            f.write(line + "\n")
    return report


def _run_batched(args, batch, make_wav, piece, stride_sec, dev):
    """N sessions at the same rate advance in lockstep, one batched step
    per window round; the RTF is the aggregate (compute seconds per audio
    second over all sessions), so 1/RTF is the card's concurrent real-time
    session capacity."""
    from paper_accurate_fast_cheap_tpu_torch.tools import latency_metrics

    N = args.concurrent
    # warm-up: one window and the flush per slot
    t0 = time.perf_counter()
    sids = [batch.open() for _ in range(N)]
    for s in sids:
        batch.accept_waveform(s, make_wav()[:batch._win_samples + piece])
    while batch.any_ready():
        batch.step()
    for s in sids:
        batch.finalize(s)
    _sync(dev)
    compile_s = time.perf_counter() - t0

    step_lat: List[float] = []
    per_utt = []
    total_compute = total_audio = 0.0
    for _ in range(args.n_utts):
        wavs = [make_wav() for _ in range(N)]
        total_audio += sum(len(w) for w in wavs) / 16000.0
        sids = [batch.open() for _ in range(N)]
        refs = {s: [] for s in sids}
        emits = {s: [] for s in sids}
        ntok = {s: 0 for s in sids}
        utt_steps: List[float] = []
        t_start = time.perf_counter()

        def run_step():
            nonlocal total_compute
            c0 = time.perf_counter()
            out = batch.step()
            dt = time.perf_counter() - c0
            total_compute += dt
            wall = time.perf_counter() - t_start
            for s, part in out.items():
                if len(part.tokens) > ntok[s]:
                    if args.realtime:
                        emits[s].extend([wall]
                                        * (len(part.tokens) - ntok[s]))
                    refs[s].extend(part.times[ntok[s]:])
                    ntok[s] = len(part.tokens)
            return dt

        for i in range(0, len(wavs[0]), piece):
            if args.realtime:
                tgt = t_start + (i + piece) / 16000.0
                now = time.perf_counter()
                if tgt > now:
                    time.sleep(tgt - now)
            for s, w in zip(sids, wavs):
                batch.accept_waveform(s, w[i:i + piece])
            while batch.any_ready():
                utt_steps.append(run_step())
        for s in sids:
            batch.flush(s)
        while not all(batch.is_done(s) for s in sids):
            run_step()
        for s in sids:
            batch.close(s)
        step_lat.extend(utt_steps)
        comp = float(np.median(utt_steps)) if utt_steps else 0.0
        for s in sids:
            if not args.realtime:
                emits[s] = _analytic_emits(refs[s], comp, args, batch._sub,
                                           batch._shift, batch._flen, piece)
            per_utt.append(latency_metrics.utterance_latency(emits[s],
                                                             refs[s]))
    return _report(args, step_lat, per_utt, total_compute, total_audio,
                   compile_s, stride_sec, dev, concurrent=N)


def build(args, dev):
    """The model (random weights from seed 0, or the checkpoint) in eval
    mode on ``dev`` and the feature function; returns (model, featurize,
    frame shift, frame length in samples)."""
    from paper_accurate_fast_cheap_tpu_torch.frontend.pipeline import (
        make_feature_fn)
    from paper_accurate_fast_cheap_tpu_torch.models import factory
    from paper_accurate_fast_cheap_tpu_torch.utils.config import load_config

    config = load_config(args.config)
    enc_conf = dict(config.get("encoder_conf", {}))
    if not enc_conf.get("causal", False):
        logging.warning("config is not causal: forcing causal: true "
                        "(streaming needs a cached causal conv module)")
        enc_conf["causal"] = True
    config = dict(config, encoder_conf=enc_conf)
    fb = dict(config.get("dataset_conf", {}).get("fbank_conf", {}))
    fb.setdefault("num_mel_bins", 80)
    fb["dither"] = 0.0
    vocab = config.get("vocab_size_for_bench", 5002)
    model, _ = factory.init_model(config, vocab, fb["num_mel_bins"],
                                  device="cpu")
    if args.checkpoint:
        model.load_state_dict(torch.load(args.checkpoint, map_location="cpu",
                                         weights_only=True))
    if args.bf16:
        model = model.to(torch.bfloat16)
    model = model.to(dev).eval()
    featurize = make_feature_fn({"fbank_conf": fb}, None, device=dev)
    return (model, featurize, int(fb.get("frame_shift", 10)) * 16,
            int(fb.get("frame_length", 25)) * 16)


def main(argv=None):
    args = get_args(argv)
    logging.basicConfig(level=logging.INFO)
    from paper_accurate_fast_cheap_tpu_torch.streaming import (
        StreamingBatch, make_session_factory)
    from paper_accurate_fast_cheap_tpu_torch.tools import latency_metrics

    dev = resolve_device(args.device)
    model, featurize, shift, flen = build(args, dev)
    sub = 4
    geometry = dict(decoding_chunk_size=args.chunk, subsampling=sub,
                    frame_shift=shift, frame_length=flen)
    stride_sec = args.chunk * sub * shift / 16000.0
    piece = int(args.piece_ms / 1000.0 * 16000)
    n_samples = int(args.utt_seconds * 16000)
    rng = np.random.RandomState(7)

    def make_wav():
        return (rng.randn(n_samples) * 0.1).astype(np.float32)

    if args.concurrent > 1:
        batch = StreamingBatch(model, _BenchTokenizer(), featurize,
                               max_sessions=args.concurrent, **geometry)
        return _run_batched(args, batch, make_wav, piece, stride_sec, dev)

    sess_factory = make_session_factory(model, _BenchTokenizer(), featurize,
                                        **geometry)
    # warm-up: the window and the tail
    t0 = time.perf_counter()
    s = sess_factory()
    s.accept_waveform(make_wav()[:piece * 20])
    s.finalize()
    _sync(dev)
    compile_s = time.perf_counter() - t0
    logging.info("warm-up in %.1f s", compile_s)

    window_lat: List[float] = []
    per_utt = []
    total_compute = total_audio = 0.0
    for _ in range(args.n_utts):
        wav = make_wav()
        total_audio += len(wav) / 16000.0
        sess = sess_factory()
        emits: List[float] = []
        refs: List[float] = []
        utt_windows: List[float] = []
        n_tok = 0
        t_start = time.perf_counter()
        for i in range(0, len(wav), piece):
            if args.realtime:
                tgt = t_start + (i + piece) / 16000.0  # packet arrival
                now = time.perf_counter()
                if tgt > now:
                    time.sleep(tgt - now)
            off0 = sess._offset
            c0 = time.perf_counter()
            part = sess.accept_waveform(wav[i:i + piece])
            dt = time.perf_counter() - c0
            total_compute += dt
            wall = time.perf_counter() - t_start
            if sess._offset > off0:       # one window at this rate
                utt_windows.append(dt)
            if len(part.tokens) > n_tok:
                if args.realtime:
                    emits.extend([wall] * (len(part.tokens) - n_tok))
                refs.extend(part.times[n_tok:])
                n_tok = len(part.tokens)
        c0 = time.perf_counter()
        fin = sess.finalize()
        total_compute += time.perf_counter() - c0
        wall = time.perf_counter() - t_start
        if len(fin.tokens) > n_tok:
            if args.realtime:
                emits.extend([wall] * (len(fin.tokens) - n_tok))
            refs.extend(fin.times[n_tok:])
        window_lat.extend(utt_windows)
        if not args.realtime:
            comp = float(np.median(utt_windows)) if utt_windows else 0.0
            emits = _analytic_emits(refs, comp, args, sub, shift, flen,
                                    piece)
        per_utt.append(latency_metrics.utterance_latency(emits, refs))
    return _report(args, window_lat, per_utt, total_compute, total_audio,
                   compile_s, stride_sec, dev)


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
