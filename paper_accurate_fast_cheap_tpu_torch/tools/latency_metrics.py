"""Emission-latency analysis (port of the JAX ``tools/latency_metrics.py``):
per-token delays of emission against each token's reference time,
FirstToken / LastToken / AvgToken per utterance and their percentiles over
utterances; reference times from CTC forced-alignment peaks or from a
frame alignment file, and the CLI that holds chunked (streaming-masked)
CTC greedy emissions against such a file.

Usage:
  python -m paper_accurate_fast_cheap_tpu_torch.tools.latency_metrics \
      --config train.yaml --checkpoint model.pt --wav_scp wav.scp \
      --alignment ali.txt [--chunk_size 16] [--device cpu]
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np


@dataclasses.dataclass
class UttLatency:
    first_token: float
    last_token: float
    avg_token: float


def token_delays(emission_times: Sequence[float],
                 reference_times: Sequence[float]) -> List[float]:
    """Per-token delay = emitted - reference (the same token order)."""
    n = min(len(emission_times), len(reference_times))
    return [emission_times[i] - reference_times[i] for i in range(n)]


def utterance_latency(emission_times: Sequence[float],
                      reference_times: Sequence[float]) -> UttLatency:
    d = token_delays(emission_times, reference_times)
    if not d:
        return UttLatency(0.0, 0.0, 0.0)
    return UttLatency(first_token=d[0], last_token=d[-1],
                      avg_token=float(np.mean(d)))


def latency_report(per_utt: List[UttLatency],
                   percentiles=(50, 90, 95, 99)) -> Dict[str, Dict]:
    """Mean and percentiles over utterances of each delay kind."""
    out = {}
    for field in ("first_token", "last_token", "avg_token"):
        vals = np.asarray([getattr(u, field) for u in per_utt])
        if len(vals) == 0:
            out[field] = {}
            continue
        out[field] = {
            "mean": float(vals.mean()),
            **{f"p{p}": float(np.percentile(vals, p)) for p in percentiles},
        }
    return out


def ctc_peak_emission_times(ctc_logp: np.ndarray, tokens: Sequence[int],
                            frame_rate: float = 0.04) -> List[float]:
    """Reference times: the peaks of the tokens' CTC forced alignment
    (the host aligner, float64), in seconds."""
    from paper_accurate_fast_cheap_tpu_torch.ops import ctc_utils

    if not tokens:
        return []
    ali = ctc_utils.force_align(ctc_logp, list(tokens))
    spans = ctc_utils.alignment_to_token_spans(ali)
    return [s[1] * frame_rate for s in spans]


def read_alignments(path: str) -> Dict[str, List[str]]:
    """'key <blank> tok <blank> ...' per line: one token per 10 ms frame."""
    out = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split(" ", 1)
            if len(parts) == 2:
                out[parts[0]] = parts[1].split()
    return out


def alignment_token_times(align: Sequence[str],
                          blank: str = "<blank>") -> List[float]:
    """Non-blank tokens' reference times in ms (frame i -> i * 10 ms)."""
    return [i * 10.0 for i, tok in enumerate(align) if tok != blank]


def streaming_token_times(frame_hyps: Sequence[int], subsampling: int = 4,
                          blank_id: int = 0) -> List[float]:
    """Emission times in ms from per-encoder-frame greedy outputs."""
    return [i * subsampling * 10.0 for i, tok in enumerate(frame_hyps)
            if tok != blank_id]


def compare_with_alignment(timestamps: Dict[str, Sequence[int]],
                           alignments: Dict[str, Sequence[str]],
                           subsampling: int = 4, blank_id: int = 0,
                           tolerance_frames: int = 7):
    """Match streaming emissions against forced alignments: skip missing
    keys, utterances whose frame counts differ by >= ``tolerance_frames``
    (70 ms) and token-count mismatches.  Returns (per-utterance latencies,
    counters)."""
    counters = {"not_found": 0, "len_unequal": 0, "ignored": 0, "valid": 0}
    per_utt: List[UttLatency] = []
    for key, align in alignments.items():
        if key not in timestamps:
            counters["not_found"] += 1
            continue
        frame_hyps = timestamps[key]
        if abs(len(frame_hyps) * subsampling - len(align)) \
                >= tolerance_frames:
            counters["ignored"] += 1
            continue
        fa = alignment_token_times(align)
        st = streaming_token_times(frame_hyps, subsampling, blank_id)
        if len(fa) != len(st) or not fa:
            counters["len_unequal"] += 1
            continue
        per_utt.append(utterance_latency(st, fa))
        counters["valid"] += 1
    return per_utt, counters


def print_report(per_utt: List[UttLatency]):
    """The max / P90 / P75 / P50 / P25 / min table of each delay kind,
    logged."""
    import logging

    names = [("FirstTokenDelay", "first_token"),
             ("LastTokenDelay", "last_token"),
             ("AvgTokenDelay", "avg_token")]
    n = len(per_utt)
    if n == 0:
        logging.warning("no valid utterances")
        return
    parts = [("max", n - 1), ("P90", int(n * 0.90)),
             ("P75", int(n * 0.75)), ("P50", int(n * 0.50)),
             ("P25", int(n * 0.25)), ("min", 0)]
    for name, field in names:
        vals = sorted(getattr(u, field) for u in per_utt)
        logging.info("==========================")
        for p, i in parts:
            logging.info("%s %s: %.3f ms", name, p, vals[i])


def main(argv=None):
    """Chunked CTC-greedy emissions against a forced-alignment file."""
    import argparse
    import logging

    import torch

    p = argparse.ArgumentParser(description="emission latency analysis")
    p.add_argument("--config", required=True)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--wav_scp", required=True, help="'key path' per line")
    p.add_argument("--alignment", required=True,
                   help="'key <blank> tok ...' frame alignment per line")
    p.add_argument("--chunk_size", type=int, default=16)
    p.add_argument("--subsampling", type=int, default=4)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from paper_accurate_fast_cheap_tpu_torch import resolve_device
    from paper_accurate_fast_cheap_tpu_torch.bin.recognize import (
        build_decode_assets)
    from paper_accurate_fast_cheap_tpu_torch.data.audio import (
        read_audio_bytes)
    from paper_accurate_fast_cheap_tpu_torch.utils.config import load_config

    dev = resolve_device(args.device)
    config = load_config(args.config)
    _, model, _, featurize, _ = build_decode_assets(config, args.checkpoint,
                                                    device=dev)
    timestamps = {}
    with open(args.wav_scp) as f, torch.no_grad():
        for line in f:
            parts = line.strip().split(" ", 1)
            if len(parts) != 2:
                continue
            key, path = parts
            with open(path, "rb") as wf:
                wav, _ = read_audio_bytes(wf.read())
            feats, feat_lens = featurize(torch.from_numpy(wav[None]),
                                         torch.tensor([len(wav)]))
            enc, enc_lens = model.forward_encoder(feats, feat_lens,
                                                  args.chunk_size)
            logp = model.ctc_logprobs(enc)[0, : int(enc_lens[0])]
            timestamps[key] = np.argmax(logp.float().cpu().numpy(),
                                        axis=-1).tolist()
    aligns = read_alignments(args.alignment)
    per_utt, counters = compare_with_alignment(
        timestamps, aligns, subsampling=args.subsampling)
    logging.info("counters: %s", counters)
    print_report(per_utt)
    report = latency_report(per_utt)
    print(report)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
