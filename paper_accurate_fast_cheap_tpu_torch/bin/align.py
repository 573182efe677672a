"""CTC forced-alignment CLI (port of the JAX ``bin/align.py``): a raw
list of {key, wav, txt} JSON lines -> token-level CTM lines
``<key> 1 <begin> <duration> <token>``, and optionally each utterance's
per-frame best path (``--frames_path``: ``key id id ...``).

The features and the encoder run on the device (``cuda`` unless
``--device cpu``); the CTC log-probs come to the host as float32 and the
Viterbi alignment is the host ``ops/ctc_utils.force_align`` (float64
numpy), as in JAX, so the CTM is the JAX CLI's byte for byte on the same
weights.  Token times are the first frame of each non-blank run, spread to
the midpoints between neighbours (``gen_timestamps_from_peak``).  The
checkpoint is the port's state_dict file.

Usage:
  python -m paper_accurate_fast_cheap_tpu_torch.bin.align \\
      --config exp/train.yaml --checkpoint exp/avg.pt \\
      --input_data data/test/raw.jsonl --output ali.ctm [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import logging
import sys

import numpy as np
import torch

from paper_accurate_fast_cheap_tpu_torch import resolve_device


def get_args(argv=None):
    p = argparse.ArgumentParser(description="CTC forced alignment")
    p.add_argument("--config", required=True)
    p.add_argument("--checkpoint", required=True,
                   help="the port's state_dict file (torch.save)")
    p.add_argument("--input_data", required=True,
                   help="raw jsonl list: {key, wav, txt} per line")
    p.add_argument("--output", required=True, help="CTM output path")
    p.add_argument("--frames_path", default=None,
                   help="optional per-frame best-path dump (key id id ...)")
    p.add_argument("--frame_rate", type=float, default=0.04,
                   help="seconds per encoder frame (ds4 => 0.04)")
    p.add_argument("--max_token_duration", type=float, default=1.0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def token_peaks(path) -> list:
    """The first frame of each non-blank run of a best path."""
    peaks, prev = [], 0
    for t, tok in enumerate(path):
        if tok != 0 and tok != prev:
            peaks.append(t)
        prev = tok
    return peaks


def main(argv=None):
    args = get_args(argv)
    logging.basicConfig(level=logging.INFO)
    dev = resolve_device(args.device)
    from paper_accurate_fast_cheap_tpu_torch.bin.recognize import (
        build_decode_assets)
    from paper_accurate_fast_cheap_tpu_torch.data.audio import (
        read_audio_bytes, resample_to)
    from paper_accurate_fast_cheap_tpu_torch.ops import ctc_utils
    from paper_accurate_fast_cheap_tpu_torch.utils.config import load_config

    config = load_config(args.config)
    tokenizer, model, _, featurize, _ = build_decode_assets(
        config, args.checkpoint, device=dev)
    n_done = 0
    frames_f = open(args.frames_path, "w") if args.frames_path else None
    try:
        with open(args.output, "w") as out, \
                open(args.input_data, encoding="utf-8") as lines:
            for line in lines:
                line = line.strip()
                if not line:
                    continue
                obj = json.loads(line)
                key, txt = obj["key"], obj["txt"]
                with open(obj["wav"], "rb") as f:
                    wav, sr = read_audio_bytes(f.read())
                wav, _ = resample_to(np.asarray(wav, np.float32), int(sr))
                tokens, ids = tokenizer.tokenize(txt)
                if not ids:
                    logging.warning("%s: empty transcript, skipped", key)
                    continue
                with torch.no_grad():
                    feats, feat_lens = featurize(
                        torch.from_numpy(wav[None]),
                        torch.tensor([len(wav)]))
                    enc, enc_lens = model.forward_encoder(feats, feat_lens)
                    logp = model.ctc_logprobs(enc)[0].float().cpu().numpy()
                T = int(enc_lens[0])
                path = ctc_utils.force_align(logp[:T], ids)
                if frames_f:
                    frames_f.write(key + " " + " ".join(
                        str(int(t)) for t in path) + "\n")
                times = ctc_utils.gen_timestamps_from_peak(
                    token_peaks(path), max_duration=T * args.frame_rate,
                    frame_rate=args.frame_rate,
                    max_token_duration=args.max_token_duration)
                for tok_txt, (beg, end) in zip(tokens, times):
                    out.write(f"{key} 1 {beg:.2f} {end - beg:.2f} "
                              f"{tok_txt}\n")
                n_done += 1
    finally:
        if frames_f:
            frames_f.close()
    logging.info("aligned %d utterances -> %s", n_done, args.output)
    return 0


if __name__ == "__main__":
    sys.exit(main())
