"""Kaldi fbank features of a wav.scp (+ optional segments) into Kaldi
ark/scp files (port of the JAX ``bin/compute_fbank_feats.py``).

Each waveform is scaled to the int16 range (x 32768) and goes through the
port's ``frontend/features.fbank`` on the device (``cuda`` unless
``--device cpu``), one file at a time; the matrices are written as float32
with ``data/kaldi_io.write_ark_scp``.  With ``--dither`` > 0 the noise comes
from a ``torch.Generator`` on the device seeded 0.

Usage:
  python -m paper_accurate_fast_cheap_tpu_torch.bin.compute_fbank_feats \\
      wav.scp feats.ark feats.scp [--segments segments] [--device cpu]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from paper_accurate_fast_cheap_tpu_torch import resolve_device


def get_args(argv=None):
    p = argparse.ArgumentParser(description="compute fbank ark/scp")
    p.add_argument("wav_scp", help="'key wav_path' per line")
    p.add_argument("out_ark")
    p.add_argument("out_scp")
    p.add_argument("--segments", default=None,
                   help="'key wav_key start end' per line")
    p.add_argument("--num_mel_bins", type=int, default=80)
    p.add_argument("--frame_length", type=int, default=25,
                   help="milliseconds")
    p.add_argument("--frame_shift", type=int, default=10,
                   help="milliseconds")
    p.add_argument("--dither", type=float, default=0.0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def _split_lines(path, fields: int):
    out = []
    with open(path, encoding="utf8") as fin:
        for line in fin:
            arr = line.strip().split()
            if not arr:
                continue
            if len(arr) != fields:
                raise ValueError(f"{path}: expected {fields} fields: {line!r}")
            out.append(arr)
    return out


def load_wav_scp(path):
    return [(k, p) for k, p in _split_lines(path, 2)]


def load_wav_segments(wav_scp, segments):
    wav_dict = dict(load_wav_scp(wav_scp))
    return [(k, wav_dict[w], float(s), float(e))
            for k, w, s, e in _split_lines(segments, 4)]


def main(argv=None):
    args = get_args(argv)
    dev = resolve_device(args.device)
    from paper_accurate_fast_cheap_tpu_torch.data import kaldi_io
    from paper_accurate_fast_cheap_tpu_torch.data.pipeline import _decode_one
    from paper_accurate_fast_cheap_tpu_torch.frontend import features

    if args.segments is None:
        items = [(k, p, None, None) for k, p in load_wav_scp(args.wav_scp)]
    else:
        items = load_wav_segments(args.wav_scp, args.segments)
    gen = torch.Generator(device=dev).manual_seed(0)
    mats = {}
    for key, path, start, end in items:
        sample = {"key": key, "wav": path}
        if start is not None:
            sample["start"], sample["end"] = start, end
        s = _decode_one(sample)
        sr = s["sample_rate"]
        wav = torch.from_numpy(np.asarray(s["wav"], np.float32) * 32768.0)
        with torch.no_grad():
            mat = features.fbank(
                wav.to(dev), num_mel_bins=args.num_mel_bins,
                frame_length=args.frame_length * sr // 1000,
                frame_shift=args.frame_shift * sr // 1000, sample_rate=sr,
                dither=args.dither,
                generator=gen if args.dither > 0 else None)
        mats[key] = mat.cpu().numpy().astype(np.float32)
    kaldi_io.write_ark_scp(args.out_ark, mats, args.out_scp)
    print(f"wrote {len(mats)} feature matrices to {args.out_ark}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
