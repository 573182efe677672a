"""Shard writer CLI (port of the JAX ``bin/make_shard.py``).

Parity target: `tools/make_shard.py` — pack a 'key wav_path' wav.scp + text
file into tar shards of N utterances ({key}.txt + {key}.{wav,flac,opus}
entries), with optional resampling/segment extraction.  Inputs are read by
``data/audio.read_audio_bytes`` (wav, flac, ogg/opus, mp3, m4a); the tar
members and payloads equal the JAX CLI's.  No device is used.

Usage:
  python -m paper_accurate_fast_cheap_tpu_torch.bin.make_shard \\
      --wav_scp wav.scp --text text --output_dir shards \\
      [--audio_format wav|flac|opus] [--num_utts_per_shard 1000]
"""
from __future__ import annotations

import argparse
import io
import logging
import os
import sys
import tarfile
import wave

import numpy as np


def get_args(argv=None):
    p = argparse.ArgumentParser(description="write tar shards")
    p.add_argument("--wav_scp", required=True, help="'key path' per line")
    p.add_argument("--audio_format", default="wav",
                   choices=["wav", "flac", "opus"],
                   help="shard entry codec (reference AUDIO_FORMAT_SETS, "
                        "tools/make_shard.py:36; flac via the native "
                        "codec, opus via libopus — inputs may be "
                        "wav/flac/ogg-opus/mp3/m4a regardless)")
    p.add_argument("--text", required=True, help="'key transcript' per line")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--num_utts_per_shard", type=int, default=1000)
    p.add_argument("--resample", type=int, default=0,
                   help="resample to this rate (0 = keep)")
    p.add_argument("--prefix", default="shard")
    p.add_argument("--segments", default=None,
                   help="optional 'utt wav start end' segments file")
    return p.parse_args(argv)


def _read_table(path):
    out = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split(maxsplit=1)
            if parts:
                out[parts[0]] = parts[1] if len(parts) > 1 else ""
    return out


def _wav_to_bytes(samples: np.ndarray, sr: int) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(
            np.clip(samples * 32767, -32768, 32767).astype("<i2").tobytes()
        )
    return buf.getvalue()


def main(argv=None):
    args = get_args(argv)
    logging.basicConfig(level=logging.INFO)
    from paper_accurate_fast_cheap_tpu_torch.data.audio import (
        read_audio_bytes)

    wavs = _read_table(args.wav_scp)
    texts = _read_table(args.text)
    segments = []
    if args.segments:
        with open(args.segments, encoding="utf-8") as f:
            for line in f:
                utt, wav_key, start, end = line.strip().split()
                segments.append((utt, wav_key, float(start), float(end)))
    else:
        segments = [(k, k, None, None) for k in texts if k in wavs]

    os.makedirs(args.output_dir, exist_ok=True)
    shard_idx = 0
    count = 0
    tf = None
    shard_list = []
    for utt, wav_key, start, end in segments:
        if wav_key not in wavs or utt not in texts:
            continue
        if tf is None:
            path = os.path.join(args.output_dir,
                                f"{args.prefix}_{shard_idx:06d}.tar")
            shard_list.append(path)
            tf = tarfile.open(path, "w")
        try:
            with open(wavs[wav_key], "rb") as f:
                samples, sr = read_audio_bytes(f.read())
        except Exception as e:
            logging.warning("skip %s: %s", utt, e)
            continue
        if start is not None:
            samples = samples[int(start * sr) : int(end * sr)]
        if args.resample and sr != args.resample:
            from scipy.signal import resample_poly

            g = np.gcd(sr, args.resample)
            samples = resample_poly(samples, args.resample // g, sr // g)
            sr = args.resample
        data_txt = texts[utt].encode("utf-8")
        if args.audio_format == "flac":
            from paper_accurate_fast_cheap_tpu_torch.data.flac import encode_flac

            data_wav = encode_flac(np.asarray(samples, np.float32), sr)
        elif args.audio_format == "opus":
            from paper_accurate_fast_cheap_tpu_torch.data.codecs import (
                encode_ogg_opus)

            if sr not in (8000, 12000, 16000, 24000, 48000):
                raise SystemExit(
                    f"opus output needs 8/12/16/24/48 kHz input (got {sr}); "
                    "pass --resample 16000")
            data_wav = encode_ogg_opus(np.asarray(samples, np.float32), sr)
        else:
            data_wav = _wav_to_bytes(np.asarray(samples, np.float32), sr)
        for ext, data in (("txt", data_txt),
                          (args.audio_format, data_wav)):
            info = tarfile.TarInfo(f"{utt}.{ext}")
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
        count += 1
        if count >= args.num_utts_per_shard:
            tf.close()
            tf, count = None, 0
            shard_idx += 1
    if tf is not None:
        tf.close()
    with open(os.path.join(args.output_dir, "shards.txt"), "w") as f:
        f.write("\n".join(shard_list) + "\n")
    logging.info("wrote %d shards", len(shard_list))
    return 0


if __name__ == "__main__":
    sys.exit(main())
