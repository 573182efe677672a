"""Global CMVN statistics CLI (port of the JAX
``bin/compute_cmvn_stats.py``): the per-dimension sum and sum of squares of
the fbank features over a raw, tar-shard or zip-shard list, and the frame
count, as the JSON file that ``cmvn: global_cmvn`` reads
(``{"mean_stat", "var_stat", "frame_num"}``).

The features run on the device (``cuda`` unless ``--device cpu``), one
utterance at a time; each utterance's float32 features come to the host
and are added into float64 sums there, as in JAX.

Usage:
  python -m paper_accurate_fast_cheap_tpu_torch.bin.compute_cmvn_stats \\
      --data data.list --data_type raw --out_cmvn global_cmvn [--device cpu]
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
    p = argparse.ArgumentParser(description="compute global CMVN stats")
    p.add_argument("--data", required=True, help="shard list or raw list")
    p.add_argument("--data_type", default="shard",
                   choices=["raw", "shard", "zip_shard"])
    p.add_argument("--num_mel_bins", type=int, default=80)
    p.add_argument("--out_cmvn", required=True)
    p.add_argument("--max_utts", type=int, default=0, help="0 = all")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    logging.basicConfig(level=logging.INFO)
    dev = resolve_device(args.device)
    from paper_accurate_fast_cheap_tpu_torch.data import pipeline as dp
    from paper_accurate_fast_cheap_tpu_torch.frontend import features

    if args.data_type == "raw":
        stream = dp.decode_wav(dp.raw_source(args.data))
    else:
        src = dp.shard_list_source(args.data)
        reader = (dp.tar_shard_source if args.data_type == "shard"
                  else dp.zip_shard_source)
        stream = dp.decode_wav(reader(src))

    mean_stat = np.zeros(args.num_mel_bins, np.float64)
    var_stat = np.zeros(args.num_mel_bins, np.float64)
    frames = 0
    for i, s in enumerate(stream):
        if args.max_utts and i >= args.max_utts:
            break
        wav = torch.from_numpy(s["wav"] * 32768.0).to(dev)
        with torch.no_grad():
            feat = features.fbank(wav, num_mel_bins=args.num_mel_bins)
        feat = feat.cpu().numpy()
        mean_stat += feat.sum(axis=0)
        var_stat += (feat ** 2).sum(axis=0)
        frames += feat.shape[0]
    with open(args.out_cmvn, "w") as f:
        json.dump({"mean_stat": mean_stat.tolist(),
                   "var_stat": var_stat.tolist(),
                   "frame_num": frames}, f)
    logging.info("cmvn over %d frames -> %s", frames, args.out_cmvn)
    return 0


if __name__ == "__main__":
    sys.exit(main())
