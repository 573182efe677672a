"""Checkpoint averaging CLI (port of the JAX ``bin/average_model.py``): the
last ``--num`` epoch checkpoints of a run directory, or the ``--val_best``
ones by their sidecar cv loss, averaged (float64 sums) into one
checkpoint that ``recognize_wav``, ``recognize`` and ``api.load_model``
read.

Usage:
  python -m paper_accurate_fast_cheap_tpu_torch.bin.average_model \\
      --src_path exp/run1 --dst_path exp/run1/avg_5 --num 5 \\
      --config exp/run1/train.yaml [--val_best]
"""
from __future__ import annotations

import argparse
import logging
import sys


def get_args(argv=None):
    p = argparse.ArgumentParser(description="average checkpoints")
    p.add_argument("--src_path", required=True, help="model dir")
    p.add_argument("--dst_path", required=True,
                   help="output checkpoint name (<dst>.pt, <dst>.yaml)")
    p.add_argument("--num", type=int, default=5)
    p.add_argument("--val_best", action="store_true",
                   help="pick by lowest cv_loss instead of last N")
    p.add_argument("--config", required=True,
                   help="train.yaml (accepted as in the JAX CLI; the "
                        "checkpoints carry their own names and shapes)")
    return p.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    logging.basicConfig(level=logging.INFO)
    from paper_accurate_fast_cheap_tpu_torch.train import checkpointing

    if args.val_best:
        paths = checkpointing.select_best_checkpoints(args.src_path,
                                                      args.num)
    else:
        paths = [p for p in checkpointing.list_checkpoints(args.src_path)
                 if "epoch_" in p][-args.num:]
    if not paths:
        logging.error("no checkpoints found in %s", args.src_path)
        return 1
    logging.info("averaging %d checkpoints: %s", len(paths), paths)
    avg = checkpointing.average_checkpoints(paths)
    checkpointing.save_checkpoint(
        args.dst_path, avg, info={"averaged_from": paths, "tag": "average"})
    return 0


if __name__ == "__main__":
    sys.exit(main())
