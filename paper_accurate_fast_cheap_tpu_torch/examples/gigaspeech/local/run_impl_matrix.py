"""Impl-matrix transcript invariance (port of the recipe's
``local/run_impl_matrix.py``).

The same checkpoint and WAV go through every cell of the long-form CLI
(``bin/recognize_wav``) whose flags select different code in the port:
the device beam's duplicate merge (``--beam_merge pairwise|sort``) x the
beam's own alignment of its top hypothesis (``--align_max_tokens 0``: the
default budget; ``256``: a larger packed buffer), plus one cell with the
JAX CLI's TPU axes (``--wkv_impl chunked --fuse off``), which the port
accepts and ignores.  The harness asserts TRANSCRIPT-level equality (the
TXT files byte for byte) and reports the CTMs' equality beside it.  The
JAX harness's VMEM-pinning and dispatch axes are TPU workarounds and are
not crossed.

Checkpoint: by default the accuracy loop's TRAINED model
(``run_accuracy_loop --out <dir>``), whose emissions are structured
(tone-words) rather than tie-cascade noise.

Prints one JSON line; returns 0 iff every cell matches the first.

Usage:
  python -m paper_accurate_fast_cheap_tpu_torch.examples.gigaspeech.local.run_impl_matrix \\
      --fixture acc_loop [--device cpu]
"""
import argparse
import json
import os
import sys
import time

from paper_accurate_fast_cheap_tpu_torch.examples.gigaspeech.local import (
    run_cli)

# (tag, extra recognize_wav flags)
CELLS = [
    ("pairwise_align0", ["--beam_merge", "pairwise",
                         "--align_max_tokens", "0"]),
    ("pairwise_align256", ["--beam_merge", "pairwise",
                           "--align_max_tokens", "256"]),
    ("sort_align0", ["--beam_merge", "sort", "--align_max_tokens", "0"]),
    ("sort_align256", ["--beam_merge", "sort", "--align_max_tokens", "256"]),
    ("tpu_axes_chunked_fuseoff", ["--wkv_impl", "chunked", "--fuse", "off"]),
]


def newest_epoch(exp: str) -> str:
    eps = sorted(d for d in os.listdir(exp) if d.startswith("epoch_")
                 and d.endswith(".pt") and not d.endswith(".opt.pt"))
    if not eps:
        raise FileNotFoundError(f"no epoch_*.pt checkpoint in {exp}")
    return os.path.join(exp, eps[-1])


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--fixture", default=None,
                   help="run_accuracy_loop --out dir (config.yaml, "
                        "exp/epoch_*.pt, longform/ep0.wav)")
    p.add_argument("--checkpoint", default=None,
                   help="override: explicit checkpoint path")
    p.add_argument("--config", default=None)
    p.add_argument("--wav", default=None)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--chunk_size", type=int, default=2000)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--ctc_weight", type=float, default=0.3)
    p.add_argument("--transducer_weight", type=float, default=0.7)
    args = p.parse_args(argv)
    if args.fixture is None and None in (args.config, args.wav,
                                         args.checkpoint, args.out):
        p.error("pass --fixture, or --config, --wav, --checkpoint and --out")

    cfg = args.config or os.path.join(args.fixture, "config.yaml")
    wav = args.wav or os.path.join(args.fixture, "longform", "ep0.wav")
    ckpt = args.checkpoint or newest_epoch(os.path.join(args.fixture, "exp"))
    out_root = args.out or os.path.join(args.fixture, "impl_matrix")
    name = os.path.splitext(os.path.basename(wav))[0]

    texts, ctms = {}, {}
    for tag, flags in CELLS:
        out = os.path.join(out_root, tag)
        t0 = time.time()
        run_cli("recognize_wav", [
            "--config", cfg, "--checkpoint", ckpt, "--wav", wav,
            "--output_dir", out, "--mode", "rnnt_beam_search",
            "--chunk_size", args.chunk_size, "--batch_size", args.batch_size,
            "--beam_size", 8, "--ctc_weight", args.ctc_weight,
            "--transducer_weight", args.transducer_weight,
            "--device", args.device, *flags])
        with open(os.path.join(out, name + ".txt"), "rb") as f:
            texts[tag] = f.read()
        with open(os.path.join(out, name + ".ctm"), "rb") as f:
            ctms[tag] = f.read()
        print(f"# {tag}: {time.time() - t0:.1f}s, "
              f"{len(texts[tag].split())} words", file=sys.stderr)

    base = CELLS[0][0]
    differ = sorted(t for t in texts if texts[t] != texts[base])
    print(json.dumps({
        "metric": "impl_matrix_invariance",
        "cells": len(CELLS),
        "hard_contract_ok": not differ,
        "cells_differing_from_default": differ,
        "distinct_transcripts": len(set(texts.values())),
        "ctm_identical": len(set(ctms.values())) == 1,
        "words": len(texts[base].split()),
        "checkpoint": ckpt,
        "device": args.device,
    }))
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
