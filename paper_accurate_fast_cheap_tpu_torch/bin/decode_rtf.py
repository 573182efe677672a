"""Decode-path RTF benchmark CLI (port of the JAX ``bin/decode_rtf.py``):
encoder + search end to end over B random feature windows, at the paper's
short-form operating point by default (``rnnt_beam_search``, beam 8, batch
64, 3000 frames = 30 s).  Modes: ``ctc_greedy_search`` (the CTC argmax on
the host) and ``rnnt_beam_search`` (the device prefix beam with CTC
fusion: K3 per frame, and K2 per frame where the joint has the split form,
``decode/rnnt_search.py``).  The ``.rtf`` lines are ``bin/encoder_rtf.py``'s
plus ``beam``/``mean_tokens`` and ``fuse``/``beam_unroll``, aggregatable by
``tools/rtf_tables.py``.

``--fuse`` (JAX's one-program dispatch of encoder + CTC + beam) and
``--beam_unroll`` (its ``lax.scan`` unroll) choose how the JAX package
dispatches to its TPU; they are accepted, logged and do nothing here.

Usage:
  python -m paper_accurate_fast_cheap_tpu_torch.bin.decode_rtf \\
      --config examples/gigaspeech/conf/rwkvbi_ds4k31nc_12le_trans_shortform.yaml \\
      [--mode ctc_greedy_search] [--device cpu]
"""
from __future__ import annotations

import argparse
import logging
import os
import sys

import numpy as np
import torch

from paper_accurate_fast_cheap_tpu_torch import resolve_device
from paper_accurate_fast_cheap_tpu_torch.bin.encoder_rtf import (
    bench_features, kernels_cached, load_bench_model, report_tail,
    timed_runs, write_report)


def get_args(argv=None):
    p = argparse.ArgumentParser(description="decode RTF benchmark")
    p.add_argument("--config", required=True,
                   help="transducer model config yaml")
    p.add_argument("--checkpoint", default=None,
                   help="the port's state_dict file; random weights if "
                        "omitted")
    p.add_argument("--mode", default="rnnt_beam_search",
                   choices=["ctc_greedy_search", "rnnt_beam_search"])
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--chunk_size", type=int, default=3000,
                   help="frames per utterance (3000 = 30 s short-form)")
    p.add_argument("--beam_size", type=int, default=8)
    p.add_argument("--ctc_weight", type=float, default=0.3)
    p.add_argument("--transducer_weight", type=float, default=0.7)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--bf16", action="store_true", default=True)
    p.add_argument("--no-bf16", dest="bf16", action="store_false")
    p.add_argument("--output", default=None, help="write .rtf file here")
    p.add_argument("--beam_unroll", type=int, default=1,
                   help="the JAX beam's lax.scan unroll: accepted, ignored")
    p.add_argument("--beam_merge", default="pairwise",
                   choices=["sort", "pairwise"],
                   help="the device beam's duplicate merge")
    p.add_argument("--fuse", default="off", choices=["on", "off"],
                   help="the JAX CLI's one-program dispatch: accepted, "
                        "ignored")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    logging.basicConfig(level=logging.INFO)
    dev = resolve_device(args.device)
    if args.fuse != "off":
        logging.info("--fuse: a TPU dispatch choice of the JAX CLI; accepted "
                     "and ignored")
    if args.beam_unroll != 1:
        logging.info("--beam_unroll: a TPU dispatch choice of the JAX CLI; "
                     "accepted and ignored")
    from paper_accurate_fast_cheap_tpu_torch.decode import rnnt_search, search

    model, model_type, input_dim = load_bench_model(args, dev)
    if args.mode == "rnnt_beam_search" and model_type != "transducer":
        raise SystemExit("rnnt_beam_search needs a transducer config")
    B, T = args.batch_size, args.chunk_size
    feats, lens = bench_features(args, B, T, input_dim, dev)
    cached = kernels_cached(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    step_fns = (rnnt_search.make_transducer_step_fns(model)
                if args.mode == "rnnt_beam_search" else None)

    @torch.no_grad()
    def run():
        enc, enc_lens = model.forward_encoder(feats, lens)
        logp = model.ctc_logprobs(enc)
        if args.mode == "ctc_greedy_search":
            return search.ctc_greedy_search(logp, enc_lens)
        return rnnt_search.rnnt_beam_search(
            *step_fns, enc, enc_lens, logp, beam_size=args.beam_size,
            ctc_weight=args.ctc_weight,
            transducer_weight=args.transducer_weight, merge=args.beam_merge)

    compile_s, elapsed, res = timed_runs(run, args.warmup, args.iters, dev)
    n_tok = int(np.mean([len(r.tokens) for r in res]))
    audio_seconds = args.iters * B * T * 0.01
    rtf = elapsed / audio_seconds
    minutes_per_sec = (audio_seconds / 60.0) / elapsed
    name = os.path.splitext(os.path.basename(args.config))[0]
    write_report([
        f"model {name}.decode_{args.mode}",
        f"final_rtf {rtf:.8f}",
        f"minutes_audio_per_sec {minutes_per_sec:.3f}",
        f"batch {B} chunk {T} iters {args.iters}",
        f"beam {args.beam_size} mean_tokens {n_tok}",
        f"fuse {args.fuse} beam_unroll {args.beam_unroll}",
        f"warmup_plus_compile_s {compile_s:.2f}",
    ] + report_tail(dev, cached), args.output)
    return 0


if __name__ == "__main__":
    sys.exit(main())
