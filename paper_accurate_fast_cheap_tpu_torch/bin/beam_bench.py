"""Beam-search-only benchmark, no encoder (port of the JAX
``bin/beam_bench.py``): the device prefix beam (``decode/rnnt_search.py``)
over random blank-biased CTC posteriors at the paper's short-form point
(batch 64, 750 frames after the /4 subsampling = 30 s, beam 8), with a
toy predictor and joint of the flagship's per-frame work class: one
embedding + tanh recurrence step and a bilinear joint.  The joint has no
split form, so the beam's ``auto`` route takes ``pallas``: K4
(``ops/fused_topk.py``) once a frame.

The timed region ends in ``torch.cuda.synchronize()``; the per-frame time
is the timed runs' wall time over their frames.  The inputs and weights
come from a ``torch.Generator`` seeded 0, in bf16.

Usage:
  python -m paper_accurate_fast_cheap_tpu_torch.bin.beam_bench \\
      [--merge sort|pairwise] [--device cpu --batch_size 2 --frames 20 \\
       --vocab 50 --enc_dim 16 --pred_dim 16]
"""
from __future__ import annotations

import argparse
import logging
import sys

import torch

from paper_accurate_fast_cheap_tpu_torch import resolve_device


def get_args(argv=None):
    p = argparse.ArgumentParser(description="beam-only RTF microbench")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--frames", type=int, default=750,
                   help="post-subsampling frames (750 = 30 s at ds4)")
    p.add_argument("--vocab", type=int, default=5002)
    p.add_argument("--enc_dim", type=int, default=512)
    p.add_argument("--pred_dim", type=int, default=512)
    p.add_argument("--beam_size", type=int, default=8)
    p.add_argument("--merge", default="sort", choices=["sort", "pairwise"])
    p.add_argument("--unroll", type=int, default=1,
                   help="the JAX beam's lax.scan unroll: accepted, ignored")
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--platform", default=None,
                   help="the JAX CLI's platform switch: ignored (--device)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def toy_inputs(B: int, T: int, V: int, De: int, H: int, dev):
    """(enc (B, T, De), ctc log-probs (B, T, V) f32 with blank favoured by
    +4 logits, lens (B,), bf16 toy weights {"E", "W", "A", "Bm"}) from a
    generator seeded 0."""
    g = torch.Generator().manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(
            dev, torch.bfloat16)

    enc = randn(B, T, De)
    logits = torch.randn(B, T, V, generator=g)
    logits[..., 0] += 4.0
    ctc = torch.log_softmax(logits, dim=-1).to(dev)
    params = {"E": randn(V, H), "W": randn(H, H, scale=0.02),
              "A": randn(De, V), "Bm": randn(H, V)}
    lens = torch.full((B,), T, dtype=torch.int32, device=dev)
    return enc, ctc, lens, params


def toy_step_fns(params):
    """(predictor_step, joint_step, init_state_fn) of the toy model: the
    state is one (n, H) tensor, ``s' = tanh(s W + E[token])``, the output
    is the state; the joint is ``log_softmax(f32(enc_t A + pred Bm))``."""
    E, W, A, Bm = params["E"], params["W"], params["A"], params["Bm"]

    def predictor_step(tokens, state):
        s = torch.tanh(state[0] @ W + E[tokens.long()])
        return s, (s,)

    def joint_step(enc_t, pred):
        return torch.log_softmax((enc_t @ A + pred @ Bm).float(), dim=-1)

    def init_state_fn(n):
        return (torch.zeros(n, W.shape[0], dtype=W.dtype, device=W.device),)

    return predictor_step, joint_step, init_state_fn


def main(argv=None):
    args = get_args(argv)
    logging.basicConfig(level=logging.INFO)
    dev = resolve_device(args.device)
    if args.unroll != 1 or args.platform:
        logging.info("--unroll and --platform: TPU dispatch choices of the "
                     "JAX CLI; accepted and ignored")
    from paper_accurate_fast_cheap_tpu_torch.bin.encoder_rtf import (
        device_name, kernels_cached, timed_runs)
    from paper_accurate_fast_cheap_tpu_torch.decode import rnnt_search

    B, T = args.batch_size, args.frames
    enc, ctc, lens, params = toy_inputs(B, T, args.vocab, args.enc_dim,
                                        args.pred_dim, dev)
    fns = toy_step_fns(params)
    cached = kernels_cached(dev)

    def run():
        return rnnt_search.rnnt_beam_search(
            *fns, enc, lens, ctc, beam_size=args.beam_size, blank_id=0,
            ctc_weight=0.3, transducer_weight=0.7, impl="device",
            defer=True, merge=args.merge)

    _, elapsed, _ = timed_runs(run, args.warmup, args.iters, dev)
    audio_s = B * T * 0.04 * args.iters  # ds4 frames -> 40 ms each
    per_frame_ms = elapsed / (args.iters * T) * 1e3
    print(f"merge={args.merge} unroll={args.unroll} B={B} T={T} "
          f"beam={args.beam_size}: {elapsed / args.iters * 1e3:.1f} ms/iter, "
          f"{per_frame_ms:.3f} ms/frame, 1/RTF={audio_s / elapsed:.0f}x")
    print(f"device {device_name(dev)} kernels_cached {cached}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
