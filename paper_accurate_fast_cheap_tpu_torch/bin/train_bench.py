"""Training-step throughput benchmark CLI (port of the JAX
``bin/train_bench.py``).

Times the full step (forward + backward + global-norm clip + Adam update)
on a synthetic batch of a given (batch, frames, labels) shape and reports
steps/s, audio hours per compute hour and frames/s; for a model with an
attention decoder (the paper's config,
``examples/gigaspeech/conf/rwkvbi_ds4k31nc_12le_trans_shortform.yaml``)
also the last step's ``loss_att`` and ``th_accuracy``.

Usage:
  python -m paper_accurate_fast_cheap_tpu_torch.bin.train_bench \\
      --config conf.yaml --batch_size 16 --frames 1500 --label_len 40 \\
      --mixed_precision [--device cuda|cpu]

The step runs on ``cuda`` unless ``--device cpu``; with no card it raises.
The batch is made from ``--seed``: normal features (B, T, 80) and labels
in [1, V).  ``--profile`` splits the timed steps into forward, backward
and optimizer+clip with CUDA events (host clock on the CPU).
"""
from __future__ import annotations

import argparse
import logging
import os
import sys
import time
from typing import NamedTuple

import numpy as np
import torch


def get_args(argv=None):
    p = argparse.ArgumentParser(description="train-step throughput bench")
    p.add_argument("--config", required=True)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--frames", type=int, default=1500,
                   help="feature frames per utterance (1500 = 15 s)")
    p.add_argument("--label_len", type=int, default=40)
    p.add_argument("--accum_grad", type=int, default=None,
                   help="override config accum_grad")
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--bf16", action="store_true", default=False,
                   help="bf16 params end-to-end (no fp32 master)")
    p.add_argument("--mixed_precision", action="store_true", default=False,
                   help="bf16 compute over fp32 master weights")
    p.add_argument("--output", default=None)
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   help="dotted config override, e.g. --set grad_clip=1.5 "
                        "(repeatable)")
    p.add_argument("--platform", default=None, choices=("cpu", "tpu"),
                   help="accepted for the JAX CLI's command lines; does "
                        "nothing (see --device)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the synthetic batch (the weights use "
                        "seed + 2)")
    p.add_argument("--profile", action="store_true", default=False,
                   help="report forward / backward / optimizer+clip splits "
                        "of the timed steps")
    return p.parse_args(argv)


class Bench(NamedTuple):
    model: torch.nn.Module
    model_type: str
    step_fn: object
    state: object
    batch: tuple
    accum: int
    n_params: int
    device: torch.device


def prepare(args) -> Bench:
    """Build the model, the optimizer, the train step and the batch."""
    from paper_accurate_fast_cheap_tpu_torch import resolve_device
    from paper_accurate_fast_cheap_tpu_torch.models import factory
    from paper_accurate_fast_cheap_tpu_torch.train import schedulers
    from paper_accurate_fast_cheap_tpu_torch.train import train_step as ts
    from paper_accurate_fast_cheap_tpu_torch.utils.config import (
        load_config, override_config)

    dev = resolve_device(args.device)
    config = load_config(args.config)
    if args.overrides:
        config = override_config(config, args.overrides)
    input_dim = config.get("dataset_conf", {}).get(
        "fbank_conf", {}).get("num_mel_bins", 80)
    vocab = config.get("vocab_size_for_bench", 5002)
    model, model_type = factory.init_model(
        config, vocab, input_dim, device=dev,
        generator=torch.Generator().manual_seed(args.seed + 2))
    model.train()

    B, T, U = args.batch_size, args.frames, args.label_len
    g = torch.Generator().manual_seed(args.seed)
    feats = torch.randn(B, T, input_dim, generator=g)
    labels = torch.randint(1, vocab, (B, U), generator=g)
    batch = (feats, torch.full((B,), T, dtype=torch.int64), labels,
             torch.full((B,), U, dtype=torch.int64))
    batch = tuple(x.to(dev) for x in batch)
    if args.bf16:
        model.to(torch.bfloat16)
    params = dict(model.named_parameters())
    n_params = sum(p.numel() for p in params.values())

    optim_conf = config.get("optim_conf", {})
    sched = schedulers.SCHEDULERS[config.get("scheduler", "warmuplr")](
        optim_conf.get("lr", 1e-3),
        config.get("scheduler_conf", {}).get("warmup_steps", 25000))
    optimizer = ts.make_optimizer(
        config.get("optim", "adam"), sched,
        weight_decay=optim_conf.get("weight_decay", 0.0),
        grad_clip=config.get("grad_clip", 5.0))

    def loss_fn(p, mb, seed):
        torch.manual_seed(seed)  # the step's dropout masks
        ts.bind_params(model, p)
        out = model(*mb)
        return out["loss"], {k: out[k].detach()
                             for k in ("loss_att", "th_accuracy")}

    if args.mixed_precision:
        loss_fn = ts.wrap_mixed_precision(loss_fn)

    accum = args.accum_grad or config.get("accum_grad", 1)
    step_fn = ts.make_train_step(
        loss_fn, optimizer, accum_steps=accum,
        clip_hard_maxvalue=config.get("clip_hard_maxvalue", 0.0))
    state = ts.init_train_state(
        {n: p.detach() for n, p in params.items()}, optimizer)
    if accum > 1:
        if B % accum:
            raise SystemExit(f"batch_size {B} not divisible by "
                             f"accum_grad {accum}")
        batch = tuple(x.reshape((accum, B // accum) + x.shape[1:])
                      for x in batch)
    return Bench(model, model_type, step_fn, state, batch, accum, n_params,
                 dev)


class _Marks:
    """Phase boundaries of the timed steps: CUDA events on the card, the
    host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.steps = []

    def start(self):
        self.steps.append([("start", self._now())])

    def __call__(self, name: str):
        self.steps[-1].append((name, self._now()))

    def _now(self):
        if not self.cuda:
            return time.perf_counter()
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def split_ms(self):
        """{phase: ms per step} summed over microbatches."""
        out = {}
        for marks in self.steps:
            for (_, a), (name, b) in zip(marks, marks[1:]):
                ms = (a.elapsed_time(b) if self.cuda
                      else (b - a) * 1e3)
                out[name] = out.get(name, 0.0) + ms / len(self.steps)
        return out


def run(bench: Bench, args) -> str:
    """Warm up, time ``args.iters`` steps and return the report."""
    dev = bench.device
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    state, step_fn, batch = bench.state, bench.step_fn, bench.batch
    compile_t0 = time.perf_counter()
    for i in range(max(args.warmup, 1)):
        state, loss, _ = step_fn(state, batch, 10 + i)
        loss_v = float(loss)
    compile_s = time.perf_counter() - compile_t0
    if not np.isfinite(loss_v):
        raise FloatingPointError(f"non-finite loss {loss_v}")

    marks = _Marks(dev) if args.profile else None
    sync()
    t0 = time.perf_counter()
    for i in range(args.iters):
        if marks:
            marks.start()
        state, loss, metrics = step_fn(state, batch, 100 + i, mark=marks)
    loss_v = float(loss)
    sync()  # drain
    elapsed = time.perf_counter() - t0

    B, T, U, accum = args.batch_size, args.frames, args.label_len, bench.accum
    steps_per_s = args.iters / elapsed
    # batch_size is the total utterances per optimizer step (split into
    # accum microbatches when accum > 1)
    audio_hours_per_hour = steps_per_s * B * T * 0.01
    name = os.path.splitext(os.path.basename(args.config))[0]
    device = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
              else "cpu")
    lines = [
        f"model {name}.train_step ({bench.model_type}, "
        f"{bench.n_params / 1e6:.1f}M params)",
        f"step_time_ms {elapsed / args.iters * 1e3:.2f}",
        f"steps_per_sec {steps_per_s:.3f}",
        f"audio_hours_per_compute_hour {audio_hours_per_hour:.1f}",
        f"frames_per_sec {steps_per_s * B * T:.0f}",
        f"batch {B} frames {T} labels {U} accum {accum}",
        "precision " + ("bf16" if args.bf16 else
                        "mixed_bf16" if args.mixed_precision else "fp32"),
        f"final_loss {loss_v:.3f}",
    ]
    if getattr(bench.model, "decoder", None) is not None:
        # the attention branch of the last step's loss (not in the JAX
        # CLI's report, which has no decoder-bearing lines)
        lines += [f"loss_att {float(metrics['loss_att']):.3f}",
                  f"th_accuracy {float(metrics['th_accuracy']):.4f}"]
    lines += [
        f"warmup_plus_compile_s {compile_s:.2f}",
        f"device {device}",
    ]
    if marks:
        split = marks.split_ms()
        fwd, bwd = split["forward"], split["backward"]
        lines += [
            f"profile_forward_ms {fwd:.2f}",
            f"profile_backward_ms {bwd:.2f}",
            f"profile_fwd_plus_bwd_ms {fwd + bwd:.2f}",
            f"profile_optimizer_clip_accum_ms {split['optimizer']:.2f}",
            "profile_note per-optimizer-step (microbatch times summed over "
            f"accum={accum}); phases of the timed steps, "
            + ("CUDA events" if dev.type == "cuda" else "host clock"),
        ]
    return "\n".join(lines)


def main(argv=None):
    args = get_args(argv)
    logging.basicConfig(level=logging.INFO)
    if args.platform:
        logging.info("--platform %s does nothing here (see --device)",
                     args.platform)
    report = run(prepare(args), args)
    print(report)
    if args.output:
        with open(args.output, "w") as f:
            f.write(report + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
