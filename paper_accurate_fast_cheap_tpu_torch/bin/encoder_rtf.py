"""Encoder-only RTF benchmark CLI (port of the JAX ``bin/encoder_rtf.py``,
the paper's 1/RTF harness): encoder + CTC head over B windows of ``chunk``
random feature frames, warmup then ``iters`` timed forwards, with
wall-clock RTF, minutes of audio a second and peak memory, written as the
``.rtf`` lines ``tools/rtf_tables.py`` aggregates.  The sweep mode runs
every (batch, chunk) pair of ``--sweep_batches`` x ``--sweep_chunks``
``--sweep_runs`` times and prints the aggregated rows.

The weights are random (seed 1) unless ``--checkpoint`` names the port's
state_dict file; the features come from a ``torch.Generator`` seeded 0.
With ``--bf16`` (the default) every floating parameter and the features
are cast to bf16.  The timed region ends in
``torch.cuda.synchronize()``; ``warmup_plus_compile_s`` covers the first
calls, which build the CUDA kernels when ``_build/`` holds none for this
source tree (the ``kernels_cached`` line says which).  The peak memory is
reset at the start of each run, so each ``.rtf`` holds its own run's.

Usage:
  python -m paper_accurate_fast_cheap_tpu_torch.bin.encoder_rtf \\
      --config examples/gigaspeech/conf/bench_rwkvbi_ds4k31nc_12le.yaml \\
      [--batch_size 4 --chunk_size 9000] [--device cpu]
"""
from __future__ import annotations

import argparse
import logging
import os
import resource
import sys
import time

import torch

from paper_accurate_fast_cheap_tpu_torch import resolve_device


def get_args(argv=None):
    p = argparse.ArgumentParser(description="encoder RTF benchmark")
    p.add_argument("--config", required=True)
    p.add_argument("--checkpoint", default=None,
                   help="the port's state_dict file; random weights if "
                        "omitted")
    p.add_argument("--chunk_size", type=int, default=9000,
                   help="frames per window")
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--bf16", action="store_true", default=True)
    p.add_argument("--no-bf16", dest="bf16", action="store_false")
    p.add_argument("--output", default=None, help="write .rtf file here")
    p.add_argument("--sweep_batches", default=None,
                   help="comma list, e.g. 1,4,8,14")
    p.add_argument("--sweep_chunks", default=None,
                   help="comma list, e.g. 2000,9000,40000")
    p.add_argument("--sweep_runs", type=int, default=1)
    p.add_argument("--sweep_dir", default=None,
                   help="directory for sweep .rtf files")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def load_bench_model(args, dev: torch.device):
    """(model, model type, input dim): the config's model with random
    weights (seed 1) or the checkpoint's, in eval mode on ``dev``, cast to
    bf16 with ``args.bf16``."""
    from paper_accurate_fast_cheap_tpu_torch.models import factory
    from paper_accurate_fast_cheap_tpu_torch.utils.config import load_config

    config = load_config(args.config)
    input_dim = config.get("dataset_conf", {}).get(
        "fbank_conf", {}).get("num_mel_bins", 80)
    vocab = config.get("vocab_size_for_bench", 5002)
    model, model_type = factory.init_model(
        config, vocab, input_dim, device="cpu",
        generator=torch.Generator().manual_seed(1))
    if args.checkpoint:
        model.load_state_dict(torch.load(args.checkpoint, map_location="cpu",
                                         weights_only=True))
    model = model.to(dev).eval()
    if args.bf16:
        model = model.to(torch.bfloat16)
    return model, model_type, input_dim


def bench_features(args, batch: int, chunk: int, input_dim: int,
                   dev: torch.device):
    """Random features (B, chunk, input_dim) from seed 0 and their
    lengths, in the model's dtype."""
    g = torch.Generator().manual_seed(0)
    feats = torch.randn(batch, chunk, input_dim, generator=g).to(dev)
    if args.bf16:
        feats = feats.to(torch.bfloat16)
    return feats, torch.full((batch,), chunk, dtype=torch.int32, device=dev)


def timed_runs(fn, warmup: int, iters: int, dev: torch.device):
    """(warmup seconds, timed seconds, last result): ``max(warmup, 1)``
    calls, then ``iters`` calls, each block fenced by a synchronize."""
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    sync()
    t0 = time.perf_counter()
    for _ in range(max(warmup, 1)):
        res = fn()
    sync()
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(iters):
        res = fn()
    sync()
    return compile_s, time.perf_counter() - t0, res


def kernels_cached(dev: torch.device) -> str:
    """Whether every CUDA kernel of this source tree was built before the
    run (so the warmup timed no nvcc)."""
    if dev.type != "cuda":
        return "n/a (cpu: plain versions)"
    from paper_accurate_fast_cheap_tpu_torch.ops import cuda_lib

    missing = [n for n in cuda_lib.SOURCES
               if not os.path.exists(cuda_lib.lib_path(n))]
    return "yes" if not missing else f"no (built: {','.join(missing)})"


def device_name(dev: torch.device) -> str:
    if dev.type == "cuda":
        return f"{dev} {torch.cuda.get_device_name(dev)}"
    return str(dev)


def report_tail(dev: torch.device, cached: str) -> list:
    """The .rtf lines after the timing: host and card peaks, the device
    and whether the kernels were built before the run."""
    from paper_accurate_fast_cheap_tpu_torch.utils.profiling import (
        device_memory_stats)

    max_rss_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
    dev_mb = device_memory_stats(dev).get("peak_bytes_in_use_mb", 0.0)
    return [f"max_cpu_ram_mb {max_rss_mb:.1f}",
            f"max_vram_mb {dev_mb:.1f}",
            f"device {device_name(dev)}",
            f"kernels_cached {cached}"]


def write_report(lines, output) -> None:
    report = "\n".join(lines)
    print(report)
    if output:
        with open(output, "w") as f:
            f.write(report + "\n")


def main(argv=None):
    args = get_args(argv)
    logging.basicConfig(level=logging.INFO)
    dev = resolve_device(args.device)
    model, _, input_dim = load_bench_model(args, dev)
    if args.sweep_batches or args.sweep_chunks:
        from paper_accurate_fast_cheap_tpu_torch.tools import rtf_tables

        batches = [int(x) for x in
                   (args.sweep_batches or str(args.batch_size)).split(",")]
        chunks = [int(x) for x in
                  (args.sweep_chunks or str(args.chunk_size)).split(",")]
        out_dir = args.sweep_dir or "rtf_sweep"
        os.makedirs(out_dir, exist_ok=True)
        for run in range(args.sweep_runs):
            for b in batches:
                for c in chunks:
                    run_once(args, model, input_dim, dev, b, c,
                             os.path.join(out_dir, f"run{run}_b{b}_c{c}.rtf"))
        rows = rtf_tables.aggregate(
            [os.path.join(out_dir, f) for f in os.listdir(out_dir)
             if f.endswith(".rtf")])
        for r in rows:
            print(r)
        return 0
    return run_once(args, model, input_dim, dev, args.batch_size,
                    args.chunk_size, args.output)


def run_once(args, model, input_dim, dev, batch, chunk, output=None):
    B, T = batch, chunk
    feats, lens = bench_features(args, B, T, input_dim, dev)
    cached = kernels_cached(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    @torch.no_grad()
    def fwd():
        enc, _ = model.forward_encoder(feats, lens)
        return model.ctc_logprobs(enc)

    compile_s, elapsed, _ = timed_runs(fwd, args.warmup, args.iters, dev)
    audio_seconds = args.iters * B * T * 0.01
    rtf = elapsed / audio_seconds
    minutes_per_sec = (audio_seconds / 60.0) / elapsed
    name = os.path.splitext(os.path.basename(args.config))[0]
    write_report([
        f"model {name}",
        f"final_rtf {rtf:.8f}",
        f"minutes_audio_per_sec {minutes_per_sec:.3f}",
        f"batch {B} chunk {T} iters {args.iters}",
        f"warmup_plus_compile_s {compile_s:.2f}",
    ] + report_tail(dev, cached), output)
    return 0


if __name__ == "__main__":
    sys.exit(main())
