"""Encoder-RTF sweep driver (port of the recipe's
``local/run_rtf_sweep.py``): one ``bin/encoder_rtf`` subprocess per
(model, batch, chunk), so an out-of-memory or failed combo is skipped
instead of ending the sweep.

Mirrors the reference harness
`examples/gigaspeech/s0/local/go-run-encoder-rtf.single-gpu-3x3-g5.sh:59-107`
(5 runs x batch {1,4,8,10,12,14} x chunk {2k..200k} x 13 model variants on
an A10G); here: configurable runs x batch x chunk over the bench YAMLs of
the four attention families and the deeper RWKV variants, on the card
unless ``--device cpu``.  The table (``tools/rtf_tables.py``'s rows) is
written to ``<out_dir>/summary.md`` and printed; nothing outside
``--out_dir`` is written.

Usage:
  python -m paper_accurate_fast_cheap_tpu_torch.examples.gigaspeech.local.run_rtf_sweep \\
      --out_dir rtf_sweep --runs 1 --batches 1,4,8,14 \\
      --chunks 2000,9000,40000,100000 [--device cpu]
"""
import argparse
import os
import subprocess
import sys

from paper_accurate_fast_cheap_tpu_torch.examples.gigaspeech.local import (
    CONF_DIR, REPO)

MODELS = {
    "rwkv_bi_12L": "bench_rwkvbi_ds4k31nc_12le.yaml",
    "mha_12L": "bench_mha_ds4k31nc_12le.yaml",
    "mamba2_bi_12L": "bench_mamba_bi_ds4k31nc_12le.yaml",
    "mha_lca256_gt_12L": "bench_mha_lca256_gt_ds4k31nc_12le.yaml",
    # deeper variants mirror the reference's 18/24/30-layer model axis
    # (go-run-encoder-rtf.single-gpu-3x3-g5.sh:59-107)
    "rwkv_bi_18L": "bench_rwkvbi_ds4k31nc_18le.yaml",
    "rwkv_bi_24L": "bench_rwkvbi_ds4k31nc_24le.yaml",
    "rwkv_bi_30L": "bench_rwkvbi_ds4k31nc_30le.yaml",
    "mha_24L": "bench_mha_ds4k31nc_24le.yaml",
}
# full self-attention is O(T^2): cap MHA chunks like the reference caps its
# per-model sweep ranges
CHUNK_CAP = {"mha_12L": 40000, "mha_24L": 40000}


def sweep_table(rows, failures) -> str:
    lines = [
        "# encoder RTF sweep",
        "",
        "Driver: `paper_accurate_fast_cheap_tpu_torch/examples/gigaspeech/"
        "local/run_rtf_sweep.py`",
        "(mirrors the reference `local/go-run-encoder-rtf.single-gpu-3x3-"
        "g5.sh:59-107`).",
        "Metric: 1/RTF = x realtime; higher is better.",
        "",
        "| model | batch | chunk | 1/RTF mean | std | runs |",
        "|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| {r['model']} | {r['batch']} | {r['chunk']} | "
            f"{r['inv_rtf_mean']:.1f} | {r['inv_rtf_std']:.1f} | {r['n']} |")
    if failures:
        lines += ["", "## Skipped/failed combos", ""]
        for name, b, c, why in failures:
            last = why.splitlines()[-1] if why else "failed"
            lines.append(f"- {name} b={b} c={c}: {last}")
    return "\n".join(lines) + "\n"


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out_dir", required=True)
    p.add_argument("--runs", type=int, default=1)
    p.add_argument("--batches", default="1,4,8,14")
    p.add_argument("--chunks", default="2000,9000,40000,100000")
    p.add_argument("--models", default=",".join(MODELS))
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--timeout", type=int, default=900,
                   help="seconds for one combo's subprocess")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
    batches = [int(x) for x in args.batches.split(",")]
    chunks = [int(x) for x in args.chunks.split(",")]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [x for x in [env.get("PYTHONPATH")] if x])
    failures = []
    for name in args.models.split(","):
        cfg = os.path.join(CONF_DIR, MODELS[name])
        for run in range(args.runs):
            for b in batches:
                for c in chunks:
                    if c > CHUNK_CAP.get(name, 10 ** 9):
                        continue
                    out = os.path.join(
                        args.out_dir, f"{name}_run{run}_b{b}_c{c}.rtf")
                    if os.path.exists(out):
                        continue
                    cmd = [sys.executable, "-m",
                           "paper_accurate_fast_cheap_tpu_torch.bin."
                           "encoder_rtf",
                           "--config", cfg, "--batch_size", str(b),
                           "--chunk_size", str(c), "--iters",
                           str(args.iters), "--output", out,
                           "--device", args.device]
                    print("RUN", name, f"b={b} c={c}", flush=True)
                    try:
                        r = subprocess.run(cmd, cwd=REPO, env=env,
                                           timeout=args.timeout,
                                           capture_output=True, text=True)
                        if r.returncode != 0:
                            failures.append((name, b, c,
                                             r.stderr.strip()[-300:]))
                            print("  FAILED", flush=True)
                    except subprocess.TimeoutExpired:
                        failures.append((name, b, c, "timeout"))
                        print("  TIMEOUT", flush=True)
    from paper_accurate_fast_cheap_tpu_torch.tools import rtf_tables

    paths = [os.path.join(args.out_dir, f)
             for f in sorted(os.listdir(args.out_dir)) if f.endswith(".rtf")]
    md = sweep_table(rtf_tables.aggregate(paths), failures)
    with open(os.path.join(args.out_dir, "summary.md"), "w") as f:
        f.write(md)
    print(md)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
