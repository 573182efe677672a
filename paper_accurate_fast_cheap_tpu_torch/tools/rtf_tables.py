"""RTF sweep aggregation (port of the JAX ``tools/rtf_tables.py``): parse
the ``.rtf`` files that ``bin/encoder_rtf.py``, ``bin/decode_rtf.py`` and
``bin/recognize_wav.py`` write and print mean +/- std tables per (model,
batch, chunk).

Usage: python -m paper_accurate_fast_cheap_tpu_torch.tools.rtf_tables \
    'rtf_sweep/*.rtf'
"""
from __future__ import annotations

import argparse
import collections
import glob
import re
import sys

import numpy as np

_FLOAT_KEYS = ("final_rtf", "minutes_audio_per_sec", "elapsed",
               "audio_seconds", "max_cpu_ram_mb")


def parse_rtf_file(path: str) -> dict:
    out = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2 and parts[0] in _FLOAT_KEYS:
                out[parts[0]] = float(parts[1])
            if len(parts) >= 2 and parts[0] == "model":
                out["model"] = parts[1]
            m = re.match(r"batch (\d+) chunk (\d+)", line)
            if m:
                out["batch"] = int(m.group(1))
                out["chunk"] = int(m.group(2))
    return out


def aggregate(paths):
    """One row per (model, batch, chunk) over the files with a final_rtf:
    the runs and the mean and std of RTF and 1/RTF."""
    groups = collections.defaultdict(list)
    for p in paths:
        d = parse_rtf_file(p)
        if "final_rtf" not in d:
            continue
        key = (d.get("model", ""), d.get("batch", 0), d.get("chunk", 0))
        groups[key].append(d["final_rtf"])
    rows = []
    for (model, batch, chunk), vals in sorted(groups.items()):
        arr = np.asarray(vals)
        inv = 1.0 / arr
        rows.append({
            "model": model, "batch": batch, "chunk": chunk,
            "runs": len(vals), "n": len(vals),
            "rtf_mean": float(arr.mean()), "rtf_std": float(arr.std()),
            "inv_rtf_mean": float(inv.mean()),
            "inv_rtf_std": float(inv.std()),
        })
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description="aggregate .rtf sweep files")
    p.add_argument("glob", help="e.g. 'exp/rtf/*.rtf'")
    args = p.parse_args(argv)
    rows = aggregate(glob.glob(args.glob))
    print(f"{'batch':>6} {'chunk':>8} {'runs':>5} {'RTF mean':>12} "
          f"{'std':>10} {'1/RTF':>10}")
    for r in rows:
        print(f"{r['batch']:>6} {r['chunk']:>8} {r['runs']:>5} "
              f"{r['rtf_mean']:>12.6f} {r['rtf_std']:>10.6f} "
              f"{r['inv_rtf_mean']:>10.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
