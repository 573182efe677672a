"""Time K1 (the WKV6 forward, ``csrc/wkv6_fwd.cu``) of one checkout on the card.

Shapes: the flagship's decode call (B32 x 2250 x 8 x 64) and the training
step's call (B16 x 374 x 8 x 64), bf16, no state.  Times per call come from
``chip_smoke.py``'s timers: eager (CUDA events around back-to-back calls)
and device (calls replayed from one CUDA graph).  The K1 timed is that of
the checkout at ``--root`` (default: this one), built there from its own
``csrc/`` at first use, so two commits are set side by side by running the
tool on each in turns (needs a CUDA device and nvcc)::

    git archive <commit> | tar -x -C _baseline
    for root in _baseline . . _baseline; do
        python3 paper_accurate_fast_cheap_tpu_torch/tools/time_wkv6.py \\
            --root "$root"
    done
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SHAPES = {"decode": (32, 2250, 8, 64), "train": (16, 374, 8, 64)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=ROOT,
                    help="the checkout whose K1 is timed")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    import chip_smoke
    from paper_accurate_fast_cheap_tpu_torch.ops import wkv6_cuda

    if not torch.cuda.is_available():
        print("time_wkv6: no CUDA device", file=sys.stderr)
        return 2
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    for label, shape in SHAPES.items():
        r, k, v = (chip_smoke._randn(shape, g, 0.5).bfloat16()
                   for _ in range(3))
        w = chip_smoke._randn(shape, g, 1.0, -2.0).bfloat16()
        u = chip_smoke._randn(shape[2:], g, 0.5)

        def call():
            return wkv6_cuda.wkv6_cuda(r, k, v, w, u)

        print(json.dumps({
            "root": root, "call": label, "shape": "x".join(map(str, shape)),
            "eager_ms": chip_smoke.cuda_time_ms(call, 10),
            "device_ms": chip_smoke.device_ms(call, 10)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
