"""Time one kernel of one checkout on the card.

``wkv6``: K1 at the flagship's decode (B32 x 2250 x 8 x 64) and training
(B16 x 374 x 8 x 64) calls, bf16; ``fused_topk`` (K4, bf16) and ``topk``
(K5, f32): one flagship beam frame, 32 x 8 rows of V = 5002, per ``--k``.
Eager (CUDA events around back-to-back calls) and device (calls replayed
from one CUDA graph) ms come from ``chip_smoke.py``'s timers.  The kernel
is that of the checkout at ``--root``, built from its own ``csrc/``, so
two commits are compared by running the tool on each in turns (a CUDA
device and nvcc)::

    git archive <commit> | tar -x -C _scratch/parent
    for root in _scratch/parent . . _scratch/parent; do
        python3 paper_accurate_fast_cheap_tpu_torch/tools/time_kernel.py \\
            --kernel topk --root "$root"
    done
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def calls(kernel, ks, cs, g):
    import torch  # (label, fn) pairs: one kernel call per fn

    from paper_accurate_fast_cheap_tpu_torch.ops import (
        fused_topk, topk, wkv6_cuda)

    if kernel == "wkv6":
        for label, shape in (("decode", (32, 2250, 8, 64)),
                             ("train", (16, 374, 8, 64))):
            r, k, v = (cs._randn(shape, g, 0.5).bfloat16() for _ in range(3))
            w = cs._randn(shape, g, 1.0, -2.0).bfloat16()
            u = cs._randn(shape[2:], g, 0.5)
            yield label, lambda: wkv6_cuda.wkv6_cuda(r, k, v, w, u)
        return
    N, tw, cw = 8, math.log(0.7), math.log(0.3)
    logp = torch.log_softmax(cs._randn((32 * N, 5002), g, 2.0), -1)
    ctc = torch.log_softmax(cs._randn((32, 3, 5002), g, 2.0), -1)
    lp, c = logp.bfloat16(), ctc.bfloat16()[:, 1]      # strided, as the beam
    x = torch.logaddexp(tw + logp, cw + ctc[:, 1].repeat_interleave(N, 0))
    for k in ks:
        if kernel == "fused_topk":
            yield f"bf16 k={k}", (
                lambda k=k: fused_topk.fused_top_k_vocab(lp, c, k, tw, cw))
        else:
            yield f"f32 k={k}", lambda k=k: topk.top_k_vocab(x, k)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=("wkv6", "fused_topk", "topk"),
                    default="wkv6")
    ap.add_argument("--k", type=int, nargs="+", default=[8, 40, 128],
                    help="the top-k kernels' k")
    ap.add_argument("--root", default=ROOT,
                    help="the checkout whose kernel is timed")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("time_kernel: no CUDA device", file=sys.stderr)
        return 2
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    for label, fn in calls(args.kernel, args.k, cs, g):
        print(json.dumps({
            "root": root, "kernel": args.kernel, "call": label,
            "eager_ms": cs.cuda_time_ms(fn, 10),
            "device_ms": cs.device_ms(fn, 10)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
