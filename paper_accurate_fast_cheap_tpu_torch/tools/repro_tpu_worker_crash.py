"""The crash-repro programs of the JAX package's tool of the same path, as
stress programs for the card at the same shapes.

On the TPU each case froze a program that had killed the remote worker:
24 back-to-back WKV kernel calls inside the encoder (``v7_encoder``), the
WKV kernel at long-form shapes on wide-range data (``pallas_lf``), a vocab
top-k inside a 3000-step loop (``sort_topk``), the flagship decode chain
with a VMEM-pinned kernel under one enclosing program
(``pinned_outer_jit``), and a toy multi-buffer product with pinned weights
next to an encoder-sized chain of products (``pinned_bisect``).  Here the
same programs run through the port's modules and kernels: K1 (WKV6
forward), K2 and K3 (the device beam), K5 (vocab top-k) and K7 (the
multi-buffer product, ``ops/multi_product.py``).  VMEM pinning, the WKV
kernel generations and the ``PAFC_PRED_FUSED`` switch are TPU matters and
are not ported: ``--case pinned_bisect`` streams its weights through L2,
and ``version=7`` of ``v7_encoder`` is accepted and does nothing (the port
has one WKV kernel).

Each case function takes its sizes as keyword arguments that default to
the JAX tool's, prints its ``survived`` line and returns its result.  The
flags are the JAX tool's plus ``--device`` (``cuda`` unless ``cpu`` is
asked for); ``--i-accept-worker-loss`` is still required.

    python -m paper_accurate_fast_cheap_tpu_torch.tools.repro_tpu_worker_crash \\
        --case pinned_bisect --i-accept-worker-loss [--device cpu]
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from paper_accurate_fast_cheap_tpu_torch import resolve_device

# the flagship encoder and vocabulary (the JAX package's
# __graft_entry__.FLAGSHIP_ENCODER and VOCAB), copied
FLAGSHIP_ENCODER = dict(
    output_size=512, attention_heads=8, linear_units=2048, num_blocks=12,
    selfattention_layer_type="rwkv_tmix60_bidirectional", dropout_rate=0.1,
    positional_dropout_rate=0.1, attention_dropout_rate=0.0,
    pos_enc_layer_type="rel_pos", cnn_module_kernel=31,
    cnn_module_norm="layer_norm")
VOCAB = 5002


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def v7_stack(B: int = 8, T: int = 2250, H: int = 8, N: int = 64,
             layers: int = 24, device="cuda") -> torch.Tensor:
    """The program of ``case_v7_encoder``: ``layers`` WKV calls with
    interleaved projections on a bf16 residual stream; returns x."""
    from paper_accurate_fast_cheap_tpu_torch.ops.wkv6_cuda import wkv6_cuda

    dev = torch.device(device)
    D = H * N
    g = _gen(0)
    x = torch.randn(B, T, D, generator=g).to(dev, torch.bfloat16)
    proj = (torch.randn(layers, D, 4 * D, generator=g) * 0.02).to(
        dev, torch.bfloat16)
    u = (torch.randn(H, N, generator=g) * 0.1).to(dev, torch.bfloat16)
    with torch.no_grad():
        for i in range(layers):
            rkvw = (x @ proj[i]).reshape(B, T, 4, H, N)
            r, k, v = (rkvw[:, :, j].float() for j in range(3))
            w = -rkvw[:, :, 3].float().abs() - 0.5
            y = wkv6_cuda(r, k, v, w, u.float())
            x = x + y.reshape(B, T, D).to(torch.bfloat16)
    return x


def case_v7_encoder(B: int = 8, T: int = 2250, H: int = 8, N: int = 64,
                    layers: int = 24, version: int = 7, device="cuda"):
    """24 WKV calls (12 blocks x 2 directions) with interleaved projections
    at the post-subsampling length of a 9000-frame window.  ``version`` is
    accepted and does nothing.  Without a norm the residual stream grows
    cubically and overflows to NaN from the sixth layer on, as the JAX
    tool's program does."""
    del version
    out = float(v7_stack(B, T, H, N, layers, device).float().sum())
    print("v7_encoder survived:", out, flush=True)
    return out


def case_pallas_lf(B: int = 4, T: int = 20000, H: int = 8, N: int = 64,
                   device="cuda"):
    """The WKV kernel at long-form shapes on wide-dynamic-range data shaped
    like post-projection activations (the JAX tool's RandomState(0))."""
    from paper_accurate_fast_cheap_tpu_torch.ops.wkv6_cuda import wkv6_cuda

    rng = np.random.RandomState(0)

    def mk(scale):
        return (rng.randn(B, T, H, N) * scale).astype(np.float32)

    r, k, v = mk(1.0), mk(0.5), mk(4.0)
    w = -np.abs(rng.randn(B, T, H, N) * 2.0 + 2.0).astype(np.float32)
    u = (rng.randn(H, N) * 0.1).astype(np.float32)
    with torch.no_grad():
        y = wkv6_cuda(*(torch.from_numpy(a).to(device)
                        for a in (r, k, v, w, u)))
    out = float(y.sum())
    print("pallas_lf survived:", out, flush=True)
    return out


def case_sort_topk(B: int = 64, BEAM: int = 8, V: int = 5002,
                   STEPS: int = 3000, device="cuda"):
    """An exact vocab top-k (K5, ``ops/topk.top_k_vocab``: ties to the lowest
    index, unlike ``torch.topk``) inside a 3000-step loop whose carry feeds
    the next step."""
    from paper_accurate_fast_cheap_tpu_torch.ops.topk import top_k_vocab

    carry = torch.randn(B, BEAM, V, generator=_gen(0)).to(device)
    idxs = []
    for _ in range(STEPS):
        vals, idx = top_k_vocab(carry, BEAM)
        carry = carry * 0.999 + vals.sum(-1, keepdim=True) * 1e-6
        idxs.append(idx)
    idxs = torch.stack(idxs)
    out = float(carry.sum())
    print("sort_topk survived:", out, tuple(idxs.shape), flush=True)
    return out, tuple(idxs.shape)


def case_pinned_outer_jit(B: int = 32, T: int = 9000, device="cuda"):
    """The flagship decode chain in one program on the TPU: encoder -> CTC ->
    device prefix beam (beam 8, CTC 0.3 / transducer 0.7) -> pack ->
    finalize, bf16 weights, random features.  Here through the port's
    modules (K1 in the encoder, K2 and K3 in the beam)."""
    from paper_accurate_fast_cheap_tpu_torch.decode import rnnt_search
    from paper_accurate_fast_cheap_tpu_torch.models import factory

    config = {
        "model": "transducer", "encoder": "conformer",
        "encoder_conf": FLAGSHIP_ENCODER,
        "predictor": "rnn",
        "predictor_conf": {"embed_size": 640, "output_size": 640,
                           "embed_dropout": 0.1, "hidden_size": 640,
                           "num_layers": 2, "dropout": 0.1},
        "joint_conf": {"join_dim": 640},
        "decoder": None,
        "model_conf": {"ctc_weight": 0.3, "transducer_weight": 0.7,
                       "attention_weight": 0.0},
    }
    model, _ = factory.init_model(config, VOCAB, 80, device=device,
                                  generator=_gen(1))
    model = model.to(torch.bfloat16)
    feats = torch.randn(B, T, 80, generator=_gen(0)).to(device,
                                                         torch.bfloat16)
    lens = torch.full((B,), T, dtype=torch.int64, device=device)
    enc, elens = model.forward_encoder(feats, lens)
    logp = model.ctc_logprobs(enc)
    carry = rnnt_search.rnnt_beam_search(
        *rnnt_search.make_transducer_step_fns(model), enc, elens, logp,
        beam_size=8, ctc_weight=0.3, transducer_weight=0.7, impl="device",
        defer=True)
    res = rnnt_search.finalize_device_beam(
        rnnt_search.pack_device_beam(carry), beam=8)
    print("pinned_outer_jit survived:", len(res), flush=True)
    return res


def buffer_cols(pinned_mb: float, buffers: int, D: int = 512) -> int:
    """The bf16 columns of each of ``buffers`` (D, H) buffers totalling
    ``pinned_mb`` MB, a multiple of 128 (at least 128)."""
    per = pinned_mb * 1024 * 1024 / buffers
    return max(128, int(per / (D * 2)) // 128 * 128)


def case_pinned_bisect(pinned_mb: float = 10.0, buffers: int = 2,
                       with_encoder: bool = True, rows: int = 4096,
                       D: int = 512, device="cuda"):
    """``buffers`` bf16 weight buffers totalling ``pinned_mb`` MB fed to the
    multi-buffer product (K7) on the first 4096 rows of a (rows, D) input,
    optionally after an encoder-sized chain of 12 ``tanh(z @ ones * 0.01)``
    products (plain ``torch.matmul``: the JAX tool leaves it to XLA)."""
    from paper_accurate_fast_cheap_tpu_torch.ops.multi_product import (
        multi_product)

    dev = torch.device(device)
    H = buffer_cols(pinned_mb, buffers, D)
    total_mb = buffers * D * H * 2 / 1024 / 1024
    print(f"pinned_bisect: {buffers} buffers x ({D},{H}) bf16 = "
          f"{total_mb:.1f} MB pinned, with_encoder={with_encoder}",
          flush=True)
    ws = [(torch.randn(D, H, generator=_gen(i)) * 0.02).to(dev,
                                                          torch.bfloat16)
          for i in range(buffers)]
    z = torch.randn(rows, D, generator=_gen(99)).to(dev, torch.bfloat16)
    with torch.no_grad():
        if with_encoder:
            ones = torch.ones(D, D, dtype=torch.bfloat16, device=dev)
            for _ in range(12):
                z = torch.tanh(z @ ones * 0.01)
        y = multi_product(z[:4096], ws)
    v = float(y.float().sum())
    print(f"pinned_bisect survived: {v:.4f} "
          f"({total_mb:.1f} MB / {buffers} buffers)", flush=True)
    return v


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--case", required=True,
                    choices=["v7_encoder", "pallas_lf", "sort_topk",
                             "pinned_outer_jit", "pinned_bisect"])
    ap.add_argument("--pinned_mb", type=float, default=10.0,
                    help="pinned_bisect: total weight MB")
    ap.add_argument("--buffers", type=int, default=2,
                    help="pinned_bisect: number of weight buffers")
    ap.add_argument("--no_encoder", action="store_true",
                    help="pinned_bisect: drop the co-resident product chain")
    ap.add_argument("--i-accept-worker-loss", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if not args.i_accept_worker_loss:
        sys.exit("refusing: pass --i-accept-worker-loss (the programs are "
                 "the TPU crash repros, run here as stress programs)")
    # the JAX tool's _require_tpu: the card unless the CPU was asked for
    dev = resolve_device(args.device)
    t0 = time.time()
    if args.case == "pinned_bisect":
        case_pinned_bisect(args.pinned_mb, args.buffers,
                           not args.no_encoder, device=dev)
    else:
        {"v7_encoder": case_v7_encoder,
         "pallas_lf": case_pallas_lf,
         "sort_topk": case_sort_topk,
         "pinned_outer_jit": case_pinned_outer_jit}[args.case](device=dev)
    print(f"done in {time.time() - t0:.1f}s (no crash this run)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
