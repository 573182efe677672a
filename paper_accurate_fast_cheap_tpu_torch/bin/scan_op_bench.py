"""Per-component timing of the device beam's frame step (port of the JAX
``bin/scan_op_bench.py``).

``bin/beam_bench.py`` prices the whole frame step; this harness prices
each sub-block alone, ``frames`` steps of it per run, so one call
attributes the per-frame cost across: the floor of one queued op
(``noop``), the joint product + log-softmax, the CTC fusion, the vocab
top-k, the pairwise duplicate merge, the predictor-state gather, the
predictor step, the hypothesis-buffer update and the (B, N) bookkeeping.

The beam's frame step is a Python loop of tensor ops, so each component
here is too: per frame, the host queues its ops and the card runs them.
The wall time (fenced by ``torch.cuda.synchronize()``) and, on the card,
the device time of one more run's kernels (``torch.profiler``) are printed
side by side, in ms a frame.  Components that carry a state (pred,
gather, hypbuf, bookkeep) consume their own output, as the beam does.

``topk`` and ``pallas_topk`` both run K5 (``ops/topk.top_k_vocab``, the
port's vocab top-k); the two names stay so that ``--only`` lists written
for the JAX harness still run.  ``lax_topk`` is ``torch.topk``, the
library yardstick.  ``approx_topk`` (a TPU approximate top-k) has no
counterpart and raises.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from paper_accurate_fast_cheap_tpu_torch import resolve_device

APPROX_TOPK_REFUSAL = (
    "approx_topk is jax.lax.approx_max_k, a TPU approximate op: a TPU "
    "workaround the port does not carry (ROADMAP ground rules, 'TPU "
    "workarounds are not ported')")
_NOT_CORE = ("noop", "lax_topk", "approx_topk")


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _run(body, carry, T):
    for _ in range(T):
        carry = body(carry)
    return carry


def timed_loop(body, carry0, T: int, warmup: int, iters: int, dev):
    """(wall ms a frame, device ms a frame or None off the card): ``warmup``
    then ``iters`` runs of T steps; the device time is torch.profiler's sum
    of kernel time over one more run."""
    c = carry0
    for _ in range(warmup):
        c = _run(body, c, T)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        c = _run(body, c, T)
    _sync(dev)
    wall = (time.perf_counter() - t0) / (iters * T) * 1e3
    if dev.type != "cuda":
        return wall, None
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _run(body, c, T)
        _sync(dev)
    us = 0.0
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        us += max(getattr(e, "cuda_time_total", 0) if t is None else t, 0)
    return wall, us / 1e3 / T


def components(B, T, V, De, H, N, dev):
    """{name: (body(carry) -> carry, carry0)} at the beam's shapes."""
    from paper_accurate_fast_cheap_tpu_torch.decode.rnnt_search import (
        P1, P2, _M32, _mul_u32)
    from paper_accurate_fast_cheap_tpu_torch.ops.topk import (
        stable_top_k, top_k_vocab)

    NK, BN = N * N, B * N
    g = torch.Generator().manual_seed(0)
    bf = torch.bfloat16

    def randn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(*shape, generator=g) * scale).to(dev, dtype)

    A = randn(De, V, scale=0.02)
    Bm = randn(H, V, scale=0.02)
    E = randn(V, H, scale=0.02)
    W = randn(H, H, scale=0.02)
    enc = randn(BN, De)
    ctc_row = torch.log_softmax(randn(BN, V, dtype=torch.float32), dim=-1)
    ones_h = torch.ones(H, dtype=bf, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    comps = {}

    comps["noop"] = (lambda c: c + 1,
                     torch.zeros(8, 128, device=dev))
    comps["joint"] = (lambda c: torch.log_softmax(
        (enc @ A + ones_h @ Bm).float(), dim=-1), None)
    comps["fuse"] = (lambda c: torch.logaddexp(ctc_row, ctc_row - 1.0), None)
    x3 = ctc_row.reshape(B, N, V)
    comps["topk"] = (lambda c: top_k_vocab(x3, N), None)
    comps["lax_topk"] = (lambda c: torch.topk(x3, N), None)

    def approx_topk(c):
        raise NotImplementedError(APPROX_TOPK_REFUSAL)
    comps["approx_topk"] = (approx_topk, None)
    comps["pallas_topk"] = comps["topk"]

    c_score = randn(B, NK, dtype=torch.float32)
    c_h1 = torch.randint(0, 1 << 20, (B, NK), generator=g).to(dev)
    c_len = c_h1 % 7
    jidx = torch.arange(NK, device=dev)
    j_lt_i = (jidx[:, None] < jidx[None, :])[None]
    neg = float("-inf")

    def merge(c):
        eq = ((c_h1[:, :, None] == c_h1[:, None, :])
              & (c_len[:, :, None] == c_len[:, None, :]))
        sc_j, sc_i = c_score[:, :, None], c_score[:, None, :]
        before = (sc_j > sc_i) | ((sc_j == sc_i) & j_lt_i)
        is_first = ~torch.any(eq & before, dim=1)
        firsts_before = torch.sum(is_first[:, :, None] & before, dim=1)
        in_win = firsts_before < N
        contrib = torch.where(eq & in_win[:, None, :], c_score[:, None, :],
                              neg)
        merged = torch.logsumexp(contrib, dim=-1)
        final = torch.where(is_first & in_win, merged, neg)
        return stable_top_k(final, N)
    comps["merge"] = (merge, None)

    sel0 = torch.randint(0, BN, (BN,), generator=g).to(dev)

    def gather(c):
        tick, s1, s2 = c
        sel = (sel0 + tick) % BN
        adv = (sel % 2).bool()[None, :, None]
        g1, g2 = s1[:, sel], s2[:, sel]
        return (tick + 1, torch.where(adv, g1, g1 * 0.5),
                torch.where(adv, g2, g2 * 0.5))
    comps["gather"] = (gather, (0, torch.ones(2, BN, H, dtype=bf,
                                              device=dev),
                                torch.zeros(2, BN, H, dtype=bf, device=dev)))
    comps["pred"] = (lambda s: torch.tanh(s @ W + E[0][None, :]),
                     torch.zeros(BN, H, dtype=bf, device=dev))

    L = T
    lpos = torch.arange(L, device=dev)

    def hypbuf(c):
        hyps, tick = c
        n_src = (sel0[:BN].reshape(B, N) + tick) % N
        n_tok = ((n_src + tick) % V).to(torch.int32)
        hyps_g = torch.gather(hyps, 1, n_src[:, :, None].expand(B, N, L))
        wmask = lpos[None, None, :] == tick % L
        return torch.where(wmask, n_tok[:, :, None], hyps_g), tick + 1
    comps["hypbuf"] = (hypbuf, (torch.zeros(B, N, L, **i32), 0))

    nsrc = torch.arange(N, device=dev).repeat_interleave(N)[None].expand(B,
                                                                         NK)
    bump = torch.arange(N, dtype=torch.float32, device=dev)[None, None, :]

    def bookkeep(c):
        scores, h1, h2, hyp_len, last, tick = c
        cs = (scores[:, :, None] + bump).reshape(B, NK) - 0.01
        c_tok = ((nsrc + tick) % V).to(torch.int32)
        c_adv = c_tok != 0
        tk = c_tok.to(torch.int64) + 1
        src_h1 = torch.gather(h1, 1, nsrc)
        src_h2 = torch.gather(h2, 1, nsrc)
        src_len = torch.gather(hyp_len, 1, nsrc)
        n_h1 = torch.where(c_adv, (_mul_u32(src_h1, P1) + tk) & _M32, src_h1)
        n_h2 = torch.where(c_adv, (_mul_u32(src_h2, P2) + tk * P1) & _M32,
                           src_h2)
        n_len = src_len + c_adv.to(torch.int32)
        top_scores, top_pos = stable_top_k(cs, N)
        t_tok = torch.gather(c_tok, 1, top_pos)
        t_adv = torch.gather(c_adv, 1, top_pos)
        return (top_scores, torch.gather(n_h1, 1, top_pos),
                torch.gather(n_h2, 1, top_pos),
                torch.gather(n_len, 1, top_pos),
                torch.where(t_adv, t_tok, last), tick + 1)
    comps["bookkeep"] = (bookkeep, (
        torch.zeros(B, N, device=dev),
        torch.zeros(B, N, dtype=torch.int64, device=dev),
        torch.zeros(B, N, dtype=torch.int64, device=dev),
        torch.zeros(B, N, **i32), torch.zeros(B, N, **i32), 0))
    return comps


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--frames", type=int, default=750)
    p.add_argument("--vocab", type=int, default=5002)
    p.add_argument("--enc_dim", type=int, default=512)
    p.add_argument("--pred_dim", type=int, default=512)
    p.add_argument("--beam_size", type=int, default=8)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--platform", default=None,
                   help="the JAX CLI's platform switch: ignored (--device)")
    p.add_argument("--only", default=None,
                   help="comma list of component names to run (topk and "
                        "pallas_topk both run K5; approx_topk raises)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    comps = components(args.batch_size, args.frames, args.vocab,
                       args.enc_dim, args.pred_dim, args.beam_size, dev)
    names = args.only.split(",") if args.only else list(comps)
    results = {}
    with torch.no_grad():
        for name in names:
            body, carry0 = comps[name]
            wall, device = timed_loop(body, carry0, args.frames,
                                      args.warmup, args.iters, dev)
            results[name] = wall
            dev_s = "not measured (cpu)" if device is None \
                else f"{device:.4f}"
            print(f"{name:12s}: {wall:.4f} ms/frame wall, device {dev_s}")
    total = sum(v for k, v in results.items() if k not in _NOT_CORE)
    print(f"{'sum(core)':12s}: {total:.4f} ms/frame "
          "(noop/lax_topk/approx_topk excluded)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
