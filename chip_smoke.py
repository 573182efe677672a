#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

Phases, each fatal on failure (no phase is skipped or caught):
  1. device report: the card's name and power limit (nvidia-smi);
  2. build: every kernel under paper_accurate_fast_cheap_tpu_torch/csrc/,
     one nvcc per source, all started together;
  3. each kernel against its plain PyTorch version on the card, at the
     shapes the main path gives it, in float32 and bfloat16, with its time,
     the plain version's time, a library yardstick where one exists, and
     the least time the card could take (bound);
  4. the main path at the flagship's full width: random weights from a
     seed, synthetic audio, fbank -> CMVN -> encoder -> CTC -> prefix beam
     (beam 8) -> finalize, with the kernels' launch counters checked;
then one JSON line with every kernel's numbers and, last, the result line.

Usage: python3 chip_smoke.py [--batch 32] [--kernels-only]
Exits non-zero without a result when no CUDA device is present.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and the
# bf16 tensor-core rate.
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
# The main path's window: 90 s of 16 kHz audio, 2248 encoder frames (the
# bench.py geometry).  Only the batch may be cut, never the window.
WINDOW_S = 90


def log(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(nbytes: float, flops: float, flop_rate: float):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device():
    line = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(line)


def phase_build():
    from paper_accurate_fast_cheap_tpu_torch.ops import cuda_lib

    t0 = time.perf_counter()
    times = cuda_lib.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s wall, per source "
        + json.dumps({k: round(v, 2) for k, v in times.items()}))
    for name in cuda_lib.SOURCES:
        path = os.path.join(cuda_lib.BUILD_DIR, f"{name}.log")
        if os.path.exists(path):
            with open(path) as f:
                for ln in f:
                    if "registers" in ln or "spill" in ln:
                        log(f"  ptxas {name}: {ln.strip()}")


def _randn(shape, g, scale=1.0, shift=0.0):
    import torch

    return torch.randn(shape, generator=g, device="cuda") * scale + shift


def check_wkv(g):
    """K1 at one encoder WKV call of the flagship window batch."""
    import torch

    from paper_accurate_fast_cheap_tpu_torch.ops import wkv6_cuda as K

    B, T, H, N = 32, 2250, 8, 64
    r, k, v = (_randn((B, T, H, N), g, 0.5) for _ in range(3))
    w = _randn((B, T, H, N), g, 1.0, -2.0)    # reaches the decay clamp
    u = _randn((H, N), g, 0.5)
    s0 = _randn((B, H, N, N), g, 0.1)
    out = {}
    # f32: the kernel's sequential sums against the chunked form's blocked
    # ones; both exact in exact arithmetic, so the gap is f32 rounding over
    # T=2250 steps: 1e-4 of the output scale.
    y_k, s_k = K.wkv6_cuda(r, k, v, w, u, state=s0, return_state=True)
    y_p, s_p = K.wkv6_chunked(r, k, v, w, u, state=s0, return_state=True)
    scale = float(y_p.abs().max())
    err = max(float((y_k - y_p).abs().max()), float((s_k - s_p).abs().max()))
    ok32 = err <= 1e-4 * scale
    # bf16 in/out: the same f32 recurrence on identical bf16 inputs, held to
    # the plain version run in f32; the gap is the rounding of y to bf16
    # (2^-8 relative): 1e-2 of the output scale.
    rb, kb, vb, wb = (x.bfloat16() for x in (r, k, v, w))
    y_kb = K.wkv6_cuda(rb, kb, vb, wb, u)
    y_pb = K.wkv6_chunked(*(x.float() for x in (rb, kb, vb, wb)), u)
    scale_b = float(y_pb.abs().max())
    err_b = float((y_kb.float() - y_pb).abs().max())
    okb = err_b <= 1e-2 * scale_b
    log(f"K1 wkv6 f32: max_abs_err {err:.3e} (state incl.) <= "
        f"{1e-4 * scale:.3e} [1e-4 x scale] {'ok' if ok32 else 'FAIL'}; "
        f"bf16: {err_b:.3e} <= {1e-2 * scale_b:.3e} [1e-2 x scale] "
        f"{'ok' if okb else 'FAIL'}")
    ms = cuda_time_ms(lambda: K.wkv6_cuda(rb, kb, vb, wb, u), 10)
    plain_ms = cuda_time_ms(
        lambda: K.wkv6_chunked(rb, kb, vb, wb, u), 3, warmup=1)
    # Bound: r, k, v, w read and y written once in bf16.  The operations
    # are the recurrence's 4N^2 + 3N per step, at the tensor-core rate: the
    # TPU kernel and the chunked plain version compute the same y as
    # blocked products on the matrix units, so the sequential walk's
    # CUDA-core FMAs are this kernel's cost, not the function's.
    nbytes = 5 * B * T * H * N * 2 + H * N * 4
    flops = B * T * H * (4 * N * N + 3 * N)
    bms, by = bound_ms(nbytes, flops, PEAK_BF16_FLOPS)
    log(f"K1 wkv6 bf16 ({B}x{T}x{H}x{N}): kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, library n/a, bound {bms:.4f} ms ({by})")
    out.update(name="wkv6_fwd", max_abs_err=err_b, ms=ms, plain_ms=plain_ms,
               bound_ms=bms, bound_by=by, library_ms=None,
               max_abs_err_f32=err)
    return out, ok32 and okb


def _topk_agree(vals_k, idx_k, vals_p, idx_p, fused, tol):
    """Values within tol; an index may differ only where the plain scores
    of the two candidates are within tol (a near-tie swapped by rounding)."""
    import torch

    verr = float((vals_k - vals_p).abs().max())
    lim = tol + tol * vals_p.abs()
    ok = bool(((vals_k - vals_p).abs() <= lim).all())
    mism = idx_k != idx_p
    n_mis = int(mism.sum())
    if n_mis:
        at_k = torch.gather(fused, -1, idx_k.long())
        ok = ok and bool(((at_k - vals_p).abs() <= lim)[mism].all())
    return verr, n_mis, ok


def check_joint_topk(g):
    """K2 at one beam frame of the flagship: R = 32 x beam 8 rows."""
    import torch

    from paper_accurate_fast_cheap_tpu_torch.ops import joint_topk as K

    B, N, D, V, Vp = 32, 8, 640, 5002, 5120
    R = B * N
    log_tw, log_cw = float(np.log(0.7)), float(np.log(0.3))
    x = torch.tanh(_randn((R, D), g))
    w = _randn((V, D), g, D ** -0.5)
    b = torch.zeros(V, device="cuda")
    b[0] += 2.5
    ctc_full = torch.full((B, 3, Vp), -float("inf"), device="cuda")
    ctc_full[:, :, :V] = torch.log_softmax(_randn((B, 3, V), g, 2.0), -1)
    res, ok_all = {}, True
    # f32 and bf16 inputs: both paths take the product, the logsumexp and
    # the fusion in f32 on identical inputs, so the gap is summation order
    # (D=640 products, V=5002 exponentials): values 1e-5 abs + 1e-5 rel.
    for dt in (torch.float32, torch.bfloat16):
        xd, wd, bd = x.to(dt), w.to(dt), b.to(dt)
        ctc = ctc_full.to(dt)[:, 1]               # strided, as in the beam
        vk, ik = K.joint_top_k_vocab(xd, wd, bd, ctc, N, log_tw, log_cw)
        vp, ip = K.joint_top_k_vocab_plain(xd, wd, bd, ctc, N, log_tw, log_cw)
        logp = torch.log_softmax(xd.float() @ wd.float().T + bd.float(), -1)
        fused = torch.logaddexp(
            log_tw + logp, log_cw + ctc[:, :V].float().repeat_interleave(N, 0))
        verr, n_mis, ok = _topk_agree(vk, ik, vp, ip,
                                      fused.reshape(B, N, V), 1e-5)
        ok_all = ok_all and ok
        log(f"K2 joint_topk {str(dt)[6:]}: values max_abs_err {verr:.3e} "
            f"<= 1e-5 (+1e-5 rel), index mismatches {n_mis} (near-ties "
            f"only) {'ok' if ok else 'FAIL'}")
        res[dt] = verr
    xb, wb, bb = x.bfloat16(), w.bfloat16(), b.bfloat16()
    ctc = ctc_full.bfloat16()[:, 1]
    ms = cuda_time_ms(
        lambda: K.joint_top_k_vocab(xb, wb, bb, ctc, N, log_tw, log_cw), 50)
    plain_ms = cuda_time_ms(
        lambda: K.joint_top_k_vocab_plain(xb, wb, bb, ctc, N, log_tw,
                                          log_cw), 20)

    def library():  # yardstick only: cuBLAS product + softmax + topk
        logp = torch.log_softmax((xb @ wb.T + bb).float(), -1)
        fused = torch.logaddexp(
            log_tw + logp, log_cw + ctc[:, :V].float().repeat_interleave(N, 0))
        return torch.topk(fused.reshape(B, N, V), N)

    lib_ms = cuda_time_ms(library, 50)
    nbytes = (R * D + V * D + V + B * V) * 2 + R * N * 8
    flops = 2 * R * D * V
    bms, by = bound_ms(nbytes, flops, PEAK_BF16_FLOPS)
    log(f"K2 joint_topk bf16 (R={R}, D={D}, V={V}, k={N}): kernel {ms:.4f} "
        f"ms, plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound "
        f"{bms:.4f} ms ({by})")
    return dict(name="joint_topk", max_abs_err=res[torch.bfloat16], ms=ms,
                plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=lib_ms,
                max_abs_err_f32=res[torch.float32]), ok_all


def check_lstm(g):
    """K3 at one predictor step of the flagship beam: 2 x 640 LSTM."""
    import torch

    from paper_accurate_fast_cheap_tpu_torch.ops import lstm_step as K

    R, E, H, O, L = 256, 640, 640, 640, 2
    x = _randn((R, E), g, E ** -0.5)
    hs = torch.tanh(_randn((L, R, H), g))
    cs = _randn((L, R, H), g)
    layers = [(_randn((4 * H, E if i == 0 else H), g, H ** -0.5),
               _randn((4 * H,), g, 0.1), _randn((4 * H, H), g, H ** -0.5))
              for i in range(L)]
    wp, bp = _randn((O, H), g, H ** -0.5), _randn((O,), g, 0.1)
    ok_all, errs = True, {}
    for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        # f32: identical f32 arithmetic up to summation order over
        # K = E + H = 1280: 1e-5 abs on O(1) outputs.  bf16: the next
        # layer's input and `out` are rounded to bf16 (2^-8 relative), so
        # a rounding-order flip moves one ulp: 1e-2 of the output scale.
        cast = [(a.to(dt), b_.to(dt), c.to(dt)) for a, b_, c in layers]
        args = (x.to(dt), hs, cs, cast, wp.to(dt), bp.to(dt))
        ko = K.lstm_predictor_step(*args)
        po = K.lstm_step_plain(*args)
        err = max(float((a.float() - b_.float()).abs().max())
                  for a, b_ in zip(ko, po))
        scale = max(float(b_.float().abs().max()) for b_ in po)
        lim = tol if dt == torch.float32 else tol * scale
        ok = err <= lim
        ok_all = ok_all and ok
        errs[dt] = err
        log(f"K3 lstm_step {str(dt)[6:]}: max_abs_err {err:.3e} <= "
            f"{lim:.3e} {'ok' if ok else 'FAIL'}")
    cast = [(a.bfloat16(), b_.bfloat16(), c.bfloat16()) for a, b_, c in layers]
    args = (x.bfloat16(), hs, cs, cast, wp.bfloat16(), bp.bfloat16())
    ms = cuda_time_ms(lambda: K.lstm_predictor_step(*args), 50)
    plain_ms = cuda_time_ms(lambda: K.lstm_step_plain(*args), 50)
    flat = []
    for a, b_, c in cast:
        flat += [a, c, b_, torch.zeros_like(b_)]
    h0, c0 = hs.bfloat16(), cs.bfloat16()

    def library():  # yardstick only: cuDNN LSTM step + projection
        y, _, _ = torch._VF.lstm(args[0][None], (h0, c0), flat, True, L, 0.0,
                                 False, False, False)
        return torch.nn.functional.linear(y[0], args[4], args[5])

    lib_ms = cuda_time_ms(library, 50)
    wbytes = sum(4 * H * ((E if i == 0 else H) + H + 1) for i in range(L))
    nbytes = (wbytes + O * H + O + R * E + R * O) * 2 + 4 * L * R * H * 4
    flops = 2 * R * (sum(4 * H * ((E if i == 0 else H) + H)
                         for i in range(L)) + H * O)
    bms, by = bound_ms(nbytes, flops, PEAK_BF16_FLOPS)
    log(f"K3 lstm_step bf16 (R={R}, 2x{H}, O={O}): kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound "
        f"{bms:.4f} ms ({by})")
    return dict(name="lstm_step", max_abs_err=errs[torch.bfloat16], ms=ms,
                plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=lib_ms,
                max_abs_err_f32=errs[torch.float32]), ok_all


KERNELS = {
    "wkv6_fwd": ("paper_accurate_fast_cheap_tpu_torch/csrc/wkv6_fwd.cu",
                 "paper_accurate_fast_cheap_tpu/ops/wkv6_pallas.py:906"),
    "joint_topk": ("paper_accurate_fast_cheap_tpu_torch/csrc/joint_topk.cu",
                   "paper_accurate_fast_cheap_tpu/ops/topk_pallas.py:299"),
    "lstm_step": ("paper_accurate_fast_cheap_tpu_torch/csrc/lstm_step.cu",
                  "paper_accurate_fast_cheap_tpu/ops/lstm_pallas.py:117"),
}


# The flagship model (the JAX package's __graft_entry__.FLAGSHIP_ENCODER and
# the transducer head of bench.py), copied: this script imports no JAX.
FLAGSHIP_ENCODER = dict(
    output_size=512, attention_heads=8, linear_units=2048, num_blocks=12,
    selfattention_layer_type="rwkv_tmix60_bidirectional", dropout_rate=0.1,
    positional_dropout_rate=0.1, attention_dropout_rate=0.0,
    pos_enc_layer_type="rel_pos", cnn_module_kernel=31,
    cnn_module_norm="layer_norm")
VOCAB = 5002
BEAM = 8
CONFIG = {
    "model": "transducer",
    "encoder": "conformer",
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


def build_model():
    """The flagship at full width, random weights from a seed, blank bias
    +2.5 on both output heads (a speech-like emission rate, as bench.py)."""
    import torch

    from paper_accurate_fast_cheap_tpu_torch.models import factory

    t0 = time.perf_counter()
    model, _ = factory.init_model(CONFIG, VOCAB, 80,
                                  generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        model.joint.ffn_out.bias[0] += 2.5
        model.ctc.ctc_lo.bias[0] += 2.5
    n = sum(p.numel() for p in model.parameters())
    log(f"model: flagship transducer, {n / 1e6:.1f} M parameters, built in "
        f"{time.perf_counter() - t0:.1f} s")
    return model


def decode(model, featurize, wavs, lens, stages=None):
    """The main path through the port's entry points: fbank + CMVN ->
    encoder -> CTC -> device prefix beam -> packed finalize.  With a dict
    ``stages``, the device is synchronised after each stage and its wall
    seconds recorded there."""
    import torch

    from paper_accurate_fast_cheap_tpu_torch.decode import rnnt_search

    t = [time.perf_counter()]

    def mark():
        if stages is not None:
            torch.cuda.synchronize()
            t.append(time.perf_counter())

    feats, flens = featurize(wavs, lens)
    feats = feats.to(next(model.parameters()).dtype)
    mark()
    enc, elens = model.forward_encoder(feats, flens)
    logp = model.ctc_logprobs(enc)
    mark()
    carry = rnnt_search.rnnt_beam_search(
        *rnnt_search.make_transducer_step_fns(model), enc, elens, logp,
        beam_size=BEAM, ctc_weight=0.3, transducer_weight=0.7,
        impl="device", defer=True)
    mark()
    res = rnnt_search.finalize_device_beam(
        rnnt_search.pack_device_beam(carry), beam=BEAM)
    mark()
    if stages is not None:
        for name, a, b in zip(("fbank+cmvn", "encoder+ctc", "beam",
                               "finalize"), t, t[1:]):
            stages[name] = b - a
    return res, enc, logp, carry


def phase_reference(model, rng):
    """Small input, f32: the card (kernels) against the CPU (plain versions,
    which the CPU tests hold to the JAX package)."""
    import copy

    import torch

    from paper_accurate_fast_cheap_tpu_torch.frontend import pipeline
    from paper_accurate_fast_cheap_tpu_torch.models.rwkv import RWKVAttention

    B, S = 2, 3 * 16000
    wavs = (rng.randn(B, S) * 0.1).astype(np.float32)
    lens = np.asarray([S, S - 8000], np.int64)
    stats = _cmvn_stats(pipeline.make_feature_fn({}, None, device="cpu"),
                        torch.from_numpy(wavs), torch.from_numpy(lens))
    cpu = copy.deepcopy(model).to("cpu")
    # the whole model in f32 (the flagship casts RWKV inputs to bf16, whose
    # rounding differs between the CPU and the card)
    for m in list(model.modules()) + list(cpu.modules()):
        if isinstance(m, RWKVAttention):
            m.do_bfloat16 = False
    out = {}
    for name, m, dev in (("cuda", model, "cuda"), ("cpu", cpu, "cpu")):
        fz = pipeline.make_feature_fn({}, stats, device=dev)
        res, enc, logp, _ = decode(m, fz, torch.from_numpy(wavs).to(dev),
                                   torch.from_numpy(lens).to(dev))
        out[name] = (res, enc.float().cpu(), logp.float().cpu())
    (rg, eg, lg), (rc, ec, lc) = out["cuda"], out["cpu"]
    enc_err = float((eg - ec).abs().max())
    ctc_err = float((lg - lc).abs().max())
    same = all(a.tokens == b.tokens for a, b in zip(rg, rc))
    score_ok = all(np.allclose(a.nbest_scores[:1], b.nbest_scores[:1],
                               rtol=1e-4) for a, b in zip(rg, rc))
    # f32 on both sides: summation order only (cuBLAS/cuDNN without TF32,
    # the kernels' own sums): 1e-3 on O(1) encoder outputs and log-probs
    ok = enc_err <= 1e-3 and ctc_err <= 1e-3 and same and score_ok
    log(f"reference (B={B}, 3 s, f32, card vs CPU plain): encoder "
        f"max_abs_err {enc_err:.3e}, ctc {ctc_err:.3e} (<= 1e-3), tokens "
        f"identical {same}, best scores within 1e-4 rel {score_ok}, "
        f"tokens {[r.tokens for r in rg]} {'ok' if ok else 'FAIL'}")
    for m in model.modules():
        if isinstance(m, RWKVAttention):
            m.do_bfloat16 = True
    return ok


def _cmvn_stats(featurize, wavs, lens):
    """Global CMVN (mean, istd) from the features of the data itself."""
    f, _ = featurize(wavs, lens)
    return (f.mean(dim=(0, 1)).cpu().numpy(),
            (1.0 / f.std(dim=(0, 1))).cpu().numpy())


def phase_main(model, rng, batch):
    """The flagship window batch in bf16: one warm-up, one timed run."""
    import torch

    from paper_accurate_fast_cheap_tpu_torch.frontend import pipeline
    from paper_accurate_fast_cheap_tpu_torch.ops import (
        joint_topk, lstm_step, wkv6_cuda)

    S = WINDOW_S * 16000
    wavs = torch.from_numpy((rng.randn(batch, S) * 0.1).astype(np.float32))
    wavs = wavs.cuda()
    lens = torch.full((batch,), S, dtype=torch.int64, device="cuda")
    featurize = pipeline.make_feature_fn({}, _cmvn_stats(
        pipeline.make_feature_fn({}, None), wavs[:4], lens[:4]))
    model = model.to(torch.bfloat16)

    t0 = time.perf_counter()
    decode(model, featurize, wavs, lens)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    for fn in (wkv6_cuda.wkv6_cuda, joint_topk.joint_top_k_vocab,
               lstm_step.lstm_predictor_step):
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    stages = {}
    res, enc, logp, carry = decode(model, featurize, wavs, lens, stages)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"wkv6_fwd": wkv6_cuda.wkv6_cuda.launches,
              "joint_topk": joint_topk.joint_top_k_vocab.launches,
              "lstm_step": lstm_step.lstm_predictor_step.launches}
    frames = enc.shape[1]
    want = {"wkv6_fwd": 24, "joint_topk": frames, "lstm_step": frames + 1}
    audio_s = batch * WINDOW_S
    ntok = float(np.mean([len(r.tokens) for r in res]))
    hyps = carry["hyps"]
    shape_ok = (tuple(enc.shape) == (batch, frames, 512)
                and tuple(logp.shape) == (batch, frames, VOCAB)
                and tuple(hyps.shape) == (batch, BEAM, frames))
    finite = bool(torch.isfinite(enc.float()).all()
                  and torch.isfinite(logp.float()).all()
                  and all(np.isfinite(r.score) for r in res))
    ids_ok = all(0 < t < VOCAB for r in res for t in r.tokens)
    log(f"main path: {batch} windows x {WINDOW_S} s = {audio_s} s audio, "
        f"{frames} encoder frames, beam {BEAM}, bf16; warm-up "
        f"{warm_s:.2f} s, timed {wall:.3f} s, 1/RTF {audio_s / wall:.1f}, "
        f"mean tokens/window {ntok:.1f}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log("stages (s, synchronised): " + json.dumps(
        {k: round(v, 4) for k, v in stages.items()})
        + f"; beam per frame {stages['beam'] / frames * 1e3:.4f} ms")
    log(f"launch counters {json.dumps(counts)}, expected {json.dumps(want)}; "
        f"shapes {shape_ok}, finite {finite}, token ids in range {ids_ok}")
    ok = counts == want and shape_ok and finite and ids_ok and ntok > 0
    return ok, counts


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after phase 3 (no result line)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_device()
    phase_build()
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    rows, ok = [], True
    for check in (check_wkv, check_joint_topk, check_lstm):
        row, good = check(g)
        torch.cuda.synchronize()
        rows.append(row)
        ok = ok and good
    failed = [] if ok else ["kernels vs plain"]
    if args.kernels_only:
        return 1 if failed else 0

    rng = np.random.RandomState(0)
    model = build_model()
    if not phase_reference(model, rng):
        failed.append("card vs CPU reference")
    if args.batch != 32:
        log(f"main path cut: batch {args.batch} (flagship point: 32 x "
            f"{WINDOW_S} s)")
    ok, counts = phase_main(model, rng, args.batch)
    if not ok:
        failed.append("main path")
    if failed:
        log(f"chip_smoke: FAILED: {', '.join(failed)}")
        return 1
    for row in rows:
        src, rep = KERNELS[row["name"]]
        row.update(route="cuda", source=src, replaces=rep,
                   launches=counts[row["name"]])
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: row[k] for k in keys}
                                  for row in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
