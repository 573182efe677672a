#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

Phases, each fatal on failure (no phase is skipped or caught):
  1. device report: the card's name and power limit (nvidia-smi);
  2. build: every kernel under paper_accurate_fast_cheap_tpu_torch/csrc/,
     one nvcc per source, all started together, with ptxas's registers and
     spills and the HGMMA (wgmma) count of the K6 and K7 libraries;
  3. each kernel against its plain PyTorch version on the card, at the
     shapes its paths give it, in float32 and bfloat16, with its time per
     call (eager, and on the device alone: calls replayed from a CUDA
     graph), the plain version's time, a library yardstick where one
     exists, and the least time the card could take (bound); K6 in all
     four activations and both dtypes at 5984, 71936 and 777 rows, and
     its gradient against autograd through its plain version; K7 at the
     crash-repro tool's shapes (2, 3, 1 and 8 buffers, and R = 256); the
     K6 and K7 wrappers' shape refusals; K1 under autograd at the training
     step's shape (its analytic backward is plain PyTorch), in f32 and in
     the step's bf16, y and gradients against the chunked WKV, with the
     backward's time;
  4. reference: a small f32 decode of the flagship (standard joint, under
     the beam's three top-k routes) and of its HAT twin, the card against
     the CPU;
  5. the main path at the flagship's full width: random weights from a
     seed, synthetic audio, fbank -> CMVN -> encoder -> CTC -> prefix beam
     (beam 8) -> finalize, with the kernels' launch counters checked;
  6. the recognize_wav CLI at full width, 32 x 90 s windows of one WAV, for
     the HAT and the standard flagship, with the counters, the TXT and the
     CTM checked;
  7. the crash-repro tool's five cases (tools/repro_tpu_worker_crash.py):
     pinned_bisect (K7), v7_encoder and pallas_lf (K1), sort_topk (K5) and
     pinned_outer_jit at 4 x 9000 frames (K1-K3), with the counters;
  8. the short-form recognize CLI on the paper's model (the flagship plus
     the bitransformer attention decoder) at full width: 64 utterances of
     2-15 s, batch 16, beam 8, bf16, each of the four modes with the
     counters; then the four modes in f32 on 2 utterances, the card's
     text files against the CPU's, byte for byte;
  9. training reference: one f32 step of the flagship and of the paper's
     config cut to 2 encoder and 1 + 1 decoder blocks (loss, gradient
     norm, parameters after one Adam step), the card against the CPU;
 10. training at full width: train_bench's main on the flagship, B16 x
     1500 frames x 40 labels, mixed precision, with the counters checked;
 11. the K6 path: the same step with the encoder's dropout at 0 and every
     feed-forward on impl "pallas", against the "xla" step, with K6's
     counter checked, both steps' times and profiled device-busy times
     in turns;
 12. the paper's training step: train_bench's main on
     examples/gigaspeech/conf/rwkvbi_ds4k31nc_12le_trans_shortform.yaml
     at the same shape, with the counters, and its profile;
then one JSON line with every kernel's numbers and, last, the result line.

Usage: python3 chip_smoke.py [--batch 32] [--kernels-only]
Exits non-zero without a result when no CUDA device is present.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import wave

import numpy as np

# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and the
# bf16 tensor-core rate.
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
# float32 outside the tensor cores (CUDA cores), same data sheet
PEAK_F32_FLOPS = 67e12
# The main path's window: 90 s of 16 kHz audio, 2248 encoder frames (the
# bench.py geometry).  Only the batch may be cut, never the window.
WINDOW_S = 90
# The CLI's windows: 8998 fbank frames (89.995 s), the same 2248 encoder
# frames after the conv2d /4 subsampling; 32 of them fill one batch.
CLI_CHUNK = 8998
CLI_FRAMES = ((CLI_CHUNK - 1) // 2 - 1) // 2
CLI_WINDOWS = 32


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


def device_ms(fn, launches: int = 20, replays: int = 5) -> float:
    """The kernel's device time per call, without the host: ``launches``
    calls captured in one CUDA graph, the graph replayed ``replays`` times
    between CUDA events.  The wrappers' counters count the captured calls
    (outside every counted path)."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * launches)
    del graph
    return ms


def phase_device() -> str:
    line = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(line)
    # configs other than JSON are read through PyYAML: the paper's YAML
    # (phases 8, 9 and 12) needs it
    log(f"PyYAML importable: {importlib.util.find_spec('yaml') is not None}")
    return line


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
                    if any(w in ln for w in ("registers", "spill", "arning",
                                             "entry function", "(C75")):
                        log(f"  ptxas {name}: {ln.strip()}")
    # the bf16 paths of K6 and K7 must reach the tensor cores: wgmma is
    # HGMMA in the SASS
    tool = os.path.join(os.path.dirname(cuda_lib._nvcc()), "cuobjdump")
    hgmma = {}
    if os.path.exists(tool):
        for name in ("ffn", "multi_product"):
            sass = subprocess.run([tool, "-sass", cuda_lib.lib_path(name)],
                                  capture_output=True, text=True).stdout
            hgmma[name] = sum("HGMMA" in ln for ln in sass.splitlines())
        log(f"HGMMA instructions (cuobjdump -sass): {json.dumps(hgmma)}")
    else:
        log("HGMMA instructions: not counted (no cuobjdump beside nvcc)")
    return all(n > 0 for n in hgmma.values())


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
    dev = device_ms(lambda: K.wkv6_cuda(rb, kb, vb, wb, u), 10)
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
    log(f"K1 wkv6 bf16 ({B}x{T}x{H}x{N}): kernel {ms:.4f} ms (device "
        f"{dev:.4f}), plain {plain_ms:.4f} ms, library n/a, bound "
        f"{bms:.4f} ms ({by})")
    out.update(name="wkv6_fwd", max_abs_err=err_b, ms=ms, device_ms=dev,
               plain_ms=plain_ms,
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
    dev = device_ms(
        lambda: K.joint_top_k_vocab(xb, wb, bb, ctc, N, log_tw, log_cw))
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
        f"ms (device {dev:.4f}), plain {plain_ms:.4f} ms, library "
        f"{lib_ms:.4f} ms, bound {bms:.4f} ms ({by})")
    return dict(name="joint_topk", max_abs_err=res[torch.bfloat16], ms=ms,
                device_ms=dev,
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
    dev = device_ms(lambda: K.lstm_predictor_step(*args))
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
    log(f"K3 lstm_step bf16 (R={R}, 2x{H}, O={O}): kernel {ms:.4f} ms "
        f"(device {dev:.4f}), plain {plain_ms:.4f} ms, library "
        f"{lib_ms:.4f} ms, bound {bms:.4f} ms ({by})")
    return dict(name="lstm_step", max_abs_err=errs[torch.bfloat16], ms=ms,
                device_ms=dev,
                plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=lib_ms,
                max_abs_err_f32=errs[torch.float32]), ok_all


def check_fused_topk(g):
    """K4 at one beam frame of the HAT flagship: R = 32 x beam 8 rows."""
    import torch

    from paper_accurate_fast_cheap_tpu_torch.ops import fused_topk as K

    B, N, V = 32, 8, 5002
    R = B * N
    log_tw, log_cw = float(np.log(0.7)), float(np.log(0.3))
    bias = torch.zeros(V, device="cuda")
    bias[0] += 2.5
    logp = torch.log_softmax(_randn((R, V), g, 2.0) + bias, -1)
    ctc_full = torch.log_softmax(_randn((B, 3, V), g, 2.0) + bias, -1)
    res, ok_all = {}, True
    # f32 and bf16 inputs: kernel and plain fuse the same (upcast) values
    # in f32; the gap is expf/log1pf against torch.logaddexp's rounding,
    # a few ulps of O(10) scores: values 1e-6 abs + 1e-6 rel.
    for dt in (torch.float32, torch.bfloat16):
        lp, ctc = logp.to(dt), ctc_full.to(dt)[:, 1]  # strided, as in the beam
        vk, ik = K.fused_top_k_vocab(lp, ctc, N, log_tw, log_cw)
        vp, ip = K.fused_top_k_vocab_plain(lp, ctc, N, log_tw, log_cw)
        fused = torch.logaddexp(
            log_tw + lp.float(),
            log_cw + ctc.float().repeat_interleave(N, 0)).reshape(B, N, V)
        verr, n_mis, ok = _topk_agree(vk, ik, vp, ip, fused, 1e-6)
        ok_all = ok_all and ok
        log(f"K4 fused_topk {str(dt)[6:]}: values max_abs_err {verr:.3e} "
            f"<= 1e-6 (+1e-6 rel), index mismatches {n_mis} (near-ties "
            f"only) {'ok' if ok else 'FAIL'}")
        res[dt] = verr
    # exact ties: duplicated logp blocks across chunk boundaries and a
    # uniform CTC row; indices must equal the plain version's exactly
    lt = logp.clone()
    lt[:, 400:420] = lt[:, 100:120]
    lt[:, 4300:4320] = lt[:, 100:120]
    ct = torch.full((B, V), -float(np.log(V)), device="cuda")
    vk, ik = K.fused_top_k_vocab(lt, ct, N, log_tw, log_cw)
    vp, ip = K.fused_top_k_vocab_plain(lt, ct, N, log_tw, log_cw)
    ties_ok = bool((ik == ip).all()) and bool(
        ((vk - vp).abs() <= 1e-6 + 1e-6 * vp.abs()).all())
    ok_all = ok_all and ties_ok
    log(f"K4 fused_topk ties: indices identical {'ok' if ties_ok else 'FAIL'}")
    lb, cb = logp.bfloat16(), ctc_full.bfloat16()[:, 1]
    ms = cuda_time_ms(lambda: K.fused_top_k_vocab(lb, cb, N, log_tw, log_cw),
                      50)
    dev = device_ms(lambda: K.fused_top_k_vocab(lb, cb, N, log_tw, log_cw))
    plain_ms = cuda_time_ms(
        lambda: K.fused_top_k_vocab_plain(lb, cb, N, log_tw, log_cw), 20)

    def library():  # yardstick only: logaddexp + beam repeat + torch.topk
        fused = torch.logaddexp(log_tw + lb.float(),
                                log_cw + cb.float().repeat_interleave(N, 0))
        return torch.topk(fused.reshape(B, N, V), N)

    lib_ms = cuda_time_ms(library, 50)
    # logp and the B CTC rows read once, R x k (value, index) written; ~6
    # f32 operations per score (two adds, max, |a-b|, exp, log1p)
    nbytes = (R * V + B * V) * 2 + R * N * 8
    bms, by = bound_ms(nbytes, 6 * R * V, PEAK_F32_FLOPS)
    log(f"K4 fused_topk bf16 (R={R}, V={V}, k={N}): kernel {ms:.4f} ms "
        f"(device {dev:.4f}), plain {plain_ms:.4f} ms, library "
        f"{lib_ms:.4f} ms, bound {bms:.4f} ms ({by})")
    return dict(name="fused_topk", max_abs_err=res[torch.bfloat16], ms=ms,
                device_ms=dev,
                plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=lib_ms,
                max_abs_err_f32=res[torch.float32]), ok_all


def check_topk(g):
    """K5 at one beam frame of the xla route: the (32, 8, 5002) fused
    scores, and the JAX kernel tests' tie patterns."""
    import torch

    from paper_accurate_fast_cheap_tpu_torch.ops import topk as K

    B, N, V = 32, 8, 5002
    x = torch.logaddexp(
        float(np.log(0.7)) + torch.log_softmax(_randn((B, N, V), g, 2.0), -1),
        float(np.log(0.3)) + torch.log_softmax(_randn((B, 1, V), g, 2.0), -1))
    rng = np.random.default_rng(0)
    ties = torch.from_numpy(
        rng.integers(-6, 6, size=(8, 8, 2048)).astype(np.float32)).cuda()
    dead = torch.from_numpy(
        rng.normal(size=(4, 4, 1664)).astype(np.float32)).cuda()
    dead[0, 1] = -float("inf")               # dead beam row
    dead[2, :, 700:] = -float("inf")         # masked vocab tail
    cases = [("scores f32", x, N), ("scores bf16", x.bfloat16(), N),
             ("integer ties", ties, 8), ("-inf rows/tails", dead, 6),
             ("direct V=600", x[..., :600].contiguous(), N)]
    ok_all, err = True, 0.0
    # no arithmetic: the kernel selects the plain version's very values,
    # so values and indices must be identical
    for name, xc, k in cases:
        vk, ik = K.top_k_vocab(xc, k)
        vp, ip = K.top_k_vocab_plain(xc, k)
        e = float((vk - vp.float()).abs().nan_to_num(0.0).max())
        ok = bool((ik == ip).all()) and bool(
            ((vk == vp.float()) | (vk.isinf() & vp.isinf())).all())
        err = max(err, e)
        ok_all = ok_all and ok
        log(f"K5 topk {name} {tuple(xc.shape)} k={k}: identical values and "
            f"indices {'ok' if ok else 'FAIL'}")
    ms = cuda_time_ms(lambda: K.top_k_vocab(x, N), 50)
    dev = device_ms(lambda: K.top_k_vocab(x, N))
    plain_ms = cuda_time_ms(lambda: K.top_k_vocab_plain(x, N), 20)
    lib_ms = cuda_time_ms(lambda: torch.topk(x, N), 50)
    R = B * N
    nbytes = R * V * 4 + R * N * 8
    bms, by = bound_ms(nbytes, R * V, PEAK_F32_FLOPS)
    log(f"K5 topk f32 (R={R}, V={V}, k={N}): kernel {ms:.4f} ms (device "
        f"{dev:.4f}), plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms, "
        f"bound {bms:.4f} ms ({by})")
    return dict(name="topk", max_abs_err=err, ms=ms, device_ms=dev,
                plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, library_ms=lib_ms), ok_all


def _refuses(what: str, fn, exc) -> bool:
    """One refusal of a kernel wrapper, raised before any launch."""
    try:
        fn()
    except exc as e:
        log(f"  refused as expected ({what}): {type(e).__name__}: {e}")
        return True
    log(f"  FAIL: {what} was not refused")
    return False


def check_multi_product(g):
    """K7 at the crash-repro tool's pinned_bisect shapes: x (4096, 512) bf16
    against 2 buffers of (512, 5120) (the defaults, the row's numbers), then
    3, 1 and 8 buffers, each set totalling the default 10 MB, and 2 buffers
    at R = 256 (one row tile), each within one bf16 ulp of the plain
    version; then the wrapper's refusals."""
    import torch

    from paper_accurate_fast_cheap_tpu_torch.ops import cuda_lib
    from paper_accurate_fast_cheap_tpu_torch.ops import multi_product as K
    from paper_accurate_fast_cheap_tpu_torch.tools.repro_tpu_worker_crash \
        import buffer_cols

    R, D = 4096, 512
    x = _randn((R, D), g).bfloat16()
    ok_all, row = True, None
    for nbuf, rows in ((2, R), (3, R), (1, R), (8, R), (2, 256)):
        H = buffer_cols(10.0, nbuf, D)
        ws = [_randn((D, H), g, 0.02).bfloat16() for _ in range(nbuf)]
        xr = x[:rows]
        yk, yp = K.multi_product(xr, ws), K.multi_product_plain(xr, ws)
        # both sum exact bf16 products in f32 (in different orders) and
        # round once: one bf16 ulp at the output's scale
        scale = float(yp.float().abs().max())
        ulp = 2.0 ** (np.floor(np.log2(scale)) - 7)
        err = float((yk.float() - yp.float()).abs().max())
        ok = (err <= ulp and yk.dtype == torch.bfloat16
              and tuple(yk.shape) == (rows, H)
              and bool(torch.isfinite(yk.float()).all()))
        ok_all = ok_all and ok
        ms = cuda_time_ms(lambda: K.multi_product(xr, ws), 20)
        dev = device_ms(lambda: K.multi_product(xr, ws))
        plain_ms = cuda_time_ms(lambda: K.multi_product_plain(xr, ws), 10)
        stacked = torch.stack(ws)
        # yardstick only: one cuBLAS GEMM over the stacked buffers
        lib_ms = cuda_time_ms(
            lambda: torch.einsum("rd,bdh->rh", xr, stacked), 20)
        bms, by = bound_ms((rows * D + nbuf * D * H + rows * H) * 2,
                           2 * rows * D * H * nbuf, PEAK_BF16_FLOPS)
        log(f"K7 multi_product bf16 ({rows}x{D} @ {nbuf}x{D}x{H}): "
            f"max_abs_err {err:.3e} <= one bf16 ulp {ulp:.3e} (scale "
            f"{scale:.3f}) {'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms "
            f"(device {dev:.4f}), plain {plain_ms:.4f} ms, library (einsum) "
            f"{lib_ms:.4f} ms, bound {bms:.4f} ms ({by})")
        if row is None:
            row = dict(name="multi_product", max_abs_err=err, ms=ms,
                       device_ms=dev, plain_ms=plain_ms, bound_ms=bms,
                       bound_by=by, library_ms=lib_ms)
    ok_all = _refuses("K7 with H = 1284, not a multiple of 8", lambda:
                      K.multi_product(x[:256], [_randn((D, 1284), g)
                                                .bfloat16()]),
                      cuda_lib.KernelError) and ok_all
    ok_all = _refuses("K7 with D = 500, not a multiple of 8", lambda:
                      K.multi_product(_randn((256, 500), g).bfloat16(),
                                      [_randn((500, 1280), g).bfloat16()]),
                      cuda_lib.KernelError) and ok_all
    return row, ok_all


def check_ffn(g):
    """K6 against ffn_plain in all four activations and both dtypes at the
    training step's FFN (16 x 374 rows; the step runs it in f32, since the
    encoder's activations stay f32 under bf16 weights), at the decode main
    path's FFN (32 x 2248 rows, bf16 there) and at a ragged 777 rows;
    fused_ffn's gradient against autograd through the plain version; the
    wrapper's refusals; then the times of both kernels."""
    import torch
    import torch.nn.functional as F

    from paper_accurate_fast_cheap_tpu_torch.ops import cuda_lib
    from paper_accurate_fast_cheap_tpu_torch.ops import ffn as K

    D, H = 512, 2048
    w1, b1 = _randn((H, D), g, D ** -0.5), _randn((H,), g, 0.1)
    w2, b2 = _randn((D, H), g, H ** -0.5), _randn((D,), g, 0.1)
    x_train = _randn((TRAIN_BATCH * TRAIN_ENC_FRAMES, D), g)
    x_dec = _randn((32 * 2248, D), g)
    x_rag = _randn((777, D), g)
    ok_all, errs = True, {}

    def agree(x, dt, act):
        # f32: the same f32 products summed in two orders over D = 512 and
        # H = 2048: 1e-5 of the output scale.  bf16: y rounded to bf16
        # (2^-8) in both, twice in the plain version (product, bias add),
        # and a flipped rounding of the bf16 hidden: 1e-2 of the scale.
        args = (x.to(dt), w1.to(dt), b1.to(dt), w2.to(dt), b2.to(dt), act)
        yk, yp = K.fused_ffn(*args).float(), K.ffn_plain(*args).float()
        scale = float(yp.abs().max())
        err = float((yk - yp).abs().max())
        lim = (1e-5 if dt == torch.float32 else 1e-2) * scale
        return err, lim, err <= lim and tuple(yk.shape) == tuple(x.shape)

    for x in (x_train, x_dec, x_rag):
        for act in K.ACTIVATIONS:
            for dt in (torch.float32, torch.bfloat16):
                err, lim, ok = agree(x, dt, act)
                ok_all = ok_all and ok
                errs[x.shape[0], act, dt] = err
                log(f"K6 ffn {act} {str(dt)[6:]} (R={x.shape[0]}): "
                    f"max_abs_err {err:.3e} <= {lim:.3e} "
                    f"{'ok' if ok else 'FAIL'}")

    # gradient: fused_ffn's backward recomputes through ffn_plain, so it
    # must equal autograd through ffn_plain up to the f32 forward's rounding
    # (which the backward does not use): 1e-5 of each gradient's scale
    leaves = [t.clone().requires_grad_() for t in (x_train, w1, b1, w2, b2)]
    gy = _randn((x_train.shape[0], D), g)
    gk = torch.autograd.grad((K.fused_ffn(*leaves) * gy).sum(), leaves)
    gp = torch.autograd.grad((K.ffn_plain(*leaves) * gy).sum(), leaves)
    gerr = max(float((a - b).abs().max()) / float(b.abs().max())
               for a, b in zip(gk, gp))
    gok = gerr <= 1e-5
    ok_all = ok_all and gok
    log(f"K6 fused_ffn gradient (x, W1, b1, W2, b2; f32, R="
        f"{x_train.shape[0]}) vs autograd through ffn_plain: max rel err "
        f"{gerr:.3e} <= 1e-5 {'ok' if gok else 'FAIL'}")

    x4 = x_rag[:64]
    ok_all = _refuses("K6 with D = 256", lambda: K.fused_ffn(
        x4[:, :256], w1[:, :256], b1, w2[:256], b2[:256]),
        cuda_lib.KernelError) and ok_all
    ok_all = _refuses("K6 with H = 2000, not a multiple of 256", lambda:
                      K.fused_ffn(x4, w1[:2000], b1[:2000],
                                  w2[:, :2000], b2),
                      cuda_lib.KernelError) and ok_all

    def times(x, dt):
        args = (x.to(dt), w1.to(dt), b1.to(dt), w2.to(dt), b2.to(dt))

        def library():  # yardstick only: two cuBLAS products
            return F.linear(F.silu(F.linear(args[0], args[1], args[2])),
                            args[3], args[4])

        ms = cuda_time_ms(lambda: K.fused_ffn(*args), 10)
        dev = device_ms(lambda: K.fused_ffn(*args), 10)
        plain_ms = cuda_time_ms(lambda: K.ffn_plain(*args), 10)
        lib_ms = cuda_time_ms(library, 10)
        R, size = x.shape[0], x.element_size()
        nbytes = (2 * R * D + 2 * D * H + H + D) * size
        bms, by = bound_ms(nbytes, 4 * R * D * H,
                           PEAK_F32_FLOPS if dt == torch.float32
                           else PEAK_BF16_FLOPS)
        log(f"K6 ffn {str(dt)[6:]} ({R}x{D}->{H}->{D}, swish): kernel "
            f"{ms:.4f} ms (device {dev:.4f}), plain {plain_ms:.4f} ms, "
            f"library {lib_ms:.4f} ms, bound {bms:.4f} ms ({by})")
        return ms, dev, plain_ms, lib_ms, bms, by

    times(x_dec, torch.bfloat16)
    ms, dev, plain_ms, lib_ms, bms, by = times(x_train, torch.float32)
    return dict(name="ffn", max_abs_err=errs[x_train.shape[0], "swish",
                                             torch.float32],
                ms=ms, device_ms=dev, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms), ok_all


def check_wkv_backward(g) -> bool:
    """K1 under autograd at the training step's WKV call: B16 x 374 x 8 x 64
    (1500 feature frames after the two valid stride-2 convolutions of
    Conv2dSubsampling4).  The forward launches K1, the backward is the
    analytic wkv6_backward (plain PyTorch).  In f32, with and without a
    state: y and the final state against wkv6_chunked, the gradients against
    autograd through wkv6_chunked.  In bf16 with no state, the form the
    mixed-precision step runs (r, k, v, w and u bf16): y and the gradients
    against the same plain version run in f32 on the same bf16 values.
    Then the backward's time per call."""
    import torch

    from paper_accurate_fast_cheap_tpu_torch.ops import wkv6 as P
    from paper_accurate_fast_cheap_tpu_torch.ops import wkv6_cuda as K

    B, T, H, N = TRAIN_BATCH, TRAIN_ENC_FRAMES, 8, 64
    r, k, v = (_randn((B, T, H, N), g, 0.5) for _ in range(3))
    w = _randn((B, T, H, N), g, 1.0, -2.0)    # reaches the decay clamp
    u = _randn((H, N), g, 0.5)
    s0 = _randn((B, H, N, N), g, 0.1)
    gy, gs = _randn((B, T, H, N), g), _randn((B, H, N, N), g)
    names = "r k v w u state".split()
    rel = lambda a, b: float((a.float() - b).abs().max() / b.abs().max())  # noqa: E731,E501
    ok_all = True
    for with_state in (False, True):
        base = (r, k, v, w, u) + ((s0,) if with_state else ())
        grads, outs = [], []
        for fn in (K.wkv6_cuda, P.wkv6_chunked):
            leaves = [t.clone().requires_grad_() for t in base]
            out = fn(*leaves[:5], state=leaves[5] if with_state else None,
                     return_state=with_state)
            out = out if with_state else (out,)
            loss = sum((o * c).sum() for o, c in zip(out, (gy, gs)))
            grads.append(torch.autograd.grad(loss, leaves))
            outs.append([o.detach() for o in out])
        # the forward as check_wkv holds it: 1e-4 of the output scale
        y_err = max(float((a - b).abs().max()) for a, b in zip(*outs))
        y_scale = float(outs[1][0].abs().max())
        # f32 sums over T in two orders (the analytic adjoint against
        # autograd of the chunked form); the decay gradient is a difference
        # of reverse cumulative sums: 1e-3 of each gradient's scale
        errs = [rel(a, b) for a, b in zip(*grads)]
        ok = max(errs) <= 1e-3 and y_err <= 1e-4 * y_scale
        ok_all = ok_all and ok
        log(f"K1 forward + backward {'with' if with_state else 'without'} "
            f"state (f32, {B}x{T}x{H}x{N}): y{', state' * with_state} "
            f"max_abs_err {y_err:.3e} <= {1e-4 * y_scale:.3e} [1e-4 x "
            "scale]; gradients vs autograd through wkv6_chunked, max rel "
            "err " + ", ".join(f"{n} {e:.2e}" for n, e in zip(names, errs))
            + f" <= 1e-3 {'ok' if ok else 'FAIL'}")
    # bf16, the step's form.  The plain side runs in f32 on the bf16 values
    # with the bf16 cotangent.  y: K1's f32 recurrence rounded to bf16, 1e-2
    # of the output scale (check_wkv's limit).  The backward takes its chunk
    # products in bf16 operands, as the JAX package's does, and returns bf16
    # gradients: r, k, v and u within 2e-2 of each gradient's scale (a few
    # bf16 roundings).  The decay gradient is a difference of reverse
    # cumulative sums over T of those rounded products, so its largest
    # elementwise error is a cancellation's, not a rounding's: it is held
    # in relative L2 norm instead, within 0.1.
    base = [t.bfloat16() for t in (r, k, v, w, u)]
    gyb = gy.bfloat16()
    leaves = [t.clone().requires_grad_() for t in base]
    y_k = K.wkv6_cuda(*leaves)
    g_k = torch.autograd.grad((y_k * gyb).sum(), leaves)
    leaves = [t.float().requires_grad_() for t in base]
    y_p = P.wkv6_chunked(*leaves)
    g_p = torch.autograd.grad((y_p * gyb.float()).sum(), leaves)
    y_err = float((y_k.detach().float() - y_p.detach()).abs().max())
    y_scale = float(y_p.detach().abs().max())
    errs = [rel(a, b) for a, b in zip(g_k, g_p)]
    dw_l2 = float((g_k[3].float() - g_p[3]).norm() / g_p[3].norm())
    finite = all(bool(torch.isfinite(t).all()) for t in g_k)
    ok = (y_err <= 1e-2 * y_scale and finite and dw_l2 <= 0.1
          and max(e for n, e in zip(names, errs) if n != "w") <= 2e-2
          and all(t.dtype == torch.bfloat16 for t in g_k))
    ok_all = ok_all and ok
    log(f"K1 forward + backward bf16 ({B}x{T}x{H}x{N}, no state) vs f32 "
        f"wkv6_chunked on the same values: y max_abs_err {y_err:.3e} <= "
        f"{1e-2 * y_scale:.3e} [1e-2 x scale]; gradients max rel err "
        + ", ".join(f"{n} {e:.2e}" for n, e in zip(names, errs))
        + f" (r, k, v, u <= 2e-2), w rel L2 {dw_l2:.2e} <= 0.1, finite "
        f"{finite} {'ok' if ok else 'FAIL'}")
    for dt in (torch.float32, torch.bfloat16):
        args = [t.to(dt) for t in (r, k, v, w, u)]
        ms = cuda_time_ms(lambda: P.wkv6_backward(*args, None, gy.to(dt),
                                                  None), 5)
        log(f"K1 backward (wkv6_backward, plain PyTorch, not a kernel) "
            f"{str(dt)[6:]} ({B}x{T}x{H}x{N}): {ms:.4f} ms per call")
    return ok_all


KERNELS = {
    "wkv6_fwd": ("paper_accurate_fast_cheap_tpu_torch/csrc/wkv6_fwd.cu",
                 "paper_accurate_fast_cheap_tpu/ops/wkv6_pallas.py:906"),
    "joint_topk": ("paper_accurate_fast_cheap_tpu_torch/csrc/joint_topk.cu",
                   "paper_accurate_fast_cheap_tpu/ops/topk_pallas.py:299"),
    "lstm_step": ("paper_accurate_fast_cheap_tpu_torch/csrc/lstm_step.cu",
                  "paper_accurate_fast_cheap_tpu/ops/lstm_pallas.py:117"),
    "fused_topk": ("paper_accurate_fast_cheap_tpu_torch/csrc/fused_topk.cu",
                   "paper_accurate_fast_cheap_tpu/ops/topk_pallas.py:187"),
    "topk": ("paper_accurate_fast_cheap_tpu_torch/csrc/topk.cu",
             "paper_accurate_fast_cheap_tpu/ops/topk_pallas.py:127"),
    "ffn": ("paper_accurate_fast_cheap_tpu_torch/csrc/ffn.cu",
            "paper_accurate_fast_cheap_tpu/ops/ffn_pallas.py:80"),
    "multi_product": (
        "paper_accurate_fast_cheap_tpu_torch/csrc/multi_product.cu",
        "paper_accurate_fast_cheap_tpu/tools/repro_tpu_worker_crash.py:247"),
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


# The HAT twin: the same encoder and predictor, the joint's HAT head.
HAT_CONFIG = dict(CONFIG, joint_conf={"join_dim": 640, "hat_joint": True})


def build_model(hat: bool = False):
    """The flagship (or its HAT twin) at full width, random weights from a
    seed, blank bias +2.5 on both output heads (a speech-like emission
    rate, as bench.py).  HAT's blank is a sigmoid, not one logit of a
    V-way softmax: the same blank share takes the logit 2.5 - log(V - 1)."""
    import torch

    from paper_accurate_fast_cheap_tpu_torch.models import factory

    t0 = time.perf_counter()
    model, _ = factory.init_model(
        HAT_CONFIG if hat else CONFIG, VOCAB, 80,
        generator=torch.Generator().manual_seed(2 if hat else 1))
    with torch.no_grad():
        if hat:
            model.joint.blank_pred.bias[0] += 2.5 - float(np.log(VOCAB - 1))
        else:
            model.joint.ffn_out.bias[0] += 2.5
        model.ctc.ctc_lo.bias[0] += 2.5
    n = sum(p.numel() for p in model.parameters())
    log(f"model: {'HAT' if hat else 'flagship'} transducer, {n / 1e6:.1f} M "
        f"parameters, built in {time.perf_counter() - t0:.1f} s")
    return model


def counters():
    """Every kernel wrapper, by kernel name."""
    from paper_accurate_fast_cheap_tpu_torch.ops import (
        ffn, fused_topk, joint_topk, lstm_step, multi_product, topk,
        wkv6_cuda)

    return {"wkv6_fwd": wkv6_cuda.wkv6_cuda,
            "joint_topk": joint_topk.joint_top_k_vocab,
            "lstm_step": lstm_step.lstm_predictor_step,
            "fused_topk": fused_topk.fused_top_k_vocab,
            "topk": topk.top_k_vocab,
            "ffn": ffn.fused_ffn,
            "multi_product": multi_product.multi_product}


def zero_counts() -> None:
    for fn in counters().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in counters().items()}


def beam(model, enc, elens, logp, topk_impl="auto"):
    """The device prefix beam (beam 8, CTC 0.3 / transducer 0.7), deferred:
    returns the carry."""
    from paper_accurate_fast_cheap_tpu_torch.decode import rnnt_search

    return rnnt_search.rnnt_beam_search(
        *rnnt_search.make_transducer_step_fns(model), enc, elens, logp,
        beam_size=BEAM, ctc_weight=0.3, transducer_weight=0.7,
        impl="device", defer=True, topk_impl=topk_impl)


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
    carry = beam(model, enc, elens, logp)
    mark()
    res = rnnt_search.finalize_device_beam(
        rnnt_search.pack_device_beam(carry), beam=BEAM)
    mark()
    if stages is not None:
        for name, a, b in zip(("fbank+cmvn", "encoder+ctc", "beam",
                               "finalize"), t, t[1:]):
            stages[name] = b - a
    return res, enc, logp, carry


def phase_reference(model, hat_model, rng):
    """Small input, f32: the card (kernels) against the CPU (plain versions,
    which the CPU tests hold to the JAX package), for the flagship under
    the beam's three top-k routes and for its HAT twin under ``auto`` (its
    only route, K4's).  Returns (ok, K5's launches in the card's ``xla``
    route)."""
    import copy

    import torch

    from paper_accurate_fast_cheap_tpu_torch.decode import rnnt_search
    from paper_accurate_fast_cheap_tpu_torch.frontend import pipeline
    from paper_accurate_fast_cheap_tpu_torch.models.rwkv import RWKVAttention

    B, S = 2, 3 * 16000
    wavs = (rng.randn(B, S) * 0.1).astype(np.float32)
    lens = np.asarray([S, S - 8000], np.int64)
    stats = _cmvn_stats(pipeline.make_feature_fn({}, None, device="cpu"),
                        torch.from_numpy(wavs), torch.from_numpy(lens))
    cases = (("standard", model, ("pallas_joint", "pallas", "xla")),
             ("HAT", hat_model, ("auto",)))
    out, ok, k5_launches = {}, True, 0
    for dev in ("cuda", "cpu"):
        fz = pipeline.make_feature_fn({}, stats, device=dev)
        for label, m, routes in cases:
            if dev == "cpu":
                m = copy.deepcopy(m).to("cpu")
            # the whole model in f32 (the flagship casts RWKV inputs to
            # bf16, whose rounding differs between the CPU and the card)
            for mod in m.modules():
                if isinstance(mod, RWKVAttention):
                    mod.do_bfloat16 = False
            feats, flens = fz(torch.from_numpy(wavs).to(dev),
                              torch.from_numpy(lens).to(dev))
            enc, elens = m.forward_encoder(feats, flens)
            logp = m.ctc_logprobs(enc)
            for route in routes:
                zero_counts()
                res = rnnt_search.finalize_device_beam(
                    beam(m, enc, elens, logp, route))
                counts = read_counts()
                if dev == "cuda" and route == "xla":
                    k5_launches = counts["topk"]
                if dev == "cuda":
                    log(f"reference {label} {route}: card counters "
                        f"{json.dumps(counts)}")
                out[dev, label, route] = (res, enc.float().cpu(),
                                          logp.float().cpu())
            for mod in m.modules():
                if isinstance(mod, RWKVAttention):
                    mod.do_bfloat16 = True
    for label, _, routes in cases:
        for route in routes:
            (rg, eg, lg), (rc, ec, lc) = (out["cuda", label, route],
                                          out["cpu", label, route])
            enc_err = float((eg - ec).abs().max())
            ctc_err = float((lg - lc).abs().max())
            same = all(a.tokens == b.tokens for a, b in zip(rg, rc))
            score_ok = all(np.allclose(a.nbest_scores[:1],
                                       b.nbest_scores[:1], rtol=1e-4)
                           for a, b in zip(rg, rc))
            # f32 on both sides: summation order only (cuBLAS/cuDNN without
            # TF32, the kernels' own sums): 1e-3 on O(1) encoder outputs
            # and log-probs
            good = (enc_err <= 1e-3 and ctc_err <= 1e-3 and same
                    and score_ok and any(r.tokens for r in rg))
            ok = ok and good
            log(f"reference {label} {route} (B={B}, 3 s, f32, card vs CPU "
                f"plain): encoder max_abs_err {enc_err:.3e}, ctc "
                f"{ctc_err:.3e} (<= 1e-3), tokens identical {same}, best "
                f"scores within 1e-4 rel {score_ok}, tokens per utterance "
                f"{[len(r.tokens) for r in rg]} {'ok' if good else 'FAIL'}")
    # pallas (K4) and xla (K5) fuse and select the same log-probs: the
    # same tokens, best scores within 1e-5 rel (logaddexp rounding)
    rp, rx = out["cuda", "standard", "pallas"][0], out["cuda", "standard",
                                                        "xla"][0]
    same = all(a.tokens == b.tokens for a, b in zip(rp, rx))
    close = all(np.allclose(a.nbest_scores[:1], b.nbest_scores[:1],
                            rtol=1e-5) for a, b in zip(rp, rx))
    ok = ok and same and close and k5_launches > 0
    log(f"reference pallas vs xla on the card: tokens identical {same}, best "
        f"scores within 1e-5 rel {close}, K5 launches {k5_launches} "
        f"{'ok' if same and close and k5_launches > 0 else 'FAIL'}")
    return ok, k5_launches


def _cmvn_stats(featurize, wavs, lens):
    """Global CMVN (mean, istd) from the features of the data itself."""
    f, _ = featurize(wavs, lens)
    return (f.mean(dim=(0, 1)).cpu().numpy(),
            (1.0 / f.std(dim=(0, 1))).cpu().numpy())


def phase_main(model, rng, batch):
    """The flagship window batch in bf16: one warm-up, one timed run."""
    import torch

    from paper_accurate_fast_cheap_tpu_torch.frontend import pipeline

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

    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    stages = {}
    res, enc, logp, carry = decode(model, featurize, wavs, lens, stages)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    frames = enc.shape[1]
    want = dict.fromkeys(counts, 0)
    want.update(wkv6_fwd=24, joint_topk=frames, lstm_step=frames + 1)
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
    ok = (counts == want and shape_ok and finite and ids_ok and ntok > 0
          and frames == CLI_FRAMES)
    return ok, counts


def write_cli_inputs(d: str, rng, models) -> dict:
    """A seeded 16 kHz 16-bit WAV of exactly CLI_WINDOWS windows, a
    whitespace symbol table of VOCAB pieces, global CMVN stats of the
    WAV's first windows, and per model its f32 state_dict and JSON
    config.  Returns the paths."""
    import torch

    from paper_accurate_fast_cheap_tpu_torch.frontend import pipeline

    n = (CLI_WINDOWS * CLI_CHUNK - 1) * 160 + 400
    pcm = np.clip(rng.randn(n) * 0.1 * 32768, -32768, 32767).astype(np.int16)
    paths = {"wav": os.path.join(d, "episode.wav"), "audio_s": n / 16000.0}
    with wave.open(paths["wav"], "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())
    units = os.path.join(d, "units.txt")
    with open(units, "w") as f:
        f.write("<blank> 0\n<unk> 1\n")
        for i in range(2, VOCAB - 1):
            f.write(f"{'▁w' if i % 3 == 0 else 'p'}{i} {i}\n")
        f.write(f"<sos/eos> {VOCAB - 1}\n")
    head = torch.from_numpy(pcm[: 4 * CLI_CHUNK * 160].astype(np.float32)
                            / 32768.0)[None]
    feats, _ = pipeline.make_feature_fn({}, None)(
        head, torch.tensor([head.shape[1]]))
    feats = feats[0].double()
    cmvn = os.path.join(d, "cmvn.json")
    with open(cmvn, "w") as f:
        json.dump({"mean_stat": feats.sum(0).tolist(),
                   "var_stat": (feats ** 2).sum(0).tolist(),
                   "frame_num": feats.shape[0]}, f)
    for name, (model, config) in models.items():
        paths[name + ".pt"] = os.path.join(d, f"{name}.pt")
        torch.save(model.state_dict(), paths[name + ".pt"])
        paths[name + ".json"] = os.path.join(d, f"{name}.json")
        with open(paths[name + ".json"], "w") as f:
            json.dump(dict(config, tokenizer="whitespace",
                           tokenizer_conf={"symbol_table_path": units},
                           cmvn="global_cmvn",
                           cmvn_conf={"cmvn_file": cmvn,
                                      "is_json_cmvn": True},
                           dataset_conf={"fbank_conf": {
                               "num_mel_bins": 80, "frame_shift": 10,
                               "frame_length": 25, "dither": 0.0}}), f)
    return paths


def check_ctm(path: str, name: str, audio_s: float):
    """Every line '<name> 1 <start> <dur> <word>' with start >= 0, dur >=
    0, start + dur within the audio (+0.01: both are rounded to 0.01 s),
    and starts non-decreasing (the windows are consecutive, so this holds
    across windows too).  Returns (ok, line count)."""
    with open(path) as f:
        lines = f.read().splitlines()
    ok, prev = bool(lines), 0.0
    for ln in lines:
        f = ln.split()
        if len(f) != 5 or f[0] != name or f[1] != "1":
            return False, len(lines)
        start, dur = float(f[2]), float(f[3])
        ok = (ok and start >= 0 and dur >= 0
              and start + dur <= audio_s + 0.01 and start >= prev)
        prev = start
    return ok, len(lines)


def phase_cli(paths, card: str):
    """The port's recognize_wav at full width: 32 x 90 s windows (one
    batch), beam 8, bf16, the HAT then the standard flagship, each with
    the counters set to 0 just before and read just after.  Returns (ok,
    counts of the HAT run)."""
    import torch

    from paper_accurate_fast_cheap_tpu_torch.bin import recognize_wav
    from paper_accurate_fast_cheap_tpu_torch.ops import ctc_utils

    # time the batched Viterbi alignment (CTM timing) inside the CLI: its
    # inputs are on the host already (the search results), so the
    # synchronise before it waits for nothing the CLI would not
    align = ctc_utils.force_align_batch_device
    align_s = []

    def timed_align(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = align(*a, **k)
        align_s.append(time.perf_counter() - t0)
        return r

    ok, hat_counts = True, None
    ctc_utils.force_align_batch_device = timed_align
    try:
        for name, route in (("hat", "fused_topk"),
                            ("standard", "joint_topk")):
            align_s.clear()
            good, counts = _cli_run(recognize_wav, paths, name, route, card,
                                    align_s)
            ok = ok and good
            if name == "hat":
                hat_counts = counts
    finally:
        ctc_utils.force_align_batch_device = align
    return ok, hat_counts


def _cli_run(recognize_wav, paths, name, route, card, align_s):
    """One CLI run, counters zeroed just before and read just after.
    Returns (ok, counts)."""
    import torch

    out = os.path.join(os.path.dirname(paths["wav"]), f"out_{name}")
    zero_counts()
    t0 = time.perf_counter()
    rc = recognize_wav.main([
        "--config", paths[name + ".json"],
        "--checkpoint", paths[name + ".pt"], "--wav", paths["wav"],
        "--output_dir", out, "--mode", "rnnt_beam_search",
        "--batch_size", str(CLI_WINDOWS), "--chunk_size",
        str(CLI_CHUNK), "--beam_size", str(BEAM), "--precision", "bf16"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    want = dict.fromkeys(counts, 0)
    want.update({"wkv6_fwd": 24, "lstm_step": CLI_FRAMES + 1,
                 route: CLI_FRAMES})
    with open(os.path.join(out, "episode.txt")) as f:
        words = f.read().split()
    ctm_ok, n_ctm = check_ctm(os.path.join(out, "episode.ctm"),
                              "episode", paths["audio_s"])
    good = rc == 0 and counts == want and len(words) > 0 and ctm_ok
    log(f"CLI {name}: recognize_wav.main {wall:.2f} s (model load "
        f"included), launch counters {json.dumps(counts)}, expected "
        f"{json.dumps(want)}; TXT {len(words)} words, CTM {n_ctm} lines "
        f"well formed {ctm_ok}; Viterbi alignment per batch "
        f"{[round(t, 4) for t in align_s]} s {'ok' if good else 'FAIL'}")
    with open(os.path.join(out, "episode.rtf")) as f:
        for ln in f.read().splitlines():
            log(f"CLI {name} .rtf [{card}]: {ln}")
    return good, counts


# The training geometry of bin/train_bench.py's defaults: 16 utterances of
# 1500 feature frames (15 s) with 40 labels, mixed precision, 2 warm-up and
# 5 timed steps.
TRAIN_BATCH, TRAIN_FRAMES, TRAIN_LABELS = 16, 1500, 40
# the encoder's frames: two valid 3x3 stride-2 convolutions
TRAIN_ENC_FRAMES = ((TRAIN_FRAMES - 1) // 2 - 1) // 2
TRAIN_WARMUP, TRAIN_ITERS = 2, 5


def _train_config(work: str, name: str, **encoder_overrides) -> str:
    """The flagship's train_bench config as a JSON file (Adam, global-norm
    clip 5, warmuplr: the JAX CLI's defaults)."""
    enc = dict(FLAGSHIP_ENCODER, **encoder_overrides)
    path = os.path.join(work, f"{name}.json")
    with open(path, "w") as f:
        json.dump(dict(CONFIG, encoder_conf=enc, vocab_size_for_bench=VOCAB),
                  f)
    return path


def _train_argv(config: str, out: str):
    return ["--config", config, "--batch_size", str(TRAIN_BATCH), "--frames",
            str(TRAIN_FRAMES), "--label_len", str(TRAIN_LABELS),
            "--mixed_precision", "--warmup", str(TRAIN_WARMUP), "--iters",
            str(TRAIN_ITERS), "--profile", "--output", out]


def _report(path: str) -> dict:
    with open(path) as f:
        lines = f.read().splitlines()
    for ln in lines:
        log(f"  {ln}")
    return {ln.split()[0]: ln.split(None, 1)[1] for ln in lines}


def phase_train_reference(config: dict, label: str) -> bool:
    """One f32 training step from the same weights, the card against the
    CPU: 2 utterances of 300 feature frames (and 260), 8 labels (and 5).
    Dropout off (the two devices draw different bits) and the RWKV's bf16
    cast off (it rounds differently on the two)."""
    import copy

    import torch

    from paper_accurate_fast_cheap_tpu_torch.models import factory
    from paper_accurate_fast_cheap_tpu_torch.models.rwkv import RWKVAttention
    from paper_accurate_fast_cheap_tpu_torch.train import schedulers
    from paper_accurate_fast_cheap_tpu_torch.train import train_step as ts

    g = torch.Generator().manual_seed(5)
    B, T, U = 2, 300, 8
    batch = (torch.randn(B, T, 80, generator=g), torch.tensor([T, T - 40]),
             torch.randint(1, VOCAB, (B, U), generator=g),
             torch.tensor([U, U - 3]))
    model, _ = factory.init_model(config, VOCAB, 80, device="cpu",
                                  generator=torch.Generator().manual_seed(3))
    for mod in model.modules():
        if isinstance(mod, RWKVAttention):
            mod.do_bfloat16 = False
    lr = 1e-3  # steadylr with warmup 1: the first step at the full rate
    out = {}
    for dev in ("cuda", "cpu"):
        m = copy.deepcopy(model).to(dev)
        opt = ts.make_optimizer("adam", schedulers.steady_lr(lr, 1),
                                grad_clip=5.0)

        def loss_fn(p, mb, seed, m=m):
            return torch.func.functional_call(m, p, mb)["loss"], {}

        params = {n: p.detach() for n, p in m.named_parameters()}
        state, loss, met = ts.make_train_step(loss_fn, opt)(
            ts.init_train_state(params, opt),
            tuple(x.to(dev) for x in batch), 0)
        delta = torch.cat([(state.params[n] - params[n]).flatten().cpu()
                           for n in params])
        out[dev] = (float(loss), float(met["grad_norm"]), delta)
        del m, state
    (lc, gc, dc), (lp, gp, dp) = out["cuda"], out["cpu"]
    # f32 on both sides, summation order only (no TF32): the loss and the
    # gradient norm within 1e-3 relative, the decode reference's class.
    # Adam's first update is lr * g / (|g| + eps) per element, so the
    # updates agree where |g| is above the rounding noise and may flip sign
    # where it is not: their difference within 1e-2 of their L2 norm.
    l_err, g_err = abs(lc - lp) / abs(lp), abs(gc - gp) / gp
    u_err = float((dc - dp).norm() / dp.norm())
    ok = (l_err <= 1e-3 and g_err <= 1e-3 and u_err <= 1e-2
          and np.isfinite(lc))
    log(f"training reference ({label}, f32, {B} x {T} frames, {U} labels, "
        f"card vs CPU): loss {lc:.4f} vs {lp:.4f} (rel {l_err:.2e} <= 1e-3), "
        f"grad norm {gc:.4f} vs {gp:.4f} (rel {g_err:.2e} <= 1e-3), "
        f"Adam update (lr {lr:.0e}) rel L2 {u_err:.2e} <= 1e-2 "
        f"{'ok' if ok else 'FAIL'}")
    return ok


def profile_train_step(bench) -> None:
    """Where a prepared train_bench step spends its time.  First the step's
    timeline split at the encoder's boundary by CUDA events (no profiler);
    then one step under torch.profiler: its wall time, the device's busy
    time (every kernel and copy), the device time of the forward's parts
    (ranges opened around the encoder, the predictor, the CTC head, the
    chunked joint gather and the RNN-T recursion) and of the backward's
    autograd nodes, and the kernels with the most device time."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from paper_accurate_fast_cheap_tpu_torch.models import transducer

    def ranged(mod, name):
        open_ = []
        pre = mod.register_forward_pre_hook(
            lambda *a: open_.append(record_function(name).__enter__()))
        post = mod.register_forward_hook(
            lambda *a: open_.pop().__exit__(None, None, None))
        return [pre, post]

    def ranged_fn(name, fn):
        def inner(*a, **k):
            with record_function(name):
                return fn(*a, **k)
        return inner

    m, rnnt = bench.model, transducer.rnnt
    # the step's timeline split at the encoder's boundary, by CUDA events
    # recorded where the encoder's forward ends and where its output's
    # gradient is ready (the loss head's backward done, the encoder's next)
    marks = {}

    def mark(name):
        marks[name] = torch.cuda.Event(enable_timing=True)
        marks[name].record()

    def at_encoder_output(mod, args, out):
        mark("encoder forward")
        out[0].register_hook(lambda g: mark("encoder output grad"))

    hook = m.encoder.register_forward_hook(at_encoder_output)
    try:
        for _ in range(2):  # the second step is read
            mark("start")
            bench.step_fn(bench.state, bench.batch, 3, mark=mark)
        torch.cuda.synchronize()
    finally:
        hook.remove()
    order = ("start", "encoder forward", "forward", "encoder output grad",
             "backward", "optimizer")
    names = ("encoder forward", "loss head forward (predictor, joint, "
             "RNN-T, CTC)", "loss head backward", "encoder backward",
             "clip + optimizer")
    split = [marks[a].elapsed_time(marks[b]) for a, b in zip(order,
                                                             order[1:])]
    log(f"training step split (CUDA events, {sum(split):.1f} ms): "
        + ", ".join(f"{n} {ms:.1f} ms" for n, ms in zip(names, split)))
    hooks = (ranged(m.encoder, "fwd encoder") + ranged(m.predictor,
                                                       "fwd predictor")
             + ranged(m.ctc, "fwd ctc head"))
    if m.decoder is not None:
        hooks += ranged(m.decoder, "fwd attention decoder")
    fns = {n: getattr(rnnt, n) for n in ("gather_rnnt_logprobs_chunked",
                                         "rnnt_forward")}
    for n, fn in fns.items():
        setattr(rnnt, n, ranged_fn(f"fwd {n}", fn))
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            bench.step_fn(bench.state, bench.batch, 3)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        for h in hooks:
            h.remove()
        for n, fn in fns.items():
            setattr(rnnt, n, fn)
    events = prof.events()
    kernels, parts, spans, nodes = (collections.Counter() for _ in range(4))
    for e in events:
        ms = e.device_time_total / 1e3
        if e.name.startswith("fwd "):
            # the range on the host (device time of its kernels) and its
            # copy on the device's timeline (the span it covers there)
            (spans if e.device_type == DeviceType.CUDA else parts)[
                e.name[4:]] += ms
        elif e.device_type == DeviceType.CUDA:
            kernels[e.name] += ms
        elif e.name.startswith("autograd::engine::evaluate_function: "):
            nodes[e.name.split(": ", 1)[1]] += ms
    busy = sum(kernels.values())
    log(f"training step profile (torch.profiler, one step): wall "
        f"{wall:.1f} ms (profiled), device busy {busy:.1f} ms "
        f"({100 * busy / wall:.1f}%), {len(kernels)}"
        " kernel names")
    log("  forward parts (device ms of their kernels / span on the device's "
        "timeline): " + ", ".join(f"{k} {v:.1f} / {spans[k]:.1f}"
                                  for k, v in parts.most_common()))
    log(f"  backward nodes (device ms, {sum(nodes.values()):.1f} in all): "
        + ", ".join(f"{k} {v:.1f}" for k, v in nodes.most_common(12)))
    log("  kernels (device ms): " + ", ".join(
        f"{k[:60]} {v:.1f}" for k, v in kernels.most_common(10)))


def phase_train(work: str):
    """train_bench's main on the flagship at full width, the counters set
    to 0 just before and read just after.  Returns (ok, counts)."""
    import torch

    from paper_accurate_fast_cheap_tpu_torch.bin import train_bench

    out = os.path.join(work, "train.bench")
    argv = _train_argv(_train_config(work, "flagship_train"), out)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    rc = train_bench.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    forwards = TRAIN_WARMUP + TRAIN_ITERS
    want = {n: 0 for n in counts}
    want["wkv6_fwd"] = 24 * forwards
    log(f"training (train_bench.main, flagship, B{TRAIN_BATCH} x "
        f"{TRAIN_FRAMES} frames x {TRAIN_LABELS} labels, mixed precision, "
        "impl xla): "
        f"{wall:.2f} s with the model build; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    rep = _report(out)
    loss = float(rep["final_loss"])
    ok = rc == 0 and counts == want and np.isfinite(loss)
    log(f"training counters {json.dumps(counts)}, expected "
        f"{json.dumps(want)} (24 per forward x {forwards}), loss finite "
        f"{np.isfinite(loss)} {'ok' if ok else 'FAIL'}")
    profile_train_step(train_bench.prepare(train_bench.get_args(argv)))
    return ok, counts


def _timed_step(bench, seed: int):
    """One warm-up step, one step timed on the host clock (to a
    synchronize) and one under torch.profiler: (step ms, device busy ms,
    device ms of K6's kernels)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    bench.step_fn(bench.state, bench.batch, seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bench.step_fn(bench.state, bench.batch, seed)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        bench.step_fn(bench.state, bench.batch, seed)
        torch.cuda.synchronize()
    busy = k6 = 0.0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            busy += e.device_time_total / 1e3
            if "ffn_f32_kernel" in e.name or "ffn_tc_kernel" in e.name:
                k6 += e.device_time_total / 1e3
    return ms, busy, k6


def phase_train_k6(work: str):
    """The same step with the encoder's dropout at 0 and every feed-forward
    on impl "pallas" (K6), against the impl "xla" step from the same state,
    batch and seed; then train_bench's timed run on the K6 path, the
    counters set to 0 just before and read just after.  Returns (ok,
    counts)."""
    import torch

    from paper_accurate_fast_cheap_tpu_torch.bin import train_bench
    from paper_accurate_fast_cheap_tpu_torch.models.convolution import (
        PositionwiseFeedForward)

    args = train_bench.get_args(_train_argv(
        _train_config(work, "flagship_train_k6", dropout_rate=0.0),
        os.path.join(work, "train_k6.bench")))
    bench = train_bench.prepare(args)
    ffns = [m for m in bench.model.modules()
            if isinstance(m, PositionwiseFeedForward)]

    def one_step(impl):
        for m in ffns:
            m.impl = impl
        zero_counts()
        _, loss, met = bench.step_fn(bench.state, bench.batch, 7)
        return float(loss), float(met["grad_norm"]), read_counts()["ffn"]

    lx, gx, nx = one_step("xla")
    lp, gp, np_ = one_step("pallas")
    # K6 computes the FFN in f32 here (f32 activations, bf16-valued
    # weights), as the xla path does, up to summation order; the outputs
    # then meet the RWKV's bf16 input cast, where a flipped rounding moves
    # an element by 2^-8: loss within 1e-3, gradient norm within 1e-2
    l_err, g_err = abs(lp - lx) / abs(lx), abs(gp - gx) / gx
    cmp_ok = (l_err <= 1e-3 and g_err <= 1e-2 and nx == 0
              and np_ == len(ffns) == 24)
    log(f"K6 path step vs xla step (same state, batch, seed 7): loss {lp:.4f}"
        f" vs {lx:.4f} (rel {l_err:.2e} <= 1e-3), grad norm {gp:.4f} vs "
        f"{gx:.4f} (rel {g_err:.2e} <= 1e-2), K6 launches {np_} (xla: {nx}) "
        f"of {len(ffns)} feed-forwards {'ok' if cmp_ok else 'FAIL'}")
    # the two steps' times in turns, xla, K6, K6, xla
    steps = {"xla": [], "pallas": []}
    for impl in ("xla", "pallas", "pallas", "xla"):
        for m in ffns:
            m.impl = impl
        steps[impl].append(_timed_step(bench, 7))
    for m in ffns:
        m.impl = "pallas"
    for impl, name in (("xla", "xla step"), ("pallas", "K6 path step")):
        log(f"{name} (B{TRAIN_BATCH} x {TRAIN_FRAMES} frames, two readings): "
            + "; ".join(f"{ms:.2f} ms, device busy {busy:.2f} ms "
                        f"(torch.profiler), K6 kernels {k6:.2f} ms"
                        for ms, busy, k6 in steps[impl]))
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    report = train_bench.run(bench, args)
    torch.cuda.synchronize()
    counts = read_counts()
    for ln in report.splitlines():
        log(f"  {ln}")
    forwards = TRAIN_WARMUP + TRAIN_ITERS
    want = {n: 0 for n in counts}
    want["wkv6_fwd"] = want["ffn"] = 24 * forwards
    ok = cmp_ok and counts == want
    log(f"K6 path training: peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; counters "
        f"{json.dumps(counts)}, expected {json.dumps(want)} "
        f"{'ok' if ok else 'FAIL'}")
    return ok, counts


# The paper's own configuration: the flagship transducer plus the
# bitransformer attention decoder (3 + 3 blocks), its optimizer, schedule and
# clip, read from the repo's YAML.
PAPER_YAML = "examples/gigaspeech/conf/rwkvbi_ds4k31nc_12le_trans_shortform.yaml"


# the paper's configuration cut to 2 encoder blocks and 1 + 1 decoder
# blocks at its full widths (the decoder-bearing training reference)
def _small_paper_config() -> dict:
    conf = paper_config()
    return dict(conf, encoder_conf=dict(conf["encoder_conf"], num_blocks=2),
                decoder_conf=dict(conf["decoder_conf"], num_blocks=1,
                                  r_num_blocks=1))


def paper_config() -> dict:
    from paper_accurate_fast_cheap_tpu_torch.utils.config import load_config

    return load_config(os.path.join(os.path.dirname(os.path.abspath(
        __file__)), PAPER_YAML))


def phase_tool():
    """The crash-repro tool's five cases on the card through the port
    (tools/repro_tpu_worker_crash.py), each with the counters set to 0 just
    before and read just after: pinned_bisect at its defaults with the
    product chain (K7), v7_encoder (K1 x 24), pallas_lf (K1), sort_topk (K5
    x 3000) and pinned_outer_jit at 4 x 9000 frames (the main path runs the
    full batch).  Returns (ok, K7's launches)."""
    import torch

    from paper_accurate_fast_cheap_tpu_torch.tools import (
        repro_tpu_worker_crash as tool)

    # the encoder frames of 9000 feature frames after the two valid
    # stride-2 convolutions
    frames = ((9000 - 1) // 2 - 1) // 2
    cases = (
        ("pinned_bisect", lambda: tool.case_pinned_bisect(device="cuda"),
         {"multi_product": 1}),
        ("v7_encoder", lambda: tool.case_v7_encoder(device="cuda"),
         {"wkv6_fwd": 24}),
        ("pallas_lf", lambda: tool.case_pallas_lf(device="cuda"),
         {"wkv6_fwd": 1}),
        ("sort_topk", lambda: tool.case_sort_topk(device="cuda"),
         {"topk": 3000}),
        ("pinned_outer_jit",
         lambda: tool.case_pinned_outer_jit(B=4, T=9000, device="cuda"),
         {"wkv6_fwd": 24, "joint_topk": frames, "lstm_step": frames + 1}),
    )
    ok, k7 = True, 0
    for name, run, nonzero in cases:
        zero_counts()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        want = {n: nonzero.get(n, 0) for n in counts}
        if name == "pinned_bisect":
            k7 = counts["multi_product"]
        if name == "pinned_outer_jit":
            expected = (all(np.isfinite(r.score) for r in out)
                        and len(out) == 4)
        elif name == "sort_topk":
            expected = (bool(np.isfinite(out[0]))
                        and out[1] == (3000, 64, 8, 8))
        elif name == "v7_encoder":
            # the program overflows by construction: 24 residual WKV layers
            # without a norm grow x cubically, NaN from the sixth layer on,
            # as the JAX tool's program does (the JAX package's chunked WKV
            # on the CPU); so the 24-layer output is NaN, and 2 layers,
            # still finite, agree with the plain version on the CPU
            expected = bool(np.isnan(out)) and _v7_two_layers_agree(tool)
        else:
            expected = bool(np.isfinite(out))
        good = counts == want and expected
        ok = ok and good
        log(f"tool {name}: {wall:.2f} s, launch counters "
            f"{json.dumps(counts)}, expected {json.dumps(want)}, output "
            f"{'NaN as the program gives' if name == 'v7_encoder' else 'finite'}"
            f" {expected} {'ok' if good else 'FAIL'}")
        torch.cuda.empty_cache()
    return ok, k7


def _v7_two_layers_agree(tool) -> bool:
    """The v7_encoder program cut to 2 layers (still finite), K1 on the
    card against the plain version on the CPU: x within 2e-2 of its
    largest entry (a bf16 residual stream: a flipped rounding moves an
    entry by 2^-8 of its size and the next layer amplifies it; on the CPU
    a change of the products' rounding order moved x by 3.6e-3)."""
    import torch

    card = tool.v7_stack(layers=2, device="cuda").float().cpu()
    cpu = tool.v7_stack(layers=2, device="cpu").float()
    scale = float(cpu.abs().max())
    err = float((card - cpu).abs().max())
    ok = bool(torch.isfinite(card).all()) and err <= 2e-2 * scale
    log(f"tool v7_encoder, 2 layers: card vs CPU max_abs_err {err:.3e} <= "
        f"2e-2 x {scale:.3f} {'ok' if ok else 'FAIL'}")
    return ok


# The short-form CLI's data: seeded GigaSpeech-like utterances of 2-15 s.
SF_UTTS, SF_BATCH = 64, 16
SF_MODES = ("ctc_greedy_search", "ctc_prefix_beam_search",
            "attention_rescoring", "rnnt_beam_search")


def _write_wav(path: str, pcm: np.ndarray) -> None:
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())


def write_sf_inputs(d: str, rng, model, config: dict) -> dict:
    """64 seeded 16 kHz WAVs of 2-15 s with random transcripts as a raw
    list, 2 short ones as a second list, a whitespace symbol table of VOCAB
    pieces (<sos/eos> at the config's id 2), global CMVN stats of the first
    WAVs, the model's f32 state_dict and two JSON configs (the paper's,
    bf16 RWKV cast included, and its twin without the cast for the f32
    card-vs-CPU check).  Returns the paths and the audio seconds."""
    import torch

    from paper_accurate_fast_cheap_tpu_torch.frontend import pipeline

    units = os.path.join(d, "units.txt")
    with open(units, "w") as f:
        f.write("<blank> 0\n<unk> 1\n<sos/eos> 2\n")
        for i in range(3, VOCAB):
            f.write(f"{'▁w' if i % 3 == 0 else 'p'}{i} {i}\n")
    words = [f"{'▁w' if i % 3 == 0 else 'p'}{i}" for i in range(3, VOCAB)]
    lists, audio_s, pcms = {}, {}, []
    for name, n, lo, hi in (("sf", SF_UTTS, 2.0, 15.0), ("ref", 2, 2.0, 3.0)):
        path = os.path.join(d, f"{name}.list")
        audio_s[name] = 0.0
        with open(path, "w") as f:
            for i in range(n):
                samples = int(rng.uniform(lo, hi) * 16000)
                pcm = np.clip(rng.randn(samples) * 0.1 * 32768, -32768,
                              32767).astype(np.int16)
                wav = os.path.join(d, f"{name}_{i:03d}.wav")
                _write_wav(wav, pcm)
                pcms.append(pcm)
                txt = " ".join(rng.choice(words, rng.randint(3, 13)))
                f.write(json.dumps({"key": f"{name}_{i:03d}", "wav": wav,
                                    "txt": txt}) + "\n")
                audio_s[name] += samples / 16000.0
        lists[name] = path
    head = torch.from_numpy(np.concatenate(pcms[:8]).astype(np.float32)
                            / 32768.0)[None]
    feats, _ = pipeline.make_feature_fn({}, None)(
        head, torch.tensor([head.shape[1]]))
    feats = feats[0].double()
    cmvn = os.path.join(d, "sf_cmvn.json")
    with open(cmvn, "w") as f:
        json.dump({"mean_stat": feats.sum(0).tolist(),
                   "var_stat": (feats ** 2).sum(0).tolist(),
                   "frame_num": feats.shape[0]}, f)
    ckpt = os.path.join(d, "paper.pt")
    torch.save(model.state_dict(), ckpt)
    paths = dict(lists, ckpt=ckpt, audio_s=audio_s)
    conf = dict(config, tokenizer="whitespace",
                tokenizer_conf=dict(config["tokenizer_conf"],
                                    symbol_table_path=units),
                cmvn_conf={"cmvn_file": cmvn, "is_json_cmvn": True})
    for name, cast in (("paper", True), ("paper_f32", False)):
        paths[name] = os.path.join(d, f"{name}.json")
        with open(paths[name], "w") as f:
            json.dump(dict(conf, encoder_conf=dict(
                config["encoder_conf"], rwkv_do_bfloat16=cast)), f)
    return paths


def _sf_argv(paths, config, data, out, modes, device, precision):
    return (["--config", paths[config], "--checkpoint", paths["ckpt"],
             "--data_type", "raw", "--test_data", paths[data],
             "--result_dir", out, "--batch_size", str(SF_BATCH),
             "--beam_size", str(BEAM), "--precision", precision,
             "--device", device, "--modes"] + list(modes))


def phase_recognize(work: str, rng):
    """The short-form recognize CLI at full width on the paper's model
    (random weights from a seed, blank bias +2.5 on the CTC and transducer
    heads): 64 utterances of 2-15 s, batch 16, beam 8, bf16, one run per
    mode with the counters set to 0 just before and read just after; then
    the four modes in f32 on 2 short utterances, the card against the CPU:
    the text files must be identical.  Returns (ok, counts of the
    rnnt_beam_search run)."""
    import torch

    from paper_accurate_fast_cheap_tpu_torch.bin import recognize
    from paper_accurate_fast_cheap_tpu_torch.models import factory

    config = paper_config()
    model, _ = factory.init_model(
        config, VOCAB, 80, device="cpu",
        generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        model.joint.ffn_out.bias[0] += 2.5
        model.ctc.ctc_lo.bias[0] += 2.5
    n = sum(p.numel() for p in model.parameters())
    log(f"model: the paper's transducer + bitransformer decoder, {n / 1e6:.1f}"
        " M parameters")
    paths = write_sf_inputs(work, rng, model, config)
    del model
    audio = paths["audio_s"]["sf"]
    batches = -(-SF_UTTS // SF_BATCH)
    ok, rnnt_counts = True, None
    for mode in SF_MODES:
        out = os.path.join(work, f"sf_{mode}")
        zero_counts()
        t0 = time.perf_counter()
        rc = recognize.main(_sf_argv(paths, "paper", "sf", out, [mode],
                                     "cuda", "bf16"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        with open(os.path.join(out, mode, "text"), encoding="utf-8") as f:
            lines = f.read().splitlines()
        keys = sorted(ln.split(" ", 1)[0] for ln in lines)
        ntok = sum(len(ln.split()) - 1 for ln in lines)
        want = {n: 0 for n in counts}
        want["wkv6_fwd"] = 24 * batches
        counts_ok = all(counts[k] == want[k] for k in counts
                        if k not in ("joint_topk", "lstm_step"))
        if mode == "rnnt_beam_search":
            # one K2 launch per frame of each batch, K3 once more per batch
            rnnt_counts = counts
            counts_ok = (counts_ok and counts["joint_topk"] > 0
                         and counts["lstm_step"]
                         == counts["joint_topk"] + batches)
        else:
            counts_ok = (counts_ok and counts["joint_topk"] == 0
                         == counts["lstm_step"])
        good = (rc == 0 and counts_ok and ntok > 0 and keys == [
            f"sf_{i:03d}" for i in range(SF_UTTS)])
        ok = ok and good
        log(f"recognize {mode}: {SF_UTTS} utterances, {audio:.1f} s audio, "
            f"batch {SF_BATCH}, beam {BEAM}, bf16: {wall:.2f} s (model load "
            f"included), 1/RTF {audio / wall:.1f}, {ntok} tokens, launch "
            f"counters {json.dumps(counts)} {'ok' if good else 'FAIL'}")
    outs = {}
    for dev in ("cuda", "cpu"):
        out = os.path.join(work, f"ref_{dev}")
        rc = recognize.main(_sf_argv(paths, "paper_f32", "ref", out,
                                     SF_MODES, dev, "fp32"))
        outs[dev] = {}
        for mode in SF_MODES:
            with open(os.path.join(out, mode, "text"), "rb") as f:
                outs[dev][mode] = f.read()
        ok = ok and rc == 0
    for mode in SF_MODES:
        same = outs["cuda"][mode] == outs["cpu"][mode]
        ok = ok and same and len(outs["cuda"][mode].splitlines()) == 2
        log(f"recognize {mode} (2 utterances, f32, card vs CPU): text files "
            f"identical {same}: {outs['cuda'][mode][:160]!r}")
    return ok, rnnt_counts


def phase_train_paper(work: str):
    """train_bench's main on the paper's YAML (the flagship plus the
    bitransformer decoder; Adam, steadylr and clip 0.1 from the config) at
    B16 x 1500 frames x 40 labels, mixed precision, the counters set to 0
    just before and read just after.  Returns (ok, counts)."""
    import torch

    from paper_accurate_fast_cheap_tpu_torch.bin import train_bench

    out = os.path.join(work, "train_paper.bench")
    argv = _train_argv(os.path.join(os.path.dirname(os.path.abspath(
        __file__)), PAPER_YAML), out)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    rc = train_bench.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    forwards = TRAIN_WARMUP + TRAIN_ITERS
    want = {n: 0 for n in counts}
    want["wkv6_fwd"] = 24 * forwards
    log(f"training, the paper's config (train_bench.main, {PAPER_YAML}, "
        f"B{TRAIN_BATCH} x {TRAIN_FRAMES} frames x {TRAIN_LABELS} labels, "
        f"mixed precision): {wall:.2f} s with the model build; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    rep = _report(out)
    vals = [float(rep[k]) for k in ("final_loss", "loss_att", "th_accuracy")]
    ok = rc == 0 and counts == want and all(np.isfinite(vals))
    log(f"paper training counters {json.dumps(counts)}, expected "
        f"{json.dumps(want)} (24 per forward x {forwards}), loss, loss_att "
        f"and th_accuracy finite {all(np.isfinite(vals))} "
        f"{'ok' if ok else 'FAIL'}")
    profile_train_step(train_bench.prepare(train_bench.get_args(argv)))
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

    t_start = time.perf_counter()
    card = phase_device()
    tensor_cores = phase_build()
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    rows, ok = [], True
    for check in (check_wkv, check_joint_topk, check_lstm, check_fused_topk,
                  check_topk, check_multi_product, check_ffn):
        row, good = check(g)
        torch.cuda.synchronize()
        rows.append(row)
        ok = ok and good
    failed = [] if ok else ["kernels vs plain"]
    if not tensor_cores:
        failed.append("no HGMMA in the bf16 K6/K7 libraries")
    if not check_wkv_backward(g):
        failed.append("K1 backward vs autograd")
    if args.kernels_only:
        log("chip_smoke --kernels-only: "
            + (f"FAILED: {', '.join(failed)}" if failed else "every check ok"))
        return 1 if failed else 0

    rng = np.random.RandomState(0)
    model, hat_model = build_model(), build_model(hat=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        # the checkpoints are saved in f32, before the main path casts
        paths = write_cli_inputs(work, rng, {"standard": (model, CONFIG),
                                             "hat": (hat_model, HAT_CONFIG)})
        ref_ok, k5_launches = phase_reference(model, hat_model, rng)
        if not ref_ok:
            failed.append("card vs CPU reference")
        hat_model = hat_model.cpu()
        if args.batch != 32:
            log(f"main path cut: batch {args.batch} (flagship point: 32 x "
                f"{WINDOW_S} s)")
        ok, counts = phase_main(model, rng, args.batch)
        if not ok:
            failed.append("main path")
        del model
        torch.cuda.empty_cache()
        cli_ok, hat_counts = phase_cli(paths, card)
        if not cli_ok:
            failed.append("recognize_wav CLI")
        tool_ok, k7_launches = phase_tool()
        if not tool_ok:
            failed.append("crash-repro tool cases")
        sf_ok, sf_counts = phase_recognize(work, rng)
        if not sf_ok:
            failed.append("short-form recognize CLI")
        if not phase_train_reference(CONFIG, "flagship"):
            failed.append("training reference")
        if not phase_train_reference(_small_paper_config(),
                                     "paper config, 2 encoder and 1 + 1 "
                                     "decoder blocks"):
            failed.append("training reference, attention decoder")
        train_ok, train_counts = phase_train(work)
        if not train_ok:
            failed.append("training")
        k6_ok, k6_counts = phase_train_k6(work)
        if not k6_ok:
            failed.append("K6 path")
        paper_ok, paper_counts = phase_train_paper(work)
        if not paper_ok:
            failed.append("training, the paper's config")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if failed:
        log(f"chip_smoke: FAILED: {', '.join(failed)}")
        return 1
    main_path = f"main path ({args.batch} x {WINDOW_S} s, bf16)"
    launches = {name: (counts[name], main_path)
                for name in ("wkv6_fwd", "joint_topk", "lstm_step")}
    launches["fused_topk"] = (hat_counts["fused_topk"],
                              f"recognize_wav CLI, HAT flagship "
                              f"({CLI_WINDOWS} x 90 s, bf16)")
    launches["topk"] = (k5_launches, "reference, xla route (2 x 3 s, f32)")
    launches["ffn"] = (k6_counts["ffn"],
                       f"train_bench K6 path ({TRAIN_WARMUP + TRAIN_ITERS} "
                       f"steps, B{TRAIN_BATCH} x {TRAIN_FRAMES} frames, "
                       "mixed precision, encoder dropout 0, impl pallas)")
    launches["multi_product"] = (
        k7_launches, "crash-repro tool, pinned_bisect (defaults: 4096 x 512 "
        "@ 2 x 512 x 5120 bf16, with the product chain)")
    log(f"K1 launches in training: {train_counts['wkv6_fwd']} (flagship), "
        f"{paper_counts['wkv6_fwd']} (the paper's config) "
        f"({TRAIN_WARMUP + TRAIN_ITERS} steps x 24 per forward); short-form "
        f"recognize, rnnt_beam_search: {json.dumps(sf_counts)}")
    log(f"chip_smoke: every phase ok in {time.perf_counter() - t_start:.1f} "
        "s")
    for row in rows:
        src, rep = KERNELS[row["name"]]
        n, path = launches[row["name"]]
        row.update(route="cuda", source=src, replaces=rep, launches=n,
                   launches_path=path)
    keys = ("name", "route", "source", "replaces", "launches",
            "launches_path", "max_abs_err", "ms", "device_ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: row[k] for k in keys}
                                  for row in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
