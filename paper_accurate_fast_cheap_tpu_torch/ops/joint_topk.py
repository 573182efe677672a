"""K2: transducer joint head + log-softmax + CTC fusion + exact top-k as a
hand-written CUDA kernel (``csrc/joint_topk.cu``).

Port of the TPU kernel ``ops/topk_pallas.py:_joint_topk_kernel`` (via
``joint_top_k_vocab_pallas``).  For a CUDA tensor
:func:`joint_top_k_vocab` launches the kernel or raises; for a CPU tensor it
runs :func:`joint_top_k_vocab_plain`: the f32 product, ``log_softmax``,
``logaddexp`` and ``ops/topk.top_k_vocab_plain`` (the JAX wrapper's own
fallback math, with the same selection and tie rules as the kernel).

In bf16 the kernel's product runs on the tensor cores (wgmma over TMA-fed
tiles; D a multiple of 8) and k <= 32 is selected one warp per row; larger
k goes through the block selection shared with K4 and K5
(``csrc/topk_select.cuh``), which takes any k whose row fits shared memory.
"""
from __future__ import annotations

import ctypes

import torch

from paper_accurate_fast_cheap_tpu_torch.ops import cuda_lib
from paper_accurate_fast_cheap_tpu_torch.ops.topk import (
    LANES, check_select, top_k_vocab_plain)

_ARGTYPES = ([ctypes.c_int] * 6 + [ctypes.c_void_p] * 4 + [ctypes.c_int]
             + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 5)


def _check_shapes(x, w, b, ctc, k):
    R, D = x.shape
    V = w.shape[0]
    B = ctc.shape[0]
    if w.shape != (V, D) or b.shape != (V,):
        raise ValueError(f"joint_top_k_vocab: w must be (V, {D}) and b (V,),"
                         f" got {tuple(w.shape)}, {tuple(b.shape)}")
    if B == 0 or R % B:
        raise ValueError(f"joint_top_k_vocab: {R} rows do not split into "
                         f"{B} ctc rows")
    if ctc.shape[1] < V:
        raise ValueError(f"joint_top_k_vocab: ctc has {ctc.shape[1]} "
                         f"columns < V={V}")
    check_select("joint_top_k_vocab", V, k)
    return R, D, V, B, R // B


def joint_top_k_vocab_plain(x, w, b, ctc, k: int, log_tw: float,
                            log_cw: float):
    """The kernel's plain PyTorch version (f32 throughout)."""
    R, D, V, B, n_rep = _check_shapes(x, w, b, ctc, k)
    logits = x.float() @ w.float().T + b.float()
    logp = torch.log_softmax(logits, dim=-1)
    fused = torch.logaddexp(
        log_tw + logp,
        log_cw + ctc[:, :V].float().repeat_interleave(n_rep, dim=0))
    return top_k_vocab_plain(fused.reshape(B, n_rep, V), k)


def joint_top_k_vocab(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                      ctc: torch.Tensor, k: int, log_tw: float,
                      log_cw: float):
    """Fused joint head + CTC shallow fusion + exact top-k.

    x: (B*N, D) pre-head joint activation; w: (V, D) and b: (V,), the
    ``ffn_out`` Linear; ctc: (B, >= V) CTC log-probs (extra columns, e.g.
    a -inf lane pad, are ignored; rows may be strided).  On the card all
    four share one dtype.
    Returns ((B, N, k) f32 values, (B, N, k) int32 vocab ids) of

        logaddexp(log_tw + log_softmax(x @ w.T + b), log_cw + ctc[row // N])
    """
    if x.device.type != "cuda":
        return joint_top_k_vocab_plain(x, w, b, ctc, k, log_tw, log_cw)
    R, D, V, B, n_rep = _check_shapes(x, w, b, ctc, k)
    cuda_lib.check_device("joint_top_k_vocab", x, w, b, ctc)
    if not x.dtype == w.dtype == b.dtype == ctc.dtype:
        raise ValueError(f"joint_top_k_vocab: x, w, b, ctc must share a "
                         f"dtype ({x.dtype}, {w.dtype}, {b.dtype}, "
                         f"{ctc.dtype})")
    if ctc.stride(1) != 1:
        raise ValueError("joint_top_k_vocab: ctc rows must be contiguous")
    code = cuda_lib.dtype_code(x.dtype)
    if x.dtype == torch.bfloat16 and D % 8:
        raise cuda_lib.KernelError(
            f"joint_top_k_vocab: the bf16 kernel's TMA loads need D a "
            f"multiple of 8, got {D}")
    x, w, b = cuda_lib.aligned16(x), cuda_lib.aligned16(w), b.contiguous()
    Vp = -(-V // LANES) * LANES
    # the product's f32 logits and, per 128-wide tile, (max, sum of exp)
    logits = torch.empty(R, Vp, device=x.device, dtype=torch.float32)
    part = torch.empty(R, Vp // LANES, 2, device=x.device,
                       dtype=torch.float32)
    vals = torch.empty(R, k, device=x.device, dtype=torch.float32)
    idx = torch.empty(R, k, device=x.device, dtype=torch.int32)
    fn = cuda_lib.entry("joint_topk", "pafc_joint_topk", _ARGTYPES)
    err = fn(code, R, D, V, n_rep, k, x.data_ptr(), w.data_ptr(),
             b.data_ptr(), ctc.data_ptr(), ctc.stride(0), float(log_tw),
             float(log_cw), logits.data_ptr(), part.data_ptr(),
             vals.data_ptr(), idx.data_ptr(), cuda_lib.stream_ptr(x.device))
    cuda_lib.check(err, "joint_topk")
    joint_top_k_vocab.launches += 1
    return vals.reshape(B, n_rep, k), idx.reshape(B, n_rep, k)


joint_top_k_vocab.launches = 0
