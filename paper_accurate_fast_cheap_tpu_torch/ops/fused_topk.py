"""K4: CTC shallow fusion + exact top-k over precomputed log-probs as a
hand-written CUDA kernel (``csrc/fused_topk.cu``).

Port of the TPU kernel ``ops/topk_pallas.py:_fused_topk_kernel`` (via
``fused_top_k_vocab_pallas``), which the device beam runs when the joint
has no split form (the HAT joint).  For a CUDA tensor
:func:`fused_top_k_vocab` launches the kernel or raises; for a CPU tensor it
runs :func:`fused_top_k_vocab_plain`, the JAX wrapper's own fallback math:
f32 ``logaddexp``, then ``ops/topk.top_k_vocab_plain``.
"""
from __future__ import annotations

import ctypes

import torch

from paper_accurate_fast_cheap_tpu_torch.ops import cuda_lib
from paper_accurate_fast_cheap_tpu_torch.ops.topk import (
    check_select, filter_smem_bytes, top_k_vocab_plain)

_ARGTYPES = ([ctypes.c_int] * 5 + [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_void_p, ctypes.c_int]
             + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 3)


def _check_shapes(logp, ctc, k):
    R, V = logp.shape
    B = ctc.shape[0]
    if B == 0 or R % B:
        raise ValueError(f"fused_top_k_vocab: {R} rows do not split into "
                         f"{B} ctc rows")
    if ctc.shape[1] < V:
        raise ValueError(f"fused_top_k_vocab: ctc has {ctc.shape[1]} "
                         f"columns < V={V}")
    if not 0 < k <= V:
        raise ValueError(f"fused_top_k_vocab: k={k} outside 1..V={V}")
    return R, V, B, R // B


def fused_top_k_vocab_plain(logp, ctc, k: int, log_tw: float,
                            log_cw: float):
    """The kernel's plain PyTorch version (f32 fusion)."""
    R, V, B, n_rep = _check_shapes(logp, ctc, k)
    fused = torch.logaddexp(
        log_tw + logp.float(),
        log_cw + ctc[:, :V].float().repeat_interleave(n_rep, dim=0))
    return top_k_vocab_plain(fused.reshape(B, n_rep, V), k)


def fused_top_k_vocab(logp: torch.Tensor, ctc: torch.Tensor, k: int,
                      log_tw: float, log_cw: float):
    """CTC shallow fusion + exact top-k.

    logp: (B*N, V) transducer log-probs, one row per beam; ctc: (B, >= V)
    CTC log-probs, one row per utterance (extra columns are ignored; rows
    of either may be strided).  On the card both share one dtype, f32 or
    bf16.  Returns ((B, N, k) f32 values, (B, N, k) int32 vocab ids) of

        logaddexp(log_tw + logp, log_cw + ctc[row // N])

    with the selection and tie rules of ``ops/topk.top_k_vocab_plain``.
    """
    if logp.device.type != "cuda":
        return fused_top_k_vocab_plain(logp, ctc, k, log_tw, log_cw)
    R, V, B, n_rep = _check_shapes(logp, ctc, k)
    check_select("fused_top_k_vocab", V, k, filter_smem_bytes)
    cuda_lib.check_device("fused_top_k_vocab", logp, ctc)
    if logp.dtype != ctc.dtype:
        raise ValueError(f"fused_top_k_vocab: logp and ctc must share a "
                         f"dtype ({logp.dtype}, {ctc.dtype})")
    code = cuda_lib.dtype_code(logp.dtype)
    if logp.stride(1) != 1:
        logp = logp.contiguous()
    if ctc.stride(1) != 1:
        ctc = ctc.contiguous()
    vals = torch.empty(R, k, device=logp.device, dtype=torch.float32)
    idx = torch.empty(R, k, device=logp.device, dtype=torch.int32)
    fn = cuda_lib.entry("fused_topk", "pafc_fused_topk", _ARGTYPES)
    err = fn(code, R, V, n_rep, k, logp.data_ptr(), logp.stride(0),
             ctc.data_ptr(), ctc.stride(0), float(log_tw), float(log_cw),
             vals.data_ptr(), idx.data_ptr(),
             cuda_lib.stream_ptr(logp.device))
    cuda_lib.check(err, "fused_topk")
    fused_top_k_vocab.launches += 1
    return vals.reshape(B, n_rep, k), idx.reshape(B, n_rep, k)


fused_top_k_vocab.launches = 0
