"""K7: the multi-buffer product as a hand-written CUDA kernel
(``csrc/multi_product.cu``).

Port of the TPU kernel of the crash-repro tool (``tools/
repro_tpu_worker_crash.py``, ``pinned_call`` and its body ``kernel``):
y = sum_i x @ W_i over a few (D, H) weight buffers, accumulated in f32 and
rounded to bf16 once.  The TPU kernel's grid covers x in whole 256-row
tiles, so both versions here refuse a row count that is not a multiple of
256.  Its VMEM pinning is a TPU workaround and is not ported.

The kernel runs wgmma on the tensor cores over TMA-fed tiles: a
persistent block per SM walks 128 x 256 tiles of y, each with one K loop
over (buffer, k tile), each buffer read in place through its own tensor
map (MN-major B, never stacked or copied).  TMA needs 16-byte row
strides, so the kernel also takes D and H multiples of 8 only
(:func:`check_kernel_shape`, a KernelError otherwise).

:func:`multi_product` launches the kernel for CUDA tensors (or raises) and
runs :func:`multi_product_plain` for CPU tensors.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from paper_accurate_fast_cheap_tpu_torch.ops import cuda_lib

ROW_TILE = 256      # the TPU kernel's row block
MAX_BUFFERS = 8     # the tensor maps a launch carries

_ARGTYPES = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4


def _check(x: torch.Tensor, ws: Sequence[torch.Tensor]):
    if not 1 <= len(ws) <= MAX_BUFFERS:
        raise ValueError(f"multi_product: 1 to {MAX_BUFFERS} weight buffers, "
                         f"got {len(ws)}")
    if x.dim() != 2:
        raise ValueError(f"multi_product: x must be (R, D), got "
                         f"{tuple(x.shape)}")
    R, D = x.shape
    H = ws[0].shape[-1]
    for w in ws:
        if tuple(w.shape) != (D, H):
            raise ValueError(f"multi_product: every buffer must be ({D}, "
                             f"{H}), got {tuple(w.shape)}")
    if R % ROW_TILE:
        raise ValueError(f"multi_product: R = {R} rows is not a multiple of "
                         f"the {ROW_TILE}-row tile")
    return R, D, H


def check_kernel_shape(D: int, H: int) -> None:
    """Raise a KernelError unless the kernel's TMA loads take (D, H): both
    multiples of 8 (16-byte bf16 rows)."""
    if D % 8 or H % 8:
        raise cuda_lib.KernelError(
            f"multi_product: the CUDA kernel takes D and H multiples of 8 "
            f"(16-byte rows for TMA), got D = {D}, H = {H}")


def multi_product_plain(x: torch.Tensor,
                        ws: Sequence[torch.Tensor]) -> torch.Tensor:
    """The plain formula: the f32 products summed, then cast to bf16."""
    _check(x, ws)
    acc = x.float() @ ws[0].float()
    for w in ws[1:]:
        acc = acc + x.float() @ w.float()
    return acc.to(torch.bfloat16)


def multi_product(x: torch.Tensor, ws: Sequence[torch.Tensor]) -> torch.Tensor:
    """sum_i x @ ws[i] for x (R, D) and each ws[i] (D, H), bf16, with R a
    multiple of 256; returns (R, H) bf16."""
    ws = list(ws)
    if x.device.type != "cuda":
        return multi_product_plain(x, ws)
    R, D, H = _check(x, ws)
    check_kernel_shape(D, H)
    cuda_lib.check_device("multi_product", x, *ws)
    for t in (x, *ws):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"multi_product: bf16 tensors only, got "
                             f"{t.dtype}")
    x = cuda_lib.aligned16(x)
    ws = [cuda_lib.aligned16(w) for w in ws]
    ptrs = (ctypes.c_void_p * len(ws))(*(w.data_ptr() for w in ws))
    y = torch.empty(R, H, device=x.device, dtype=torch.bfloat16)
    fn = cuda_lib.entry("multi_product", "pafc_multi_product", _ARGTYPES)
    err = fn(R, D, H, len(ws), x.data_ptr(), ptrs, y.data_ptr(),
             cuda_lib.stream_ptr(x.device))
    cuda_lib.check(err, f"multi_product (R {R}, D {D}, H {H}, "
                        f"{len(ws)} buffers)")
    multi_product.launches += 1
    return y


multi_product.launches = 0
