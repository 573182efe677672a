"""K1: the WKV6 forward as a hand-written CUDA kernel (``csrc/wkv6_fwd.cu``).

Port of the TPU kernel ``ops/wkv6_pallas.py`` (``_kernel_v5`` via the
two-pass path, and the generations that compute the same y): the blocked
form of ``wkv6_chunked`` (chunks of 64 steps, inner blocks of 16) on the
tensor cores, one CUDA block per (batch, head) carrying the f32 state on
chip; head sizes 16, 32, 64 and 128, float32 or bfloat16.  For a CUDA
tensor :func:`wkv6_cuda` launches the kernel or raises; for a CPU tensor it
runs the plain version, ``ops/wkv6.wkv6_chunked`` (same recurrence, same
decay clamp).

:func:`wkv6_cuda` is differentiable: its backward is the analytic
``ops/wkv6.wkv6_backward`` (chunk 256, inner 16), plain PyTorch products as
the JAX package's XLA backward, from the saved inputs alone.  The launch
counter counts forward launches only.

The forward is the registered operator ``pafc_torch::wkv6_fwd``
(``torch.library.custom_op``): its CUDA kernel is K1's launch, its CPU
kernel the plain version and its fake kernel gives the shapes, so
``torch.export`` records K1 as one node of the graph
(``tools/export_model.py``).  Importing this module registers it.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from paper_accurate_fast_cheap_tpu_torch.ops import cuda_lib
from paper_accurate_fast_cheap_tpu_torch.ops.wkv6 import (
    wkv6_backward, wkv6_chunked)

# the inner-block overflow guard of the chunked/TPU forms (S = 16)
W_CLAMP = float(np.log(160.0 / 18.0))

_ARGTYPES = ([ctypes.c_int] * 5 + [ctypes.c_void_p] * 8
             + [ctypes.c_float, ctypes.c_void_p])


def wkv6_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor,
              state: Optional[torch.Tensor] = None,
              return_state: bool = False):
    """WKV6 forward.  r, k, v, w: (B, T, H, N) float32 or bfloat16, one
    dtype; u: (H, N); state: optional (B, H, N, N) f32.  Returns y (B, T, H,
    N) in r's dtype, and the final f32 state when ``return_state``.
    Differentiable in every tensor argument."""
    out = _WKV6.apply(r, k, v, w, u, state, return_state)
    return out if return_state else out[0]


class _WKV6(torch.autograd.Function):
    """Forward: K1 (or the plain version on the CPU).  Backward: the
    analytic ``wkv6_backward`` from the saved primal inputs."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state, return_state):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, w, u, state)
        out = _forward(r, k, v, w, u, state, return_state)
        return out if return_state else (out,)

    @staticmethod
    def backward(ctx, gy, gstate=None):
        r, k, v, w, u, state = ctx.saved_tensors
        if gy is None:
            gy = torch.zeros_like(r)
        grads = wkv6_backward(r, k, v, w, u, state, gy, gstate,
                              chunk_size=256, inner_size=16)
        return (*grads, None)


def _forward(r, k, v, w, u, state, return_state):
    y, s_out = torch.ops.pafc_torch.wkv6_fwd(r, k, v, w, u, state,
                                             return_state)
    return (y, s_out) if return_state else y


def _no_state(r):
    return r.new_empty((0,), dtype=torch.float32)


@torch.library.custom_op("pafc_torch::wkv6_fwd", mutates_args=(),
                         device_types="cpu")
def wkv6_fwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor,
             state: Optional[torch.Tensor],
             return_state: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's operator: (y, the final f32 state, or an empty tensor unless
    ``return_state``).  On the CPU: the plain version, ``wkv6_chunked``."""
    out = wkv6_chunked(r, k, v, w, u, state=state,
                       return_state=return_state)
    return out if return_state else (out, _no_state(r))


@wkv6_fwd.register_fake
def _wkv6_fwd_fake(r, k, v, w, u, state, return_state):
    B, _, H, N = r.shape
    return (torch.empty_like(r),
            r.new_empty((B, H, N, N), dtype=torch.float32) if return_state
            else _no_state(r))


@wkv6_fwd.register_kernel("cuda")
def _wkv6_fwd_cuda(r, k, v, w, u, state, return_state):
    """K1's launch: the refusals, the launch and its count."""
    B, T, H, N = r.shape
    cuda_lib.check_device("wkv6_cuda", r, k, v, w, u,
                          *([] if state is None else [state]))
    for name, t in (("k", k), ("v", v), ("w", w)):
        if t.shape != r.shape or t.dtype != r.dtype:
            raise ValueError(f"wkv6_cuda: {name} must match r "
                             f"({tuple(r.shape)}, {r.dtype})")
    if u.shape != (H, N):
        raise ValueError(f"wkv6_cuda: u must be ({H}, {N}), got "
                         f"{tuple(u.shape)}")
    if N not in (16, 32, 64, 128):
        raise ValueError(f"wkv6_cuda: head size {N} not in 16/32/64/128")
    code = cuda_lib.dtype_code(r.dtype)
    r, k, v, w = (cuda_lib.aligned16(t) for t in (r, k, v, w))
    uf = u.to(torch.float32).contiguous()
    s0 = None
    if state is not None:
        if state.shape != (B, H, N, N):
            raise ValueError(f"wkv6_cuda: state must be ({B}, {H}, {N}, "
                             f"{N}), got {tuple(state.shape)}")
        s0 = state.to(torch.float32).contiguous()
    y = torch.empty_like(r)
    s_out = (torch.empty(B, H, N, N, device=r.device, dtype=torch.float32)
             if return_state else _no_state(r))
    fn = cuda_lib.entry("wkv6_fwd", "pafc_wkv6_fwd", _ARGTYPES)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = fn(code, B, T, H, N, r.data_ptr(), k.data_ptr(), v.data_ptr(),
             w.data_ptr(), uf.data_ptr(), ptr(s0), y.data_ptr(),
             s_out.data_ptr() if return_state else None,
             W_CLAMP, cuda_lib.stream_ptr(r.device))
    cuda_lib.check(err, "wkv6_fwd")
    wkv6_cuda.launches += 1
    return y, s_out


wkv6_cuda.launches = 0
