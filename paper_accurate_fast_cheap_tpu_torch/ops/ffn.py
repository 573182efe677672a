"""K6: the fused position-wise feed-forward as a hand-written CUDA kernel
(``csrc/ffn.cu``).

Port of the TPU kernel ``ops/ffn_pallas.py`` (``_ffn_kernel`` via
``_ffn_rows`` and ``fused_ffn``): y = act(x @ W1^T + b1) @ W2^T + b2 per
row, the hidden activation kept on chip.  Weights are in nn.Linear layout
(W1 (H, D), W2 (D, H): the transposes of the JAX kernel's).

The source holds two kernels: in bf16, wgmma on the tensor cores over
TMA-fed weight tiles (64-row blocks, two warpgroups splitting y's 512
columns); in f32, 3xTF32 on the tensor cores (each operand split into two
TF32 halves, which keeps f32 precision; 48-row blocks, the y tile in
registers).  Both take D = 512 and H a multiple of
256 only: :func:`check_kernel_shape` raises a :class:`KernelError` for any
other width before a launch.

:func:`fused_ffn` casts the weights to x's dtype, as the JAX wrapper does,
and launches the kernel for a CUDA tensor (or raises); for a CPU tensor it
runs :func:`ffn_plain` on the same cast weights.  It is differentiable: the
backward recomputes through :func:`ffn_plain` on the uncast inputs, as the
JAX custom VJP does.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from paper_accurate_fast_cheap_tpu_torch.ops import cuda_lib

ACTIVATIONS = {
    "swish": F.silu,
    "relu": F.relu,
    # JAX's nn.gelu defaults to the tanh approximation; F.gelu does not
    "gelu": lambda v: F.gelu(v, approximate="tanh"),
    "hardtanh": lambda v: torch.clamp(v, -1.0, 1.0),
}
_ACT_CODE = {name: i for i, name in enumerate(ACTIVATIONS)}

_ARGTYPES = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 7
KERNEL_D = 512      # the model width the kernels take
KERNEL_H_STEP = 256  # H must be a positive multiple of this


def check_kernel_shape(D: int, H: int) -> None:
    """Raise a KernelError unless the CUDA kernels take (D, H): D = 512
    (y's 512 columns are held in registers, split over the warps) and H a
    positive multiple of 256 (whole hidden slices)."""
    if D != KERNEL_D or H < KERNEL_H_STEP or H % KERNEL_H_STEP:
        raise cuda_lib.KernelError(
            f"fused_ffn: the CUDA kernel takes D = {KERNEL_D} and H a "
            f"multiple of {KERNEL_H_STEP}, got D = {D}, H = {H}")


def ffn_plain(x, w1, b1, w2, b2, activation: str = "swish"):
    """The plain formula (``_ffn_ref`` of the JAX package): the activation
    runs on the f32 pre-activation, the hidden is cast to x's dtype before
    the second product, the output is in x's dtype."""
    h = ACTIVATIONS[activation](x.float() @ w1.float().T + b1.float())
    hx = h.to(x.dtype)
    dt = torch.promote_types(hx.dtype, w2.dtype)
    return (hx.to(dt) @ w2.to(dt).T + b2).to(x.dtype)


def _ffn_kernel(x, w1, b1, w2, b2, activation):
    """Launch K6 on (R, D) rows; every tensor in x's dtype."""
    R, D = x.shape
    H = w1.shape[0]
    if w1.shape != (H, D) or b1.shape != (H,) or w2.shape != (D, H) \
            or b2.shape != (D,):
        raise ValueError(
            f"fused_ffn: weights must be W1 ({H}, {D}), b1 ({H},), W2 ({D}, "
            f"{H}), b2 ({D},); got {tuple(w1.shape)}, {tuple(b1.shape)}, "
            f"{tuple(w2.shape)}, {tuple(b2.shape)}")
    if activation not in _ACT_CODE:
        raise ValueError(f"fused_ffn: activation {activation!r} not in "
                         f"{sorted(_ACT_CODE)}")
    check_kernel_shape(D, H)
    cuda_lib.check_device("fused_ffn", x, w1, b1, w2, b2)
    code = cuda_lib.dtype_code(x.dtype)
    x, w1, b1, w2, b2 = (cuda_lib.aligned16(t) for t in (x, w1, b1, w2, b2))
    y = torch.empty_like(x)
    fn = cuda_lib.load("ffn").pafc_ffn
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    err = fn(code, _ACT_CODE[activation], R, D, H, x.data_ptr(),
             w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
             y.data_ptr(), cuda_lib.stream_ptr(x.device))
    cuda_lib.check(err, f"ffn (R {R}, D {D}, H {H})")
    fused_ffn.launches += 1
    return y


class _FusedFFN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, activation):
        ctx.activation = activation
        ctx.save_for_backward(x, w1, b1, w2, b2)
        lead, D = x.shape[:-1], x.shape[-1]
        cast = [t.to(x.dtype) for t in (w1, b1, w2, b2)]
        xr = x.reshape(-1, D)
        if x.device.type != "cuda":
            y = ffn_plain(xr, *cast, activation)
        else:
            y = _ffn_kernel(xr, *cast, activation)
        return y.reshape(*lead, D)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_(need) for t, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            y = ffn_plain(*inputs, ctx.activation)
            got = iter(torch.autograd.grad(y, wanted, g))
        return (*(next(got) if t.requires_grad else None for t in inputs),
                None)


def fused_ffn(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
              w2: torch.Tensor, b2: torch.Tensor,
              activation: str = "swish") -> torch.Tensor:
    """act(x @ w1.T + b1) @ w2.T + b2 over the last axis of x (..., D), with
    w1 (H, D), b1 (H,), w2 (D, H), b2 (D,); float32 or bfloat16.  Returns
    (..., D) in x's dtype."""
    return _FusedFFN.apply(x, w1, b1, w2, b2, activation)


fused_ffn.launches = 0
