"""K3: one step of the stacked-LSTM transducer predictor as a hand-written
CUDA kernel (``csrc/lstm_step.cu``).

Port of the TPU kernel ``ops/lstm_pallas.py:_lstm_step_kernel`` (via
``lstm_predictor_step``).  For a CUDA tensor :func:`lstm_predictor_step`
launches the kernel or raises; for a CPU tensor it runs
:func:`lstm_step_plain`.  The embedding gather stays with the caller.

In bf16 the kernel runs on the tensor cores (wgmma over TMA-fed tiles) and
needs E, H and O multiples of 8; in f32 (the card-vs-CPU reference) it is
a CUDA-core product.
"""
from __future__ import annotations

import ctypes

import torch

from paper_accurate_fast_cheap_tpu_torch.ops import cuda_lib

_ARGTYPES = [ctypes.c_int] * 6 + [ctypes.c_void_p] * 14
# the C entry's weight pointers, by the weights' (id, data_ptr, shape,
# dtype) and the compute dtype: the beam passes the same weights every
# frame.  Only weights used as they are (no cast or copy) are kept, so the
# pointers are those in the key, and an in-place update of a parameter is
# seen by the next call.
_PREPARED: dict = {}


def lstm_step_plain(x, hs, cs, layers, wproj, bproj):
    """The kernel's plain PyTorch version: gates in f32 (order i, f, g, o),
    the state cast to x's dtype before its product, new h/c in the state
    dtypes, the next layer's input and ``out`` in x's dtype."""
    dt = x.dtype
    new_h, new_c = [], []
    for i, (wih, bih, whh) in enumerate(layers):
        h = hs[i].to(dt).float()
        gates = (x.float() @ wih.to(dt).float().T + bih.to(dt).float()
                 + h @ whh.to(dt).float().T)
        ig, fg, gg, og = gates.chunk(4, dim=-1)
        c = torch.sigmoid(fg) * cs[i].float() + torch.sigmoid(ig) * torch.tanh(
            gg)
        hf = torch.sigmoid(og) * torch.tanh(c)
        new_h.append(hf.to(hs.dtype))
        new_c.append(c.to(cs.dtype))
        x = hf.to(dt)
    out = x.float() @ wproj.to(dt).float().T + bproj.to(dt).float()
    return out.to(dt), torch.stack(new_h), torch.stack(new_c)


def _weights(x, layers, wproj, bproj, dt, E, H, O):
    """The weights' pointers for the C entry, each weight shape- and
    device-checked and in the compute dtype, 16-byte aligned: the three
    ctypes arrays (W_ih, W_hh, b per layer), W_proj's and b_proj's, and
    the tensors that must outlive the call (cast copies)."""
    L = len(layers)
    flat = [t for lay in layers for t in lay] + [wproj, bproj]
    key = (dt,) + tuple((id(t), t.data_ptr(), t.shape, t.dtype)
                        for t in flat)
    hit = _PREPARED.get(key)
    if hit is not None:
        return hit
    shapes = []
    for i in range(L):
        shapes += [(4 * H, E if i == 0 else H), (4 * H,), (4 * H, H)]
    shapes += [(O, H), (O,)]
    for t, shape in zip(flat, shapes):
        if tuple(t.shape) != shape:
            raise ValueError(f"lstm_predictor_step: expected {shape}, got "
                             f"{tuple(t.shape)}")
    cuda_lib.check_device("lstm_predictor_step", x, *flat)
    ts = [cuda_lib.aligned16(t.to(dt)) for t in flat]
    arrays = tuple((ctypes.c_void_p * L)(*(ts[3 * i + j].data_ptr()
                                           for i in range(L)))
                   for j in (0, 2, 1))
    if all(a is b for a, b in zip(ts, flat)):
        if len(_PREPARED) >= 16:
            _PREPARED.clear()
        _PREPARED[key] = (arrays, ts[-2].data_ptr(), ts[-1].data_ptr(), ())
        return _PREPARED[key]
    return arrays, ts[-2].data_ptr(), ts[-1].data_ptr(), ts


def lstm_predictor_step(x: torch.Tensor, hs: torch.Tensor, cs: torch.Tensor,
                        layers, wproj: torch.Tensor, bproj: torch.Tensor):
    """One predictor step.

    x: (R, E) embedded last tokens; hs, cs: (L, R, H) stacked states
    (float32 on the card, as ``RNNPredictor.init_state`` makes them);
    ``layers``: L tuples (wih (4H, E|H), bih (4H,), whh (4H, H)) in
    nn.Linear layout; wproj (O, H), bproj (O,).  Returns (out (R, O),
    new_hs, new_cs).
    """
    if x.device.type != "cuda":
        return lstm_step_plain(x, hs, cs, layers, wproj, bproj)
    L = len(layers)
    R, E = x.shape
    H = hs.shape[-1]
    O = wproj.shape[0]
    if hs.shape != (L, R, H) or cs.shape != (L, R, H):
        raise ValueError(f"lstm_predictor_step: hs/cs must be ({L}, {R}, "
                         f"{H}), got {tuple(hs.shape)}, {tuple(cs.shape)}")
    if hs.dtype != torch.float32 or cs.dtype != torch.float32:
        raise ValueError("lstm_predictor_step: hs and cs must be float32 on "
                         f"the card, got {hs.dtype}, {cs.dtype}")
    cuda_lib.check_device("lstm_predictor_step", x, hs, cs)
    dt = x.dtype
    code = cuda_lib.dtype_code(dt)
    if dt == torch.bfloat16 and (E % 8 or H % 8 or O % 8):
        raise cuda_lib.KernelError(
            f"lstm_predictor_step: the bf16 kernel's TMA loads need E, H "
            f"and O multiples of 8, got {E}, {H}, {O}")
    (wih_p, whh_p, bih_p), wp, bp, _keep = _weights(
        x, layers, wproj, bproj, dt, E, H, O)
    x = cuda_lib.aligned16(x)
    hs, cs = hs.contiguous(), cs.contiguous()
    out = torch.empty(R, O, device=x.device, dtype=dt)
    nhs, ncs = torch.empty_like(hs), torch.empty_like(cs)
    # the next layers' inputs and, in bf16, the state cast for TMA
    bf16 = dt == torch.bfloat16
    scratch = torch.empty(2 if bf16 else 1, L, R, H, device=x.device,
                          dtype=dt)
    hbuf = scratch.data_ptr() + L * R * H * 2 if bf16 else None
    fn = cuda_lib.entry("lstm_step", "pafc_lstm_step", _ARGTYPES)
    err = fn(code, L, R, E, H, O, x.data_ptr(), hs.data_ptr(),
             cs.data_ptr(), wih_p, whh_p, bih_p, wp, bp, out.data_ptr(),
             nhs.data_ptr(), ncs.data_ptr(), scratch.data_ptr(), hbuf,
             cuda_lib.stream_ptr(x.device))
    cuda_lib.check(err, "lstm_step")
    lstm_predictor_step.launches += 1
    return out, nhs, ncs


lstm_predictor_step.launches = 0
