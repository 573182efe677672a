"""K3: one step of the stacked-LSTM transducer predictor as a hand-written
CUDA kernel (``csrc/lstm_step.cu``).

Port of the TPU kernel ``ops/lstm_pallas.py:_lstm_step_kernel`` (via
``lstm_predictor_step``).  For a CUDA tensor :func:`lstm_predictor_step`
launches the kernel or raises; for a CPU tensor it runs
:func:`lstm_step_plain`.  The embedding gather stays with the caller.
"""
from __future__ import annotations

import ctypes

import torch

from paper_accurate_fast_cheap_tpu_torch.ops import cuda_lib

_ARGTYPES = [ctypes.c_int] * 6 + [ctypes.c_void_p] * 13


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
    cuda_lib.check_device("lstm_predictor_step", x, hs, cs, wproj, bproj,
                          *(t for lay in layers for t in lay))
    dt = x.dtype
    code = cuda_lib.dtype_code(dt)
    keep = []  # tensors whose pointers the kernel reads

    def ptr(t, shape):
        if tuple(t.shape) != shape:
            raise ValueError(f"lstm_predictor_step: expected {shape}, got "
                             f"{tuple(t.shape)}")
        t = t.to(dt).contiguous()
        keep.append(t)
        return t.data_ptr()

    wih_p = (ctypes.c_void_p * L)()
    whh_p = (ctypes.c_void_p * L)()
    bih_p = (ctypes.c_void_p * L)()
    for i, (wih, bih, whh) in enumerate(layers):
        wih_p[i] = ptr(wih, (4 * H, E if i == 0 else H))
        bih_p[i] = ptr(bih, (4 * H,))
        whh_p[i] = ptr(whh, (4 * H, H))
    wp, bp = ptr(wproj, (O, H)), ptr(bproj, (O,))
    x, hs, cs = x.contiguous(), hs.contiguous(), cs.contiguous()
    out = torch.empty(R, O, device=x.device, dtype=dt)
    nhs, ncs = torch.empty_like(hs), torch.empty_like(cs)
    xbuf = torch.empty(L, R, H, device=x.device, dtype=dt)
    fn = cuda_lib.load("lstm_step").pafc_lstm_step
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    err = fn(code, L, R, E, H, O, x.data_ptr(), hs.data_ptr(),
             cs.data_ptr(), wih_p, whh_p, bih_p, wp, bp, out.data_ptr(),
             nhs.data_ptr(), ncs.data_ptr(), xbuf.data_ptr(),
             cuda_lib.stream_ptr(x.device))
    cuda_lib.check(err, "lstm_step")
    lstm_predictor_step.launches += 1
    return out, nhs, ncs


lstm_predictor_step.launches = 0
