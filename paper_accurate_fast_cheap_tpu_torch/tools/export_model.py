"""Serialized model export through ``torch.export`` (port of the JAX
``tools/export_model.py``).

Parity target: the reference's torchscript/ONNX export surface
(`wenet/transformer/asr_model.py:611-986`: forward_encoder_chunk,
ctc_activation, forward_attention_decoder for the C++ runtime;
`train_utils.py:483-494` --jit smoke test).  The serving hot path, encoder +
CTC log-probs, is exported at static (batch, frames) with
``torch.export.export``, written into bytes by ``torch.export.save`` and
read back by ``torch.export.load``.  The weights travel inside the program.

K1 is the registered operator ``pafc_torch::wkv6_fwd`` (``ops/wkv6_cuda``):
the exporter records it as one node, so a program exported and run on the
card launches K1 as eager does.  This module imports the port's ``ops``,
which registers it, before any program is loaded.
"""
from __future__ import annotations

import io
import os

import numpy as np
import torch

import paper_accurate_fast_cheap_tpu_torch.ops  # noqa: F401  (K1's operator)


class EncoderCTC(torch.nn.Module):
    """(feats (B, T, D) f32, lens (B,) int32) -> (CTC log-probs (B, T', V),
    encoder lengths (B,)): ``forward_encoder`` then ``ctc_logprobs``."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, feats, lens):
        enc, enc_lens = self.model.forward_encoder(feats, lens)
        return self.model.ctc_logprobs(enc), enc_lens


def export_program(model, input_dim: int = 80, batch: int = 1,
                   frames: int = 2051):
    """The ``torch.export.ExportedProgram`` of encoder + CTC on the model's
    device, the model in eval mode, shapes static."""
    dev = next(model.parameters()).device
    feats = torch.zeros(batch, frames, input_dim, device=dev)
    lens = torch.full((batch,), frames, dtype=torch.int32, device=dev)
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            return torch.export.export(EncoderCTC(model), (feats, lens))
    finally:
        model.train(was_training)


def export_encoder_ctc(model, input_dim: int = 80, batch: int = 1,
                       frames: int = 2051) -> bytes:
    """Serialize encoder + CTC log-probs (the serving hot path) to bytes.
    Shapes are static (batch, frames)."""
    buf = io.BytesIO()
    torch.export.save(export_program(model, input_dim, batch, frames), buf)
    return buf.getvalue()


def load_exported(blob: bytes):
    """Deserialize and return a callable (feats, lens) -> (log-probs,
    encoder lengths): the program's graph module."""
    return torch.export.load(io.BytesIO(blob)).module()


def graph_ops(module) -> list:
    """The operator names a loaded program's graph calls, in graph
    order."""
    return [str(n.target) for n in module.graph.nodes
            if n.op == "call_function"]


def export_smoke_test(model, input_dim: int = 80) -> bool:
    """`--jit` trainability smoke test analog (`train_utils.py:483-494`):
    fails fast when the model stops being exportable."""
    blob = export_encoder_ctc(model, input_dim=input_dim, batch=1,
                              frames=128)
    fn = load_exported(blob)
    dev = next(model.parameters()).device
    with torch.no_grad():
        out = fn(torch.zeros(1, 128, input_dim, device=dev),
                 torch.tensor([128], dtype=torch.int32, device=dev))
    return bool(np.isfinite(out[0].float().cpu().numpy()).all())


def save_exported(path: str, blob: bytes) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(blob)
