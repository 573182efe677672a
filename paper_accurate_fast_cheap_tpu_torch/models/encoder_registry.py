"""Encoder class registry (port of the JAX ``models/encoder_registry.py``):
``build_encoder`` builds every ``encoder:`` value of the JAX registry from
an ``encoder_conf`` dict, keeping for each family the keys the JAX registry
keeps (so a YAML's keys of another family are dropped the same way), and
``is_chunkable`` says whether the encoder takes the chunk arguments
(``decoding_chunk_size``, ``num_decoding_left_chunks``) and ``cat_embs``,
which ``forward_encoder`` passes only to such an encoder.

``lora_conformer`` builds the plain conformer, as in JAX.
"""
from __future__ import annotations

import inspect
from typing import Any, Dict

import torch.nn as nn

from paper_accurate_fast_cheap_tpu_torch.models.branchformer import (
    BranchformerEncoder)
from paper_accurate_fast_cheap_tpu_torch.models.conformer import (
    ConformerEncoder, TransformerEncoder)
from paper_accurate_fast_cheap_tpu_torch.models.efficient_conformer import (
    EfficientConformerEncoder)
from paper_accurate_fast_cheap_tpu_torch.models.squeezeformer import (
    SqueezeformerEncoder)

_BRANCHFORMER_KEYS = {
    "input_size", "output_size", "attention_heads", "cgmlp_linear_units",
    "cgmlp_conv_kernel", "num_blocks", "dropout_rate",
    "positional_dropout_rate", "attention_dropout_rate", "input_layer",
    "pos_enc_layer_type", "use_ffn", "linear_units", "merge_conv_kernel",
}
_TRANSFORMER_KEYS = {
    "input_size", "output_size", "attention_heads", "linear_units",
    "num_blocks", "dropout_rate", "positional_dropout_rate",
    "attention_dropout_rate", "input_layer", "pos_enc_layer_type",
    "normalize_before", "key_bias", "activation_type",
}


def _init_keys(cls) -> set:
    return {n for n, p in inspect.signature(cls.__init__).parameters.items()
            if n != "self" and p.kind is p.POSITIONAL_OR_KEYWORD}


_FAMILIES = {
    "conformer": (ConformerEncoder, _init_keys(ConformerEncoder)),
    "lora_conformer": (ConformerEncoder, _init_keys(ConformerEncoder)),
    "transformer": (TransformerEncoder, _TRANSFORMER_KEYS),
    "squeezeformer": (SqueezeformerEncoder,
                      _init_keys(SqueezeformerEncoder)),
    "efficient_conformer": (EfficientConformerEncoder,
                            _init_keys(EfficientConformerEncoder)),
    "branchformer": (BranchformerEncoder, _BRANCHFORMER_KEYS),
    "e_branchformer": (BranchformerEncoder, _BRANCHFORMER_KEYS),
}


def build_encoder(encoder_type: str, enc_conf: Dict[str, Any]) -> nn.Module:
    if encoder_type not in _FAMILIES:
        raise NotImplementedError(f"encoder type {encoder_type!r}")
    cls, keys = _FAMILIES[encoder_type]
    conf = {k: v for k, v in enc_conf.items() if k in keys}
    if encoder_type == "e_branchformer":
        conf.setdefault("use_ffn", True)
        conf.setdefault("merge_conv_kernel", 3)
    return cls(**conf)


def is_chunkable(encoder: nn.Module) -> bool:
    return isinstance(encoder, ConformerEncoder)


def eval_forward(encoder: nn.Module, *args, **kw):
    """One forward with dropout off (JAX's ``deterministic=True``), still
    differentiable; the encoder's mode is restored."""
    was = encoder.training
    encoder.eval()
    try:
        return encoder(*args, **kw)
    finally:
        encoder.train(was)


def forward_encoder(encoder: nn.Module, feats, feat_lens,
                    decoding_chunk_size: int = 0,
                    num_decoding_left_chunks: int = -1, cat_embs=None):
    """The JAX models' ``forward_encoder``: a chunkable (conformer) encoder
    takes the chunk arguments and ``cat_embs``; the other families run
    their full forward and ignore both."""
    if is_chunkable(encoder):
        return encoder(feats, feat_lens, decoding_chunk_size,
                       num_decoding_left_chunks, cat_embs=cat_embs)
    return encoder(feats, feat_lens)
