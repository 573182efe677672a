"""Model factory from WeNet-style config dicts (port of the JAX
``models/factory.py``): ``model: transducer`` (predictor ``rnn``,
``embedding`` or ``conv``) and ``model: asr_model``, on every ``encoder:``
of the JAX registry (``models/encoder_registry.py``: conformer and
lora_conformer with any attention of the JAX registry, transformer,
branchformer, e_branchformer, squeezeformer, efficient_conformer), with an
optional ``decoder: transformer`` or ``bitransformer``.  The encoder keys
are JAX's: a family's own keys outside them (``reduce_idx``,
``stride_layers``, ``merge_method``, ``num_langs``, ...) take their
defaults from a YAML; the language-specific blocks are built by passing
``encoder_conf=dict(..., num_langs=K)`` to the model classes.  As in JAX,
any other ``model:`` value builds the ``ASRModel`` (logged); the other
families (``models/bitransducer.py``, ``paraformer.py``, ``ctl_model.py``,
``ssl_*.py``, ``whisper.py``) are built from their classes."""
from __future__ import annotations

import logging
from typing import Any, Dict, Optional

import torch

from paper_accurate_fast_cheap_tpu_torch import resolve_device
from paper_accurate_fast_cheap_tpu_torch.models.asr_model import ASRModel
from paper_accurate_fast_cheap_tpu_torch.models.layers import init_default
from paper_accurate_fast_cheap_tpu_torch.models.transducer import (
    PREDICTORS, Transducer)

# encoder_conf keys that map 1:1 onto ConformerEncoder fields
_ENCODER_KEYS = {
    "output_size", "attention_heads", "linear_units", "num_blocks",
    "dropout_rate", "positional_dropout_rate", "attention_dropout_rate",
    "input_layer", "pos_enc_layer_type", "normalize_before",
    "macaron_style", "use_cnn_module", "cnn_module_kernel",
    "cnn_module_norm", "activation_type", "causal", "key_bias",
    "selfattention_layer_type", "static_chunk_size", "use_dynamic_chunk",
    "use_dynamic_left_chunk", "gradient_checkpointing",
    "cgmlp_linear_units", "cgmlp_conv_kernel", "use_ffn",
    "merge_conv_kernel",
}
# keys routed into rwkv_conf (accepted; wkv_impl/wkv_chunk_size do nothing;
# spmd_axis is set by recognize_wav --seq_parallel)
_RWKV_KEYS = {
    "rnn_att_version", "rnn_att_direction", "rwkv_ctx_len",
    "rwkv_do_bfloat16", "att_context_size", "global_tokens",
    "global_tokens_spacing", "global_attn_separate", "wkv_impl",
    "wkv_chunk_size", "spmd_axis",
}


def encoder_conf_from_yaml(conf: Dict[str, Any],
                           input_dim: int = 80) -> Dict[str, Any]:
    enc = {k: v for k, v in conf.items() if k in _ENCODER_KEYS}
    rwkv = {k: v for k, v in conf.items() if k in _RWKV_KEYS}
    enc["input_size"] = input_dim
    if rwkv:
        enc["rwkv_conf"] = rwkv
    unknown = set(conf) - _ENCODER_KEYS - _RWKV_KEYS
    if unknown:
        logging.getLogger(__name__).info("encoder_conf keys ignored: %s",
                                         sorted(unknown))
    return enc


def init_model(config: Dict[str, Any], vocab_size: int, input_dim: int = 80,
               device=None, generator: Optional[torch.Generator] = None):
    """Build and initialise the model a WeNet-style config describes.

    Weights are drawn on the CPU from ``generator`` (seed 0 if None) with
    flax's default initializers, then moved to ``device`` (``cuda`` unless
    the caller asks for the CPU).  Returns (model, "transducer" or
    "asr_model") in ``.eval()`` mode; call ``.train()`` for dropout.
    """
    dev = resolve_device(device)
    model_type = config.get("model", "asr_model")
    encoder_type = config.get("encoder", "conformer")
    predictor = config.get("predictor", "rnn")
    if model_type == "transducer" and predictor not in PREDICTORS:
        raise NotImplementedError(
            f"predictor {predictor!r}: a transducer's predictor is rnn, "
            "embedding or conv")
    if model_type not in ("transducer", "asr_model"):
        logging.getLogger(__name__).info(
            "model %r: building the hybrid CTC/attention ASRModel, as the "
            "JAX factory does", model_type)
        model_type = "asr_model"
    enc_conf = encoder_conf_from_yaml(config.get("encoder_conf", {}),
                                      input_dim)
    model_conf = config.get("model_conf", {})
    special = config.get("tokenizer_conf", {}).get("special_tokens", {})
    sos = special.get("<sos>", vocab_size - 1)
    eos = special.get("<eos>", vocab_size - 1)
    dec_conf = None
    if config.get("decoder") is not None:
        dec_conf = dict(config.get("decoder_conf", {}))
        if config.get("decoder") == "transformer":
            dec_conf["r_num_blocks"] = 0
    loss_kw = dict(
        decoder_conf=dec_conf,
        reverse_weight=model_conf.get("reverse_weight", 0.0),
        lsm_weight=model_conf.get("lsm_weight", 0.1),
        length_normalized_loss=model_conf.get("length_normalized_loss",
                                              False),
        sos=sos, eos=eos)
    if model_type == "transducer":
        joint_conf = dict(config.get("joint_conf", {}))
        joint_conf.pop("enc_output_size", None)
        joint_conf.pop("pred_output_size", None)
        pred_conf = dict(config.get("predictor_conf", {}))
        # keys the reference's RNN predictor takes but this one fixes
        # (lstm, bias)
        for k in ("rnn_type", "bias"):
            pred_conf.pop(k, None)
        model = Transducer(
            vocab_size=vocab_size, encoder_conf=enc_conf,
            encoder_type=encoder_type, predictor=predictor,
            predictor_conf=pred_conf, joint_conf=joint_conf,
            blank_id=config.get("ctc_conf", {}).get("ctc_blank_id", 0),
            transducer_weight=model_conf.get("transducer_weight", 0.3),
            ctc_weight=model_conf.get("ctc_weight", 0.2),
            attention_weight=model_conf.get("attention_weight", 0.5),
            **loss_kw)
    else:
        model = ASRModel(
            vocab_size=vocab_size, encoder_conf=enc_conf,
            encoder_type=encoder_type,
            ctc_weight=model_conf.get("ctc_weight", 0.3),
            use_focal_ctc=config.get("ctc_conf", {}).get("use_focal_loss",
                                                         False),
            **loss_kw)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    init_default(model, generator)
    return model.to(dev).eval(), model_type
