"""Decode assets shared by the port's CLIs (port of
``build_decode_assets`` in the JAX ``bin/recognize.py``).

The checkpoint is the port's own: a ``state_dict`` file written with
``torch.save``.  ``convert.state_dict_from_jax`` makes one from a JAX
model's parameters; WeNet checkpoints wait for the port of
``tools/convert_checkpoint.py`` (ROADMAP Queue 1).
"""
from __future__ import annotations

import torch

from paper_accurate_fast_cheap_tpu_torch import resolve_device


def build_decode_assets(config, checkpoint: str, input_dim: int = 80,
                        device=None):
    """Tokenizer, model (weights from ``checkpoint``, eval mode, on
    ``device``: ``cuda`` unless the caller asks for the CPU), model type,
    featurize function and the test-time dataset conf."""
    from paper_accurate_fast_cheap_tpu_torch.frontend import cmvn as cmvn_lib
    from paper_accurate_fast_cheap_tpu_torch.frontend.pipeline import (
        make_feature_fn)
    from paper_accurate_fast_cheap_tpu_torch.models import factory
    from paper_accurate_fast_cheap_tpu_torch.text.tokenizers import (
        init_tokenizer)

    dev = resolve_device(device)
    tokenizer = init_tokenizer(config)
    cmvn_stats = None
    if config.get("cmvn") == "global_cmvn":
        cc = config.get("cmvn_conf", {})
        cmvn_stats = cmvn_lib.load_cmvn(cc["cmvn_file"],
                                        cc.get("is_json_cmvn", True))
    dataset_conf = dict(config.get("dataset_conf", {}))
    # test-conf surgery: no augmentation, dither off
    dataset_conf["spec_aug"] = False
    dataset_conf["spec_sub"] = False
    dataset_conf["speed_perturb"] = False
    fb = dict(dataset_conf.get("fbank_conf", {}))
    fb["dither"] = 0.0
    dataset_conf["fbank_conf"] = fb
    input_dim = fb.get("num_mel_bins", input_dim)

    # built and loaded on the CPU, then moved once
    model, model_type = factory.init_model(config, tokenizer.vocab_size(),
                                           input_dim, device="cpu")
    state = torch.load(checkpoint, map_location="cpu", weights_only=True)
    model.load_state_dict(state, strict=True)
    model = model.to(dev).eval()
    featurize = make_feature_fn(dataset_conf, cmvn_stats, device=dev)
    return tokenizer, model, model_type, featurize, dataset_conf
