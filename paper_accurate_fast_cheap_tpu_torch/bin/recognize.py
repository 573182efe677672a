"""Short-form batch decoding CLI (port of the JAX ``bin/recognize.py``) and
the decode assets shared by the port's CLIs (``build_decode_assets``).

Decodes a raw (JSON lines), tar-shard or zip-shard list in static batches
of the test-mode data pipeline (``data/pipeline.py``: sorted by length, no
augmentation, dither 0) with any of the four modes, ``ctc_greedy_search``,
``ctc_prefix_beam_search``, ``attention_rescoring`` (the CTC prefix beam's
n-best rescored by the attention decoder) and ``rnnt_beam_search`` (the
device prefix beam, K2 and K3), and writes ``result_dir/<mode>/text``
lines ``<key> <text>`` in the JAX CLI's format and order.

The flags are the JAX CLI's (``--blank_penalty`` is accepted and, as
there, unused) plus ``--device`` (``cuda`` unless ``cpu`` is asked for)
and ``--precision`` (``fp32``, the checkpoint's own dtype as in the JAX
CLI, or ``bf16`` weights and features).  The checkpoint is the port's own:
a ``state_dict`` file written with ``torch.save``;
``tools/convert_checkpoint.py`` makes one from a WeNet checkpoint and
``convert.state_dict_from_jax`` from a JAX model's parameters.

Usage:
  python -m paper_accurate_fast_cheap_tpu_torch.bin.recognize \\
      --config conf.yaml --checkpoint model.pt --data_type raw \\
      --test_data data.list --result_dir out \\
      --modes ctc_greedy_search attention_rescoring rnnt_beam_search \\
      [--device cpu]
"""
from __future__ import annotations

import argparse
import logging
import os
import sys

import torch

from paper_accurate_fast_cheap_tpu_torch import resolve_device

SUPPORTED_MODES = [
    "ctc_greedy_search",
    "ctc_prefix_beam_search",
    "attention_rescoring",
    "rnnt_beam_search",
]


def get_args(argv=None):
    p = argparse.ArgumentParser(description="batch decode")
    p.add_argument("--config", required=True, help="train.yaml")
    p.add_argument("--test_data", required=True)
    p.add_argument("--data_type", default="shard",
                   choices=["raw", "shard", "zip_shard"])
    p.add_argument("--checkpoint", required=True,
                   help="the port's state_dict file (torch.save)")
    p.add_argument("--result_dir", required=True)
    p.add_argument("--modes", nargs="+", default=["ctc_greedy_search"],
                   choices=SUPPORTED_MODES)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--beam_size", type=int, default=8)
    p.add_argument("--ctc_weight", type=float, default=0.3)
    p.add_argument("--transducer_weight", type=float, default=0.7)
    p.add_argument("--rescore_ctc_weight", type=float, default=0.3)
    p.add_argument("--reverse_weight", type=float, default=0.0)
    p.add_argument("--blank_penalty", type=float, default=0.0,
                   help="accepted and unused, as in the JAX CLI")
    p.add_argument("--precision", default="fp32", choices=["fp32", "bf16"],
                   help="decode dtype of the weights and features")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def build_decode_assets(config, checkpoint: str, input_dim: int = 80,
                        device=None):
    """Tokenizer, model (weights from ``checkpoint``, eval mode, on
    ``device``: ``cuda`` unless the caller asks for the CPU), model type,
    featurize function and the test-time dataset conf."""
    from paper_accurate_fast_cheap_tpu_torch.convert import (
        as_limited_context)
    from paper_accurate_fast_cheap_tpu_torch.frontend import cmvn as cmvn_lib
    from paper_accurate_fast_cheap_tpu_torch.frontend.pipeline import (
        make_feature_fn)
    from paper_accurate_fast_cheap_tpu_torch.models import factory
    from paper_accurate_fast_cheap_tpu_torch.models.lca import (
        LimitedRelPositionAttention)
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
    if any(isinstance(m, LimitedRelPositionAttention)
           for m in model.modules()):
        # an MHA checkpoint decodes with limited context (recognize_wav
        # --encoder_context_size)
        state = as_limited_context(state)
    model.load_state_dict(state, strict=True)
    model = model.to(dev).eval()
    featurize = make_feature_fn(dataset_conf, cmvn_stats, device=dev)
    return tokenizer, model, model_type, featurize, dataset_conf


def decode_batch(model, model_type, feats, feat_lens, args, sos, eos):
    """Run every requested mode on one device batch of features; returns
    {mode: [DecodeResult per row]}."""
    from paper_accurate_fast_cheap_tpu_torch.decode import (
        rnnt_search, search)

    results = {}
    enc, enc_lens = model.forward_encoder(feats, feat_lens)
    logp = model.ctc_logprobs(enc)
    logp_np = logp.float().cpu().numpy()
    lens_np = enc_lens.cpu().numpy()
    for mode in args.modes:
        if mode == "ctc_greedy_search":
            results[mode] = search.ctc_greedy_search(logp_np, lens_np)
        elif mode == "ctc_prefix_beam_search":
            results[mode] = search.ctc_prefix_beam_search(
                logp_np, lens_np, beam_size=args.beam_size)
        elif mode == "attention_rescoring":
            nbest = search.ctc_prefix_beam_search(
                logp_np, lens_np, beam_size=args.beam_size)
            results[mode] = search.attention_rescoring(
                model.decoder_forward, enc, enc_lens, nbest, sos, eos,
                ctc_weight=args.rescore_ctc_weight,
                reverse_weight=args.reverse_weight)
        elif mode == "rnnt_beam_search":
            if model_type != "transducer":
                raise ValueError("rnnt_beam_search needs a transducer model")
            results[mode] = rnnt_search.rnnt_beam_search(
                *rnnt_search.make_transducer_step_fns(model), enc, enc_lens,
                logp, beam_size=args.beam_size, ctc_weight=args.ctc_weight,
                transducer_weight=args.transducer_weight)
    return results


def main(argv=None):
    args = get_args(argv)
    logging.basicConfig(level=logging.INFO)
    from paper_accurate_fast_cheap_tpu_torch.data import pipeline as dp
    from paper_accurate_fast_cheap_tpu_torch.utils.config import load_config

    dev = resolve_device(args.device)
    config = load_config(args.config)
    tokenizer, model, model_type, featurize, dataset_conf = \
        build_decode_assets(config, args.checkpoint, device=dev)
    if args.precision == "bf16":
        model = model.to(torch.bfloat16)
    special = config.get("tokenizer_conf", {}).get("special_tokens", {})
    sos = special.get("<sos>", tokenizer.vocab_size() - 1)
    eos = special.get("<eos>", tokenizer.vocab_size() - 1)

    dataset_conf = dict(dataset_conf)
    dataset_conf["batch_conf"] = {"batch_type": "static",
                                  "batch_size": args.batch_size}
    dataset_conf["shuffle"] = False

    files = {}
    for mode in args.modes:
        d = os.path.join(args.result_dir, mode)
        os.makedirs(d, exist_ok=True)
        files[mode] = open(os.path.join(d, "text"), "w", encoding="utf-8")
    try:
        with torch.no_grad():
            for batch in dp.build_dataset(args.data_type, args.test_data,
                                          tokenizer, dataset_conf,
                                          mode="test"):
                feats, feat_lens = featurize(
                    torch.from_numpy(batch["wavs"]),
                    torch.from_numpy(batch["wav_lens"]))
                if args.precision == "bf16":
                    feats = feats.to(torch.bfloat16)
                results = decode_batch(model, model_type, feats, feat_lens,
                                       args, sos, eos)
                for mode, res in results.items():
                    for key, r in zip(batch["keys"], res):
                        text, _ = tokenizer.detokenize(r.tokens)
                        files[mode].write(f"{key} {text}\n")
                        logging.info("%s %s: %s", mode, key, text)
    finally:
        for f in files.values():
            f.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
