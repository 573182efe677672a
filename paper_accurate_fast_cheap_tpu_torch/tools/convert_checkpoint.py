"""Convert a WeNet/reference torch checkpoint to the port's state_dict (port
of the JAX ``tools/convert_checkpoint.py``).

Maps the reference's state_dict names (``wenet/transformer/encoder.py``,
``wenet/rwkv_v6/``, ``wenet/transducer/``) straight onto the port's module
names.  The port's modules keep torch's layouts, so most tensors are copied
as they are; the rules that change something:

  the conv2d subsampling's Linear      -> its input rows permuted from the
    reference's channel-major (c, f) flattening to the port's (f, c)
  pointwise Conv1d (O, I, 1)           -> Linear weight (O, I)
  LSTM bias_ih_l{k} + bias_hh_l{k}     -> one ``ih`` bias (the i, f, g, o
    gate order is the same)
  RWKV time_* mixing tensors           -> squeezed to the port's shapes

It covers the conformer blocks with RWKV-6 (uni, bi, direction dropout),
Mamba-2 (uni, bi: mamba_ssm's ``Mamba2`` state dict), MHA, rel-pos MHA or
LCA attention, the CTC head, both attention decoders,
the LSTM predictor and the transducer joint, as the JAX converter does (the
reference LCA's ``global_q/k/v`` have no counterpart in either package).
It is non-strict: it starts from the model ``init_model`` builds from
``--config`` (seed 0) and logs the reference keys it did not read and the
port's parameters it did not set.

Usage:
  python -m paper_accurate_fast_cheap_tpu_torch.tools.convert_checkpoint \\
      --checkpoint wenet.pt --config train.yaml --output model.pt

``model.pt`` is what ``bin/recognize_wav.py`` and ``bin/recognize.py`` load
with ``--checkpoint``.
"""
from __future__ import annotations

import argparse
import logging
import sys
from typing import Any, Dict, Mapping

import numpy as np
import torch

log = logging.getLogger(__name__)

_TMIX_VECTORS = ("time_maa_x", "time_maa_r", "time_maa_k", "time_maa_v",
                 "time_maa_w", "time_decay")
_TMIX_MATRICES = ("time_maa_rkvw_w1", "time_maa_rkvw_w2", "time_decay_w1",
                  "time_decay_w2", "time_faaaa")


class _Converter:
    """Reads reference tensors by name (remembering which) and sets the
    port's (only names the port's model has; a name it lacks is a
    KeyError)."""

    def __init__(self, sd: Mapping[str, Any],
                 state: Mapping[str, torch.Tensor]):
        self.sd = sd
        self.read = set()
        self.out = dict(state)
        self.set = set()

    def has(self, name: str) -> bool:
        return name in self.sd

    def get(self, name: str) -> torch.Tensor:
        self.read.add(name)
        v = self.sd[name]
        return (v.detach().cpu() if torch.is_tensor(v)
                else torch.from_numpy(np.asarray(v)))

    def put(self, name: str, value: torch.Tensor) -> None:
        if name not in self.out:
            raise KeyError(f"convert_state_dict: the port's model has no "
                           f"parameter {name!r}")
        want = self.out[name]
        self.out[name] = value.reshape(want.shape).to(want.dtype).contiguous()
        self.set.add(name)

    def owns(self, prefix: str) -> bool:
        """Whether the port's model has a module at ``prefix``."""
        return any(k.startswith(prefix + ".") for k in self.out)

    def dense(self, src: str, dst: str, bias: bool = True) -> None:
        self.put(f"{dst}.weight", self.get(f"{src}.weight"))
        if bias and self.has(f"{src}.bias") and f"{dst}.bias" in self.out:
            self.put(f"{dst}.bias", self.get(f"{src}.bias"))

    def norm(self, src: str, dst: str) -> None:
        self.put(f"{dst}.weight", self.get(f"{src}.weight"))
        self.put(f"{dst}.bias", self.get(f"{src}.bias"))

    def tmix(self, src: str, dst: str) -> None:
        for name in _TMIX_VECTORS + _TMIX_MATRICES:
            self.put(f"{dst}.{name}", self.get(f"{src}.{name}"))
        for name in ("receptance", "key", "value", "output"):
            self.dense(f"{src}.{name}", f"{dst}.{name}", bias=False)
        self.norm(f"{src}.ln_x", f"{dst}.ln_x")

    def mamba2(self, src: str, dst: str) -> None:
        """mamba_ssm's Mamba2 state dict -> a ``Mamba2Block``: the depthwise
        conv keeps torch's (C, 1, K) kernel, its bias is optional."""
        self.dense(f"{src}.in_proj", f"{dst}.in_proj", bias=False)
        self.put(f"{dst}.conv1d.weight", self.get(f"{src}.conv1d.weight"))
        if self.has(f"{src}.conv1d.bias"):
            self.put(f"{dst}.conv1d.bias", self.get(f"{src}.conv1d.bias"))
        for name in ("dt_bias", "A_log", "D"):
            self.put(f"{dst}.{name}", self.get(f"{src}.{name}"))
        self.put(f"{dst}.norm.weight", self.get(f"{src}.norm.weight"))
        self.dense(f"{src}.out_proj", f"{dst}.out_proj", bias=False)


def _subsampling(c: _Converter) -> None:
    if not c.has("encoder.embed.conv.0.weight"):
        return
    for i, j in ((0, 0), (1, 2)):
        c.put(f"encoder.embed.Conv_{i}.weight",
              c.get(f"encoder.embed.conv.{j}.weight"))
        c.put(f"encoder.embed.Conv_{i}.bias",
              c.get(f"encoder.embed.conv.{j}.bias"))
    # the reference flattens the conv output channel-major (c, f)
    # (``x.transpose(1, 2).view(b, t, c * f)``); the port's is (f, c)
    w_out = c.get("encoder.embed.out.0.weight")            # (odim, c*f)
    odim = w_out.shape[0]
    ch = c.out["encoder.embed.Conv_1.weight"].shape[0]
    f = w_out.shape[1] // ch
    c.put("encoder.embed.Dense_0.weight",
          w_out.reshape(odim, ch, f).transpose(1, 2).reshape(odim, f * ch))
    if c.has("encoder.embed.out.0.bias"):
        c.put("encoder.embed.Dense_0.bias", c.get("encoder.embed.out.0.bias"))


def _encoder_layer(c: _Converter, i: int) -> None:
    src, dst = f"encoder.encoders.{i}", f"encoder.layer_{i}"
    for n in ("norm_ff", "norm_mha", "norm_ff_macaron", "norm_conv",
              "norm_final"):
        if c.owns(f"{dst}.{n}"):
            c.norm(f"{src}.{n}", f"{dst}.{n}")
    for n in ("feed_forward", "feed_forward_macaron"):
        if c.owns(f"{dst}.{n}"):
            c.dense(f"{src}.{n}.w_1", f"{dst}.{n}.Dense_0")
            c.dense(f"{src}.{n}.w_2", f"{dst}.{n}.Dense_1")
    if c.owns(f"{dst}.conv_module"):
        cm, cs = f"{dst}.conv_module", f"{src}.conv_module"
        # the pointwise convs are kernel-1 Conv1d == Linear
        for k, name in ((0, "pointwise_conv1"), (1, "pointwise_conv2")):
            c.put(f"{cm}.Dense_{k}.weight",
                  c.get(f"{cs}.{name}.weight")[:, :, 0])
            c.put(f"{cm}.Dense_{k}.bias", c.get(f"{cs}.{name}.bias"))
        c.put(f"{cm}.Conv_0.weight", c.get(f"{cs}.depthwise_conv.weight"))
        c.put(f"{cm}.Conv_0.bias", c.get(f"{cs}.depthwise_conv.bias"))
        c.norm(f"{cs}.norm", f"{cm}.LayerNorm_0")
    att = f"encoder.RWKVAttention_{i}"
    if c.owns(att):
        if c.owns(f"{att}.tmix_rev"):
            c.tmix(f"{src}.self_attn.rwkv_wrapper_forward.tmix_block",
                   f"{att}.tmix")
            c.tmix(f"{src}.self_attn.rwkv_wrapper_backward.tmix_block",
                   f"{att}.tmix_rev")
        else:
            c.tmix(f"{src}.self_attn.tmix_block", f"{att}.tmix")
    # mamba attention (the reference's self_attn.mamba; bi wraps two)
    att = f"encoder.MambaAttention_{i}"
    if c.owns(att):
        if c.owns(f"{att}.mamba_bwd"):
            c.mamba2(f"{src}.self_attn.mamba.mamba_forward",
                     f"{att}.mamba_fwd")
            c.mamba2(f"{src}.self_attn.mamba.mamba_backward",
                     f"{att}.mamba_bwd")
        else:
            c.mamba2(f"{src}.self_attn.mamba", f"{att}.mamba_fwd")
    # MHA / rel-pos MHA / limited-context (LCA) attention
    for cls in ("MultiHeadedAttention", "RelPositionMultiHeadedAttention",
                "LimitedRelPositionAttention"):
        att = f"encoder.{cls}_{i}"
        if not c.owns(att):
            continue
        for lin in ("linear_q", "linear_k", "linear_v", "linear_out",
                    "linear_pos"):
            if c.owns(f"{att}.{lin}") and c.has(
                    f"{src}.self_attn.{lin}.weight"):
                c.dense(f"{src}.self_attn.{lin}", f"{att}.{lin}")
        for pb in ("pos_bias_u", "pos_bias_v"):
            if f"{att}.{pb}" in c.out and c.has(f"{src}.self_attn.{pb}"):
                c.put(f"{att}.{pb}", c.get(f"{src}.self_attn.{pb}"))


def _decoder(c: _Converter) -> None:
    for side in ("left_decoder", "right_decoder"):
        dd = f"decoder.{side}"
        if not c.owns(dd) or not c.has(f"{dd}.embed.0.weight"):
            continue
        c.put(f"{dd}.embed.weight", c.get(f"{dd}.embed.0.weight"))
        c.norm(f"{dd}.after_norm", f"{dd}.after_norm")
        if c.owns(f"{dd}.output_layer"):
            c.dense(f"{dd}.output_layer", f"{dd}.output_layer")
        j = 0
        while c.owns(f"{dd}.layer_{j}"):
            src, dst = f"{dd}.decoders.{j}", f"{dd}.layer_{j}"
            for n in ("norm1", "norm2", "norm3"):
                c.norm(f"{src}.{n}", f"{dst}.{n}")
            for blk in ("self_attn", "src_attn"):
                for lin in ("linear_q", "linear_k", "linear_v",
                            "linear_out"):
                    c.dense(f"{src}.{blk}.{lin}", f"{dst}.{blk}.{lin}")
            c.dense(f"{src}.feed_forward.w_1", f"{dst}.feed_forward.Dense_0")
            c.dense(f"{src}.feed_forward.w_2", f"{dst}.feed_forward.Dense_1")
            j += 1


def _transducer(c: _Converter) -> None:
    if c.owns("predictor") and c.has("predictor.embed.weight"):
        c.put("predictor.embed.weight", c.get("predictor.embed.weight"))
        k = 0
        while c.owns(f"predictor.lstm_{k}"):
            c.put(f"predictor.lstm_{k}.ih.weight",
                  c.get(f"predictor.rnn.weight_ih_l{k}"))
            # one bias: bias_ih + bias_hh
            c.put(f"predictor.lstm_{k}.ih.bias",
                  c.get(f"predictor.rnn.bias_ih_l{k}")
                  + c.get(f"predictor.rnn.bias_hh_l{k}"))
            c.put(f"predictor.lstm_{k}.hh",
                  c.get(f"predictor.rnn.weight_hh_l{k}"))
            k += 1
        c.dense("predictor.projection", "predictor.projection")
    for n in ("enc_ffn", "pred_ffn", "post_ffn", "ffn_out"):
        if c.owns(f"joint.{n}") and c.has(f"joint.{n}.weight"):
            c.dense(f"joint.{n}", f"joint.{n}")


def convert_state_dict(sd: Mapping[str, Any],
                       state: Mapping[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    """``sd``: the reference's state_dict (tensors or arrays); ``state``: the
    port model's initialised state_dict.  Returns a new state_dict with
    every tensor the reference provides in place; logs the reference keys
    not read and the port's tensors not set."""
    c = _Converter(sd, state)
    _subsampling(c)
    i = 0
    while c.owns(f"encoder.layer_{i}"):
        _encoder_layer(c, i)
        i += 1
    if c.owns("encoder.after_norm"):
        c.norm("encoder.after_norm", "encoder.after_norm")
    if c.owns("ctc.ctc_lo") and c.has("ctc.ctc_lo.weight"):
        c.dense("ctc.ctc_lo", "ctc.ctc_lo")
    _decoder(c)
    _transducer(c)
    unread = sorted(set(sd) - c.read)
    unset = sorted(set(c.out) - c.set)
    if unread:
        log.info("reference keys not read (%d): %s", len(unread), unread)
    if unset:
        log.info("port parameters left at their init (%d): %s", len(unset),
                 unset)
    return c.out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="convert a WeNet checkpoint to "
                                            "the port's state_dict")
    p.add_argument("--checkpoint", required=True,
                   help="the reference's torch .pt file")
    p.add_argument("--config", required=True, help="the model's train.yaml")
    p.add_argument("--output", required=True,
                   help="the port's state_dict file (torch.save)")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    from paper_accurate_fast_cheap_tpu_torch.models import factory
    from paper_accurate_fast_cheap_tpu_torch.text.tokenizers import (
        init_tokenizer)
    from paper_accurate_fast_cheap_tpu_torch.utils.config import load_config

    config = load_config(args.config)
    input_dim = config.get("dataset_conf", {}).get("fbank_conf", {}).get(
        "num_mel_bins", 80)
    model, _ = factory.init_model(config, init_tokenizer(config).vocab_size(),
                                  input_dim, device="cpu")
    ckpt = torch.load(args.checkpoint, map_location="cpu", weights_only=True)
    sd = ckpt.get("model0", ckpt.get("state_dict", ckpt))
    torch.save(convert_state_dict(sd, model.state_dict()), args.output)
    log.info("wrote %s", args.output)
    return 0


if __name__ == "__main__":
    sys.exit(main())
