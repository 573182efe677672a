"""The conformer encoder's blocks pipelined over a mesh axis, and the
trainer's loss around them (port of the JAX ``parallel/pp_encoder.py``).

* :func:`split_encoder_params` / :func:`merge_encoder_params`: the
  encoder's state dict (the port's names, relative to the encoder:
  ``layer_{i}.*`` and the attention ``RWKVAttention_{i}.*`` beside it, as
  in flax) <-> (the rest, the blocks stacked (S, L / S, ...) under
  ``layer.*`` and ``self_attn.*``), for checkpoint layouts.
* :func:`pp_encoder_forward`: subsampling and positions (the same on every
  rank), the blocks of this rank's stage through ``pipeline_apply`` with
  the masks microbatched beside the activations, the final norm; numerically
  the encoder's full-context forward.
* :func:`make_pp_loss_fn`: the trainer's loss with the encoder pipelined and
  ``loss_from_encoder`` (the post-encoder half of the model's forward);
  :func:`pp_grad_sync` sums the block gradients over the stages, which
  every rank's optimizer then applies to its whole copy of the parameters
  (the JAX trainer keeps them replicated too).

The pipelined blocks always run deterministic (no dropout): the tick loop
would need per-stage, per-microbatch draws to reproduce the sequential
masks.  The subsampling, positional encoding and the post-encoder half
keep their dropout in training.  Attention types whose forward depends on
the layer id (the direction-dropout RWKV's eval controls) are refused.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn as nn

from paper_accurate_fast_cheap_tpu_torch.parallel import collectives as cc
from paper_accurate_fast_cheap_tpu_torch.parallel.pipeline import (
    pipeline_apply)
from paper_accurate_fast_cheap_tpu_torch.utils.masks import make_pad_mask

_LAYER_ID_DEPENDENT = ("rwkv_tmix60_dir_layer_drop",
                       "rwkv_tmix60_dir_layer_drop_both")
_NON_BLOCK_KEYS = ("embed", "pos_enc", "after_norm", "global_cmvn")


def _attn_keys(names, num_blocks: int) -> List[str]:
    """The attention modules' prefixes (``<Class>_<i>``) in block order."""
    cand = sorted({n.split(".", 1)[0] for n in names
                   if not n.startswith("layer_")
                   and n.split(".", 1)[0] not in _NON_BLOCK_KEYS
                   and n.split(".", 1)[0].rsplit("_", 1)[-1].isdigit()},
                  key=lambda k: int(k.rsplit("_", 1)[1]))
    if len(cand) != num_blocks:
        raise ValueError(f"expected {num_blocks} attention modules, found "
                         f"{cand}: pp supports homogeneous (non-LSL) "
                         "encoders only")
    return cand


def split_encoder_params(enc_state: Dict[str, torch.Tensor], num_blocks: int,
                         n_stages: int):
    """(rest, stacked): ``stacked["layer.<name>"]`` and
    ``stacked["self_attn.<name>"]`` are (S, per, ...) tensors."""
    if num_blocks % n_stages:
        raise ValueError(f"{num_blocks} blocks not divisible by "
                         f"{n_stages} stages")
    per = num_blocks // n_stages
    akeys = _attn_keys(enc_state, num_blocks)
    blocks = []
    for i in range(num_blocks):
        blk = {}
        for prefix, tag in ((f"layer_{i}.", "layer."),
                            (f"{akeys[i]}.", "self_attn.")):
            blk.update({tag + n[len(prefix):]: t for n, t in enc_state.items()
                        if n.startswith(prefix)})
        blocks.append(blk)
    owned = tuple(f"layer_{i}." for i in range(num_blocks)) + tuple(
        f"{k}." for k in akeys)
    rest = {n: t for n, t in enc_state.items() if not n.startswith(owned)}
    stacked = {n: torch.stack([torch.stack([blocks[s * per + j][n]
                                            for j in range(per)])
                               for s in range(n_stages)])
               for n in blocks[0]}
    return rest, stacked


def merge_encoder_params(rest: Dict[str, torch.Tensor], stacked,
                         num_blocks: int, n_stages: int,
                         attn_base: str = "RWKVAttention"):
    """Inverse of :func:`split_encoder_params`."""
    per = num_blocks // n_stages
    out = dict(rest)
    for s in range(n_stages):
        for j in range(per):
            i = s * per + j
            for n, t in stacked.items():
                tag, name = n.split(".", 1)
                base = f"layer_{i}" if tag == "layer" else f"{attn_base}_{i}"
                out[f"{base}.{name}"] = t[s, j]
    return out


def _stage_blocks(encoder: nn.Module, axis: str):
    """[(layer, attention)] of this rank's stage, in order."""
    if encoder.attention_type in _LAYER_ID_DEPENDENT:
        raise ValueError(
            f"{encoder.attention_type} branches on layer id at eval time; "
            "pipeline stages share one layer program: use the "
            "bidirectional or uni variants for pp")
    S, s = cc.axis_size(axis), cc.axis_index(axis)
    L = encoder.num_blocks
    if L % S or None in encoder.block_attention:
        raise ValueError(f"{L} blocks not divisible by {S} stages, or "
                         "language-specific blocks (pp takes homogeneous "
                         "encoders only)")
    per = L // S
    return [(getattr(encoder, f"layer_{i}"),
             getattr(encoder, encoder.block_attention[i]))
            for i in range(s * per, (s + 1) * per)]


def pp_encoder_forward(encoder: nn.Module, feats: torch.Tensor,
                       lens: torch.Tensor, mesh, axis: str = "stage",
                       n_microbatches: int = None):
    """Features -> (encoder output, lengths) with the blocks of
    ``encoder`` (a ``ConformerEncoder``, the same weights on every rank)
    pipelined over ``mesh``'s axis ``axis``: this rank runs its stage's
    blocks.  The subsampling and positional dropout follow
    ``encoder.training``; the blocks run deterministic."""
    with mesh:
        blocks = _stage_blocks(encoder, axis)
    xs, out_lens = encoder.embed(feats, lens)
    out_lens = torch.clamp(out_lens, max=xs.shape[1])
    xs, pos_emb = encoder.pos_enc(xs)
    pad_mask = make_pad_mask(out_lens, xs.shape[1])
    modes = [(m, m.training) for blk in blocks for m in blk]
    for m, _ in modes:
        m.eval()

    def stage_fn(stage_blocks, x, extra):
        for layer, attn in stage_blocks:
            x = layer(x, attn, extra["att_mask"], pos_emb,
                      extra["pad_mask"], extra["lens"])
        return x

    extra = {"att_mask": pad_mask[:, None, :], "pad_mask": pad_mask,
             "lens": out_lens}
    xs = pipeline_apply(stage_fn, blocks, xs, mesh, axis=axis,
                        n_microbatches=n_microbatches, extra=extra)
    for m, mode in modes:
        m.train(mode)
    return encoder._after_norm(xs), out_lens


def make_pp_loss_fn(model: nn.Module, mesh, axis: str = "stage",
                    n_microbatches: int = None):
    """The trainer's loss, ``loss_fn(params, batch, seed) -> (loss,
    metrics)`` (``bin/train.py``'s form), with the encoder pipelined: the
    step's dropout seed, ``train_step.bind_params``, then
    :func:`pp_encoder_forward` and ``model.loss_from_encoder``."""
    from paper_accurate_fast_cheap_tpu_torch.train.train_step import (
        bind_params)

    def loss_fn(params, batch, seed):
        torch.manual_seed(seed)
        model.train()
        bind_params(model, params)
        feats, feat_lens, labels, label_lens = batch[:4]
        enc, enc_lens = pp_encoder_forward(
            model.encoder, feats, feat_lens, mesh, axis=axis,
            n_microbatches=n_microbatches)
        out = model.loss_from_encoder(enc, enc_lens, labels, label_lens)
        return out["loss"], {k: v.detach() for k, v in out.items()
                             if k != "loss"}

    return loss_fn


def block_param_names(model: nn.Module) -> Tuple[str, ...]:
    """The names of the encoder blocks' parameters in ``model``."""
    enc = model.encoder
    prefixes = tuple(f"encoder.layer_{i}." for i in range(enc.num_blocks)
                     ) + tuple(f"encoder.{n}." for n in enc.attention_names)
    return tuple(n for n, _ in model.named_parameters()
                 if n.startswith(prefixes))


def pp_grad_sync(model: nn.Module, mesh, axis: str = "stage"):
    """``grad_sync`` for ``train_step.make_train_step``: each block's
    gradient lives on its stage's rank (zeros elsewhere), so a sum over the
    stages gives every rank the whole gradient; the other parameters' are
    the same on every rank already (the frontend's through the pipeline
    input's ``pvary``, the post-encoder half's from the loss every rank
    repeats)."""
    names = block_param_names(model)

    def sync(grads: Dict[str, torch.Tensor], loss, metrics):
        with mesh:
            summed = cc.psum_tree({n: grads[n] for n in names}, axis)
        return dict(grads, **summed), loss, metrics

    return sync
