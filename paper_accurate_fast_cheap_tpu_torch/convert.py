"""Weight bridge from the JAX package's flax parameter tree.

The port names its submodules after the flax tree (``encoder.layer_{i}``,
``encoder.RWKVAttention_{i}.tmix``,
``encoder.RelPositionMultiHeadedAttention_{i}.linear_pos``,
``encoder.MambaAttention_{i}.mamba_fwd.in_proj``,
``predictor.lstm_{i}.ih``, ``joint.ffn_out``, ``joint.post_ffn``,
``decoder.left_decoder.layer_{i}.self_attn.linear_q``, ...) for the
``Transducer`` and ``ASRModel`` trees and those of the other families
(``BiTransducer``, ``ContextAdaptor``, ``CTLModel``, ``Paraformer``, the SSL
models, ``WhisperModel``), so the bridge only changes layouts:

* Dense ``kernel`` (in, out)          -> Linear ``weight`` (out, in)
* Conv ``kernel`` (kh, kw, in, out)   -> Conv2d ``weight`` (out, in, kh, kw)
* Conv ``kernel`` (k, in/groups, out) -> Conv1d ``weight`` (out, in/groups, k)
  (the Mamba-2 block's depthwise ``conv1d``: (K, 1, C) -> (C, 1, K))
* LayerNorm and gated RMSNorm ``scale``, Embed ``embedding`` -> ``weight``
* the LSTM recurrent matrix ``hh`` (H, 4H) -> (4H, H)

Biases, the rel-pos attention's ``pos_bias_u`` and ``pos_bias_v`` (H, d_k;
(H, d_k * g) in the grouped attention), the RWKV mixing parameters
(``time_*``), the Mamba-2 block's ``dt_bias``, ``A_log`` and ``D`` (H,),
the embedding predictor's ``pos_weight``, the MoE experts' ``w1`` and
``w2``, LoRA's ``lora_A`` and ``lora_B``, the learnable positions'
``pos_embedding``, the context adaptor's ``combine_weights``, Whisper's
``decoder_pos``, the SSL models' ``mask_emb`` and the product quantizer's
``codebook`` (groups, entries, dim / groups) keep their layout;
squeezeformer's ``ScaledResidual`` ``scale`` becomes ``weight``.  The
``batch_stats`` collection (the conv module's ``batch_norm``), given beside
``params``, maps ``mean`` and ``var`` to the BatchNorm's ``running_mean``
and ``running_var``.  A leaf of
any other name (a module the port does not have) raises KeyError.  WeNet
checkpoints load through ``tools/convert_checkpoint.py``.

``opt_state_from_jax`` carries the optax chain state of the JAX trainer
(``scale_by_adam``'s count and moments, the schedule's count) into the
port's ``TrainState.opt_state``, so a run resumed on each side from one
JAX checkpoint takes the same steps.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: str = ""):
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            yield from _flatten(v, name + ".")
        else:
            yield name, np.asarray(v)


# the leaves of the ported modules besides the RWKV's ``time_*``
_LEAVES = ("bias", "kernel", "scale", "embedding", "hh", "pos_bias_u",
           "pos_bias_v", "dt_bias", "A_log", "D", "pos_weight", "w1", "w2",
           "lora_A", "lora_B", "pos_embedding", "combine_weights",
           "decoder_pos", "mask_emb", "codebook")
# the batch_stats leaves and the BatchNorm buffers they fill
_STATS = {"mean": "running_mean", "var": "running_var"}


def state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """``params``: the flax tree as nested dicts of numpy arrays (with or
    without the outer ``{"params": ...}``, beside which a
    ``"batch_stats"`` collection may stand).  Returns the port's
    ``state_dict``, f32 (bf16 arrays are widened exactly)."""
    stats = {}
    if "params" in params and set(params) <= {"params", "batch_stats"}:
        stats = params.get("batch_stats", {})
        params = params["params"]
    out = {}
    for name, arr in _flatten(stats):
        parent, _, leaf = name.rpartition(".")
        if leaf not in _STATS:
            raise KeyError(f"state_dict_from_jax: flax batch_stats {name!r} "
                           "has no counterpart in the port")
        out[f"{parent}.{_STATS[leaf]}"] = torch.from_numpy(
            np.ascontiguousarray(arr.astype(np.float32)))
    for name, arr in _flatten(params):
        arr = arr.astype(np.float32)
        parent, _, leaf = name.rpartition(".")
        if not (leaf in _LEAVES or leaf.startswith("time_")):
            raise KeyError(f"state_dict_from_jax: flax parameter {name!r} "
                           "has no counterpart in the port")
        if leaf == "kernel":
            perm = {2: (1, 0), 3: (2, 1, 0), 4: (3, 2, 0, 1)}[arr.ndim]
            name, arr = f"{parent}.weight", arr.transpose(perm)
        elif leaf in ("scale", "embedding"):
            name = f"{parent}.weight"
        elif leaf == "hh":
            arr = arr.T
        out[name] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


_MHA = "encoder.RelPositionMultiHeadedAttention_"
_LCA = "encoder.LimitedRelPositionAttention_"


def as_limited_context(state: Mapping[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    """A rel-pos MHA model's state_dict under the names of its LCA twin
    (``LimitedRelPositionAttention`` has the rel-pos MHA's parameters), so
    an MHA checkpoint decodes with limited context."""
    return {k.replace(_MHA, _LCA, 1): v for k, v in state.items()}


def _optax_leaves(state) -> Iterable[Any]:
    """The named-tuple states inside an optax chain state (nested tuples)."""
    if hasattr(state, "_fields"):
        yield state
        for v in state:
            if isinstance(v, tuple):
                yield from _optax_leaves(v)
    elif isinstance(state, (tuple, list)):
        for v in state:
            yield from _optax_leaves(v)


def opt_state_from_jax(opt_state, names: Iterable[str]) -> Dict[str, Any]:
    """The JAX trainer's optax state -> the port's optimizer state
    ``{"count", "mu", "nu"}`` over the parameter ``names`` (the port's
    ``named_parameters``).  The moments follow their parameters' layout
    (``state_dict_from_jax``).  The port reads its schedule at the Adam
    count, so a schedule count that differs from it raises ValueError (the
    train step's skip rule freezes both together)."""
    adam = [s for s in _optax_leaves(opt_state)
            if {"count", "mu", "nu"} <= set(s._fields)]
    if len(adam) != 1:
        raise ValueError("expected one scale_by_adam state in the chain, "
                         f"found {len(adam)}")
    adam = adam[0]
    count = int(np.asarray(adam.count))
    for s in _optax_leaves(opt_state):
        if s is not adam and "count" in s._fields:
            if int(np.asarray(s.count)) != count:
                raise ValueError(
                    f"schedule count {int(np.asarray(s.count))} != adam "
                    f"count {count}")

    def moments(tree):
        sd = state_dict_from_jax(_as_numpy(tree))
        return {n: sd[n] for n in names}

    return {"count": count, "mu": moments(adam.mu), "nu": moments(adam.nu)}


def _as_numpy(tree):
    if isinstance(tree, Mapping):
        return {k: _as_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)
