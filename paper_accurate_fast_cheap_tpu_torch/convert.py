"""Weight bridge from the JAX package's flax parameter tree.

The port names its submodules after the flax tree (``encoder.layer_{i}``,
``encoder.RWKVAttention_{i}.tmix``,
``encoder.RelPositionMultiHeadedAttention_{i}.linear_pos``,
``encoder.MambaAttention_{i}.mamba_fwd.in_proj``,
``predictor.lstm_{i}.ih``, ``joint.ffn_out``,
``decoder.left_decoder.layer_{i}.self_attn.linear_q``, ...) for the
``Transducer`` and ``ASRModel`` trees, so the bridge only changes layouts:

* Dense ``kernel`` (in, out)          -> Linear ``weight`` (out, in)
* Conv ``kernel`` (kh, kw, in, out)   -> Conv2d ``weight`` (out, in, kh, kw)
* Conv ``kernel`` (k, in/groups, out) -> Conv1d ``weight`` (out, in/groups, k)
  (the Mamba-2 block's depthwise ``conv1d``: (K, 1, C) -> (C, 1, K))
* LayerNorm and gated RMSNorm ``scale``, Embed ``embedding`` -> ``weight``
* the LSTM recurrent matrix ``hh`` (H, 4H) -> (4H, H)

Biases, the rel-pos attention's ``pos_bias_u`` and ``pos_bias_v`` (H, d_k),
the RWKV mixing parameters (``time_*``) and the Mamba-2 block's
``dt_bias``, ``A_log`` and ``D`` (H,) keep their layout.  A leaf of
any other name (a module the port does not have) raises KeyError.  WeNet
checkpoints load through ``tools/convert_checkpoint.py``.
"""
from __future__ import annotations

from typing import Dict, Mapping

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
           "pos_bias_v", "dt_bias", "A_log", "D")


def state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """``params``: the flax tree as nested dicts of numpy arrays (with or
    without the outer ``{"params": ...}``).  Returns the port's
    ``state_dict``, f32 (bf16 arrays are widened exactly)."""
    if set(params) == {"params"}:
        params = params["params"]
    out = {}
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
