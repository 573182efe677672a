"""Weight bridge from the JAX package's flax parameter tree.

The port names its submodules after the flax tree (``encoder.layer_{i}``,
``encoder.RWKVAttention_{i}.tmix``, ``predictor.lstm_{i}.ih``,
``joint.ffn_out``, ``decoder.left_decoder.layer_{i}.self_attn.linear_q``,
...) for the ``Transducer`` and ``ASRModel`` trees, so the bridge only
changes layouts:

* Dense ``kernel`` (in, out)          -> Linear ``weight`` (out, in)
* Conv ``kernel`` (kh, kw, in, out)   -> Conv2d ``weight`` (out, in, kh, kw)
* Conv ``kernel`` (k, in/groups, out) -> Conv1d ``weight`` (out, in/groups, k)
* LayerNorm ``scale`` and Embed ``embedding`` -> ``weight``
* the LSTM recurrent matrix ``hh`` (H, 4H) -> (4H, H)

Biases and the RWKV mixing parameters (``time_*``) keep their layout.  A
leaf of any other name (a module the port does not have) raises KeyError.
Loading WeNet checkpoints waits for the slice that ports
``tools/convert_checkpoint.py``.
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
_LEAVES = ("bias", "kernel", "scale", "embedding", "hh")


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
