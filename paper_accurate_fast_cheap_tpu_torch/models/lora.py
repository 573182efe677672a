"""LoRA low-rank adaptation layers (port of the JAX ``models/lora.py``).

``LoRADense`` adds ``(dropout(x) @ lora_A @ lora_B) * alpha / r`` to a
``base`` Linear; ``LoRAEmbed`` adds ``(lora_A[ids] @ lora_B) * alpha / r``
to a ``base`` Embedding.  The factors keep flax's layout (A (in, r),
B (r, out)) and init (Dense: A ~ N(0, 0.01), B = 0; Embed: A = 0,
B ~ N(0, 0.01)).  ``merge_lora_params`` folds every group into its base
for export, with JAX's fixed scale.  (``encoder: lora_conformer`` builds
the plain conformer, as in JAX.)
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from paper_accurate_fast_cheap_tpu_torch.models.layers import dense, normal_

# the scale ``merge_lora_params`` folds with: the JAX function's fixed
# alpha / r = 16 / 8, whatever the layers' own alpha and r
MERGE_SCALE = 2.0


class LoRADense(nn.Module):
    def __init__(self, in_features: int, features: int, r: int = 8,
                 alpha: float = 16.0, use_bias: bool = True,
                 lora_dropout: float = 0.0):
        super().__init__()
        self.r = r
        self.base = nn.Linear(in_features, features, bias=use_bias)
        if r > 0:
            self.scale = alpha / r
            self.lora_A = nn.Parameter(torch.zeros(in_features, r))
            self.lora_B = nn.Parameter(torch.zeros(r, features))
        self.dropout = nn.Dropout(lora_dropout)

    def reset_parameters_from(self, g: torch.Generator) -> None:
        if self.r > 0:
            normal_(self.lora_A, 0.01, g)
            nn.init.zeros_(self.lora_B)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        base = dense(self.base, x)
        if self.r <= 0:
            return base
        h = self.dropout(x).to(base.dtype)
        return base + (h @ self.lora_A.to(base.dtype)
                       @ self.lora_B.to(base.dtype)) * self.scale


class LoRAEmbed(nn.Module):
    def __init__(self, num_embeddings: int, features: int, r: int = 8,
                 alpha: float = 16.0):
        super().__init__()
        self.r = r
        self.base = nn.Embedding(num_embeddings, features)
        if r > 0:
            self.scale = alpha / r
            self.lora_A = nn.Parameter(torch.zeros(num_embeddings, r))
            self.lora_B = nn.Parameter(torch.zeros(r, features))

    def reset_parameters_from(self, g: torch.Generator) -> None:
        if self.r > 0:
            nn.init.zeros_(self.lora_A)
            normal_(self.lora_B, 0.01, g)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        base = self.base(ids)
        if self.r <= 0:
            return base
        return base + (self.lora_A[ids] @ self.lora_B) * self.scale


def merge_lora_params(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``model``'s state_dict with every LoRA group folded: the base weight
    plus (A @ B) * ``MERGE_SCALE`` (transposed into a Linear's (out, in)
    layout), the factors zeroed.  The module is not changed."""
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    for name, m in model.named_modules():
        if not isinstance(m, (LoRADense, LoRAEmbed)) or m.r <= 0:
            continue
        p = f"{name}." if name else ""
        delta = (state[p + "lora_A"] @ state[p + "lora_B"]) * MERGE_SCALE
        if isinstance(m, LoRADense):
            delta = delta.T
        state[p + "base.weight"] = state[p + "base.weight"] + delta
        state[p + "lora_A"] = torch.zeros_like(state[p + "lora_A"])
        state[p + "lora_B"] = torch.zeros_like(state[p + "lora_B"])
    return state
