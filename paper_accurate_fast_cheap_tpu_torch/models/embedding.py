"""Positional encodings (port of ``PositionalEncoding`` and
``RelPositionalEncoding`` of the JAX ``models/embedding.py``)."""
from __future__ import annotations

import math

import torch
import torch.nn as nn


def sinusoid_positions(offset: int, T: int, d_model: int,
                       device=None) -> torch.Tensor:
    """Rows [offset, offset+T) of the sinusoid table, f32 (T, d_model)."""
    pos = (float(offset) + torch.arange(T, dtype=torch.float32,
                                        device=device))[:, None]
    div = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32,
                                 device=device)
                    * -(math.log(10000.0) / d_model))
    ang = pos * div[None, :]
    pe = torch.zeros(T, d_model, dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(ang)
    pe[:, 1::2] = torch.cos(ang)
    return pe


class RelPositionalEncoding(nn.Module):
    """Transformer-XL style: scales x by sqrt(d) (in x's dtype) and returns
    the sinusoid table separately as (1, T, d); dropout on both."""

    def __init__(self, d_model: int, dropout_rate: float = 0.1):
        super().__init__()
        self.d_model = d_model
        self.dropout = nn.Dropout(dropout_rate)

    def forward(self, x: torch.Tensor, offset: int = 0):
        pos = sinusoid_positions(offset, x.shape[1], self.d_model,
                                 x.device)[None]
        scale = torch.sqrt(torch.tensor(float(self.d_model), dtype=x.dtype))
        return self.dropout(x * scale.to(x.device)), self.dropout(pos)


class PositionalEncoding(nn.Module):
    """Absolute sinusoidal encoding: returns (x * sqrt(d) + PE, PE), the
    scale in x's dtype and the table in f32 (so a bf16 x comes out f32, as
    in the JAX module); dropout on both outputs."""

    def __init__(self, d_model: int, dropout_rate: float = 0.1):
        super().__init__()
        self.d_model = d_model
        self.dropout = nn.Dropout(dropout_rate)

    def forward(self, x: torch.Tensor, offset: int = 0):
        pos = sinusoid_positions(offset, x.shape[1], self.d_model,
                                 x.device)[None]
        scale = torch.sqrt(torch.tensor(float(self.d_model), dtype=x.dtype))
        return (self.dropout(x * scale.to(x.device) + pos),
                self.dropout(pos))
