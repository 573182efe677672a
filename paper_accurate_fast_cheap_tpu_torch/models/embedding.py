"""Positional encodings (port of ``PositionalEncoding``,
``RelPositionalEncoding``, ``NoPositionalEncoding`` and
``LearnablePositionalEncoding`` and ``WhisperPositionalEncoding`` of the JAX
``models/embedding.py``)."""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn

from paper_accurate_fast_cheap_tpu_torch.models.layers import normal_


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


def sinusoid_table(max_len: int, d_model: int) -> np.ndarray:
    """The sinusoid table (max_len, d_model) computed in float64 on the host
    and stored f32, as the JAX package's ``sinusoid_table`` (Whisper's
    positions)."""
    position = np.arange(max_len, dtype=np.float64)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float64)
                      * -(np.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), np.float64)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe.astype(np.float32)


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


class NoPositionalEncoding(nn.Module):
    """No positions: returns (dropout(x), zeros (1, T, d) in x's dtype); x is
    not scaled, as in the JAX module."""

    def __init__(self, d_model: int, dropout_rate: float = 0.1):
        super().__init__()
        self.d_model = d_model
        self.dropout = nn.Dropout(dropout_rate)

    def forward(self, x: torch.Tensor, offset: int = 0):
        return self.dropout(x), x.new_zeros(1, x.shape[1], self.d_model)


class LearnablePositionalEncoding(nn.Module):
    """Trained absolute positions: returns (x * sqrt(d) + P[offset:offset+T],
    that slice as (1, T, d)); ``pos_embedding`` (max_len, d) starts as
    N(0, 0.02), flax's init; dropout on the first output only."""

    def __init__(self, d_model: int, dropout_rate: float = 0.1,
                 max_len: int = 5000):
        super().__init__()
        self.d_model = d_model
        self.pos_embedding = nn.Parameter(torch.zeros(max_len, d_model))
        self.dropout = nn.Dropout(dropout_rate)

    def reset_parameters_from(self, g: torch.Generator) -> None:
        normal_(self.pos_embedding, 0.02, g)

    def forward(self, x: torch.Tensor, offset: int = 0):
        pos = self.pos_embedding[None, offset: offset + x.shape[1]]
        scale = torch.sqrt(torch.tensor(float(self.d_model), dtype=x.dtype))
        return self.dropout(x * scale.to(x.device) + pos), pos


class WhisperPositionalEncoding(nn.Module):
    """Whisper's: x + the sinusoid table (``sinusoid_table``), x not scaled;
    returns (dropout(x + P[offset:offset+T]), that slice as (1, T, d))."""

    def __init__(self, d_model: int, dropout_rate: float = 0.1,
                 max_len: int = 1500):
        super().__init__()
        self.d_model = d_model
        self.register_buffer("pe", torch.from_numpy(
            sinusoid_table(max_len, d_model)), persistent=False)
        self.dropout = nn.Dropout(dropout_rate)

    def forward(self, x: torch.Tensor, offset: int = 0):
        pos = self.pe[None, offset: offset + x.shape[1]]
        return self.dropout(x + pos), pos
