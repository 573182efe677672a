"""LSTM transducer predictor (port of the JAX ``models/predictor.py``
``RNNPredictor`` decode surface).

Each step gathers the embeddings of the last tokens and runs every LSTM
layer and the output projection through K3 (``ops/lstm_step.py``), the
port of the fused predictor branch of the JAX device beam.  Gate order is
i, f, g, o; ``ih`` carries the bias, ``hh`` none.  The state is f32 even
under bf16 weights, as ``init_state`` is in JAX.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from paper_accurate_fast_cheap_tpu_torch.models.layers import orthogonal_
from paper_accurate_fast_cheap_tpu_torch.ops.lstm_step import (
    lstm_predictor_step)


class LSTMLayer(nn.Module):
    """Parameters of one layer: ``ih`` (Linear, with bias) and ``hh``
    (4H, H), both in nn.Linear layout."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.ih = nn.Linear(input_size, 4 * hidden_size)
        self.hh = nn.Parameter(torch.zeros(4 * hidden_size, hidden_size))

    def reset_parameters_from(self, g: torch.Generator) -> None:
        orthogonal_(self.hh, g)


class RNNPredictor(nn.Module):
    """embed -> LSTM stack -> projection (dropout is a training concern)."""

    def __init__(self, vocab_size: int, embed_size: int = 640,
                 hidden_size: int = 640, output_size: int = 640,
                 num_layers: int = 2):
        super().__init__()
        self.num_layers = num_layers
        self.hidden_size = hidden_size
        self.embed = nn.Embedding(vocab_size, embed_size)
        for i in range(num_layers):
            setattr(self, f"lstm_{i}", LSTMLayer(
                embed_size if i == 0 else hidden_size, hidden_size))
        self.projection = nn.Linear(hidden_size, output_size)

    def init_state(self, batch_size: int):
        z = torch.zeros(self.num_layers, batch_size, self.hidden_size,
                        device=self.projection.weight.device)
        return z, z.clone()

    def forward_step(self, ys_last: torch.Tensor, state):
        """ys_last (B,), state (hs, cs) (L, B, H) -> (out (B, O), state)."""
        x = self.embed.weight[ys_last.long()]
        layers = [(getattr(self, f"lstm_{i}").ih.weight,
                   getattr(self, f"lstm_{i}").ih.bias,
                   getattr(self, f"lstm_{i}").hh)
                  for i in range(self.num_layers)]
        out, hs, cs = lstm_predictor_step(
            x, state[0], state[1], layers, self.projection.weight,
            self.projection.bias)
        return out, (hs, cs)
