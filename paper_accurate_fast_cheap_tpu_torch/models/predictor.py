"""Transducer predictors (port of the JAX ``models/predictor.py``):
``RNNPredictor`` (LSTM), ``EmbeddingPredictor`` and ``ConvPredictor``.
As in JAX, only the LSTM has ``init_state``/``forward_step``: the other two
train through the transducer loss and no search can step them
(``NO_STEP``).

Decode: each step gathers the embeddings of the last tokens and runs every
LSTM layer and the output projection through K3 (``ops/lstm_step.py``), the
port of the fused predictor branch of the JAX device beam.  Training
(:meth:`RNNPredictor.forward`) runs the whole blank-prepended label
sequence: embed -> dropout -> LSTM stack (dropout between layers) ->
projection, each layer a plain time loop of the same gate math (the JAX
package runs it as ``lax.scan`` in XLA, not in its kernel).  Gate order is
i, f, g, o; ``ih`` carries the bias, ``hh`` none.  The state is f32 even
under bf16 weights, as ``init_state`` is in JAX.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from paper_accurate_fast_cheap_tpu_torch.models.layers import (
    conv, dense, layer_norm, normal_, orthogonal_)
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

    def forward(self, xs: torch.Tensor, h: torch.Tensor, c: torch.Tensor):
        """xs (B, U, E), h and c (B, H) -> outputs (B, U, H).  Dtypes
        promote as in flax: an f32 state over bf16 weights runs the
        recurrence in f32."""
        x_proj = dense(self.ih, xs)
        hh = self.hh.to(torch.promote_types(h.dtype, self.hh.dtype))
        outs = []
        for t in range(xs.shape[1]):
            gates = x_proj[:, t] + h @ hh.T
            i, f, g, o = gates.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            outs.append(h)
        return torch.stack(outs, dim=1)


class RNNPredictor(nn.Module):
    """embed -> dropout -> LSTM stack (dropout between layers) ->
    projection; dropout is active in ``.train()`` only."""

    def __init__(self, vocab_size: int, embed_size: int = 640,
                 hidden_size: int = 640, output_size: int = 640,
                 num_layers: int = 2, embed_dropout: float = 0.1,
                 dropout: float = 0.1):
        super().__init__()
        self.num_layers = num_layers
        self.hidden_size = hidden_size
        self.embed = nn.Embedding(vocab_size, embed_size)
        self.embed_dropout = nn.Dropout(embed_dropout)
        self.dropout = nn.Dropout(dropout)
        for i in range(num_layers):
            setattr(self, f"lstm_{i}", LSTMLayer(
                embed_size if i == 0 else hidden_size, hidden_size))
        self.projection = nn.Linear(hidden_size, output_size)

    def init_state(self, batch_size: int):
        z = torch.zeros(self.num_layers, batch_size, self.hidden_size,
                        device=self.projection.weight.device)
        return z, z.clone()

    def forward(self, ys: torch.Tensor) -> torch.Tensor:
        """Training forward: ys (B, U) token ids (blank-prepended) -> (B, U,
        output_size), from the zero state."""
        x = self.embed_dropout(self.embed(ys.long()))
        hs, cs = self.init_state(ys.shape[0])
        for i in range(self.num_layers):
            x = getattr(self, f"lstm_{i}")(x, hs[i], cs[i])
            if i < self.num_layers - 1:
                x = self.dropout(x)
        return dense(self.projection, x)

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


NO_STEP = ("the {} predictor has no init_state/forward_step (nor has the JAX "
           "one): it trains through the transducer loss, and no search can "
           "step it; decode with predictor: rnn")


class EmbeddingPredictor(nn.Module):
    """Stateless n-gram predictor: the last ``history_size + 1`` token
    embeddings (left-padded with zeros) weighted by ``pos_weight`` (n, E)
    and summed, then LayerNorm and ``projection``."""

    def __init__(self, vocab_size: int, embed_size: int = 640,
                 output_size: int = 640, history_size: int = 2,
                 embed_dropout: float = 0.1):
        super().__init__()
        self.n = history_size + 1
        self.embed = nn.Embedding(vocab_size, embed_size)
        self.embed_dropout = nn.Dropout(embed_dropout)
        self.pos_weight = nn.Parameter(torch.zeros(self.n, embed_size))
        self.LayerNorm_0 = nn.LayerNorm(embed_size, eps=1e-5)
        self.projection = nn.Linear(embed_size, output_size)

    def reset_parameters_from(self, g: torch.Generator) -> None:
        normal_(self.pos_weight, 1.0, g)

    def forward(self, ys: torch.Tensor) -> torch.Tensor:
        """ys (B, U) token ids (blank-prepended) -> (B, U, output_size)."""
        emb = self.embed_dropout(self.embed(ys.long()))
        padded = F.pad(emb, (0, 0, self.n - 1, 0))
        win = padded.unfold(1, self.n, 1)                 # (B, U, E, n)
        out = torch.einsum("buen,ne->bue", win,
                           self.pos_weight.to(win.dtype))
        return dense(self.projection, layer_norm(self.LayerNorm_0, out))


class ConvPredictor(nn.Module):
    """Causal conv over the token embeddings (width ``kernel_size``, left
    pad k - 1) -> LayerNorm -> ReLU."""

    def __init__(self, vocab_size: int, embed_size: int = 640,
                 output_size: int = 640, kernel_size: int = 3,
                 embed_dropout: float = 0.1):
        super().__init__()
        self.lorder = kernel_size - 1
        self.embed = nn.Embedding(vocab_size, embed_size)
        self.embed_dropout = nn.Dropout(embed_dropout)
        self.conv = nn.Conv1d(embed_size, output_size, kernel_size)
        self.LayerNorm_0 = nn.LayerNorm(output_size, eps=1e-5)

    def forward(self, ys: torch.Tensor) -> torch.Tensor:
        emb = self.embed_dropout(self.embed(ys.long()))
        y = F.pad(emb, (0, 0, self.lorder, 0)).transpose(1, 2)
        y = conv(self.conv, y).transpose(1, 2)
        return F.relu(layer_norm(self.LayerNorm_0, y))
