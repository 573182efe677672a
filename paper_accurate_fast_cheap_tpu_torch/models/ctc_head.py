"""CTC head: projection to the vocabulary (port of the JAX
``models/ctc_head.py``; the loss waits for the training slice)."""
import torch
import torch.nn as nn

from paper_accurate_fast_cheap_tpu_torch.models.layers import dense


class CTCHead(nn.Module):
    def __init__(self, enc_dim: int, vocab_size: int):
        super().__init__()
        self.ctc_lo = nn.Linear(enc_dim, vocab_size)

    def forward(self, enc_out: torch.Tensor) -> torch.Tensor:
        return dense(self.ctc_lo, enc_out)

    def log_probs(self, enc_out: torch.Tensor) -> torch.Tensor:
        return torch.log_softmax(self(enc_out), dim=-1)
