"""CTC head: projection to the vocabulary and the CTC loss (port of the JAX
``models/ctc_head.py``)."""
import torch
import torch.nn as nn
import torch.nn.functional as F

from paper_accurate_fast_cheap_tpu_torch.models.layers import dense


class CTCHead(nn.Module):
    def __init__(self, enc_dim: int, vocab_size: int):
        super().__init__()
        self.ctc_lo = nn.Linear(enc_dim, vocab_size)

    def forward(self, enc_out: torch.Tensor) -> torch.Tensor:
        return dense(self.ctc_lo, enc_out)

    def log_probs(self, enc_out: torch.Tensor) -> torch.Tensor:
        return torch.log_softmax(self(enc_out), dim=-1)


def ctc_loss(logits: torch.Tensor, logit_lengths: torch.Tensor,
             labels: torch.Tensor, label_lengths: torch.Tensor,
             blank_id: int = 0, use_focal_loss: bool = False,
             focal_alpha: float = 0.25,
             focal_gamma: float = 2.0) -> torch.Tensor:
    """The mean over the batch of the per-sequence CTC negative
    log-likelihood.  logits (B, T, V) unnormalised, in f32; labels (B, U),
    padded with anything past ``label_lengths``.  Focal reweighting
    ``alpha (1 - p)^gamma nll`` behind ``use_focal_loss``."""
    logp = torch.log_softmax(logits.float(), dim=-1).transpose(0, 1)
    per_seq = F.ctc_loss(logp, labels.long(), logit_lengths.long(),
                         label_lengths.long(), blank=blank_id,
                         reduction="none")
    if use_focal_loss:
        p = torch.exp(-per_seq)
        per_seq = focal_alpha * (1.0 - p) ** focal_gamma * per_seq
    return per_seq.mean()
