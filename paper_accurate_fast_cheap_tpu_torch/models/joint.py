"""Transducer joint (port of the JAX ``models/joint.py``: add mode, tanh,
pre-join projections, no post-join projection, non-HAT)."""
from __future__ import annotations

import torch
import torch.nn as nn

from paper_accurate_fast_cheap_tpu_torch.models.layers import dense


class TransducerJoint(nn.Module):
    def __init__(self, vocab_size: int, enc_output_size: int = 512,
                 pred_output_size: int = 640, join_dim: int = 640,
                 prejoin_linear: bool = True, postjoin_linear: bool = False,
                 joint_mode: str = "add", activation: str = "tanh",
                 hat_joint: bool = False):
        super().__init__()
        if (not prejoin_linear or postjoin_linear or joint_mode != "add"
                or activation != "tanh" or hat_joint):
            raise NotImplementedError(
                "the port's joint is add-mode tanh with pre-join "
                "projections, no post-join projection, non-HAT")
        self.enc_ffn = nn.Linear(enc_output_size, join_dim)
        self.pred_ffn = nn.Linear(pred_output_size, join_dim)
        self.ffn_out = nn.Linear(join_dim, vocab_size)

    def project_enc(self, enc: torch.Tensor) -> torch.Tensor:
        return dense(self.enc_ffn, enc)

    def project_pred(self, pred: torch.Tensor) -> torch.Tensor:
        return dense(self.pred_ffn, pred)

    def preact(self, enc_p: torch.Tensor, pred_u: torch.Tensor):
        """The activation fed to ``ffn_out``, from an already projected
        encoder frame (the beam hoists ``project_enc`` out of its loop)."""
        return torch.tanh(enc_p + self.project_pred(pred_u))

    def single_step(self, enc_t: torch.Tensor, pred_u: torch.Tensor):
        """enc_t (B, De), pred_u (B, Dp) -> (B, V) logits."""
        return dense(self.ffn_out, self.preact(self.project_enc(enc_t),
                                               pred_u))
