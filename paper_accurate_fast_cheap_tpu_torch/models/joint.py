"""Transducer joint (port of the JAX ``models/joint.py``: add mode, tanh,
pre-join projections, no post-join projection; the standard ``ffn_out``
head or the HAT head of ``blank_pred`` and ``token_pred``).

``joint_projected`` is the joint over already projected inputs, which the
chunked RNN-T loss calls per T-chunk (``ops/rnnt.py``)."""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from paper_accurate_fast_cheap_tpu_torch.models.layers import dense


class TransducerJoint(nn.Module):
    def __init__(self, vocab_size: int, enc_output_size: int = 512,
                 pred_output_size: int = 640, join_dim: int = 640,
                 prejoin_linear: bool = True, postjoin_linear: bool = False,
                 joint_mode: str = "add", activation: str = "tanh",
                 hat_joint: bool = False):
        super().__init__()
        if (not prejoin_linear or postjoin_linear or joint_mode != "add"
                or activation != "tanh"):
            raise NotImplementedError(
                "the port's joint is add-mode tanh with pre-join "
                "projections and no post-join projection")
        self.hat_joint = hat_joint
        self.enc_ffn = nn.Linear(enc_output_size, join_dim)
        self.pred_ffn = nn.Linear(pred_output_size, join_dim)
        if hat_joint:
            self.blank_pred = nn.Linear(join_dim, 1)
            self.token_pred = nn.Linear(join_dim, vocab_size - 1)
        else:
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
        """enc_t (B, De), pred_u (B, Dp) -> (B, V) logits (HAT: the
        blank log-probability, then the token log-probabilities)."""
        return self.joint_projected(self.project_enc(enc_t),
                                    self.project_pred(pred_u))

    def joint_projected(self, enc_p: torch.Tensor, pred_p: torch.Tensor):
        """Add, tanh and the vocabulary head over projected inputs that
        broadcast against each other (e.g. (B, T, 1, J) and (B, 1, U, J))."""
        x = torch.tanh(enc_p + pred_p)
        if not self.hat_joint:
            return dense(self.ffn_out, x)
        blank_logp = F.logsigmoid(dense(self.blank_pred, x))
        token_logp = torch.log1p(-torch.exp(blank_logp)) + torch.log_softmax(
            dense(self.token_pred, x), dim=-1)
        return torch.cat([blank_logp, token_logp], dim=-1)
