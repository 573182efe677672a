"""Transducer joint (port of the JAX ``models/joint.py``): add mode, the
``tanh``, ``relu`` or ``swish`` activation, the pre-join projections
``enc_ffn`` and ``pred_ffn`` (``prejoin_linear``) and the post-join
projection ``post_ffn`` (``postjoin_linear``, before the activation); the
standard ``ffn_out`` head or the HAT head of ``blank_pred`` and
``token_pred``.  As in JAX, ``joint_mode`` other than ``add`` is refused.

``joint_projected`` is the joint over already projected inputs, which the
chunked RNN-T loss calls per T-chunk (``ops/rnnt.py``)."""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from paper_accurate_fast_cheap_tpu_torch.models.layers import dense

ACTIVATIONS = {"tanh": torch.tanh, "relu": F.relu, "swish": F.silu}


class TransducerJoint(nn.Module):
    def __init__(self, vocab_size: int, enc_output_size: int = 512,
                 pred_output_size: int = 640, join_dim: int = 640,
                 prejoin_linear: bool = True, postjoin_linear: bool = False,
                 joint_mode: str = "add", activation: str = "tanh",
                 hat_joint: bool = False):
        super().__init__()
        if joint_mode != "add":
            raise ValueError(f"joint_mode {joint_mode!r}: only 'add' (as "
                             "the JAX joint asserts)")
        if activation not in ACTIVATIONS:
            raise ValueError(f"joint activation {activation!r} not in "
                             f"{sorted(ACTIVATIONS)}")
        if not prejoin_linear and enc_output_size != pred_output_size:
            raise ValueError(
                "prejoin_linear false adds the encoder and predictor "
                f"outputs directly: sizes {enc_output_size} and "
                f"{pred_output_size} differ")
        self.prejoin_linear = prejoin_linear
        self.postjoin_linear = postjoin_linear
        self.activation = activation
        self.hat_joint = hat_joint
        width = join_dim
        if prejoin_linear:
            self.enc_ffn = nn.Linear(enc_output_size, join_dim)
            self.pred_ffn = nn.Linear(pred_output_size, join_dim)
        else:
            width = enc_output_size
        if postjoin_linear:
            self.post_ffn = nn.Linear(width, join_dim)
            width = join_dim
        if hat_joint:
            self.blank_pred = nn.Linear(width, 1)
            self.token_pred = nn.Linear(width, vocab_size - 1)
        else:
            self.ffn_out = nn.Linear(width, vocab_size)

    def project_enc(self, enc: torch.Tensor) -> torch.Tensor:
        return dense(self.enc_ffn, enc) if self.prejoin_linear else enc

    def project_pred(self, pred: torch.Tensor) -> torch.Tensor:
        return dense(self.pred_ffn, pred) if self.prejoin_linear else pred

    def _join(self, enc_p: torch.Tensor, pred_p: torch.Tensor):
        """Add, ``post_ffn`` and the activation: the input of the head."""
        x = enc_p + pred_p
        if self.postjoin_linear:
            x = dense(self.post_ffn, x)
        return ACTIVATIONS[self.activation](x)

    def preact(self, enc_p: torch.Tensor, pred_u: torch.Tensor):
        """The activation fed to ``ffn_out``, from an already projected
        encoder frame (the beam hoists ``project_enc`` out of its loop)."""
        return self._join(enc_p, self.project_pred(pred_u))

    def single_step(self, enc_t: torch.Tensor, pred_u: torch.Tensor):
        """enc_t (B, De), pred_u (B, Dp) -> (B, V) logits (HAT: the
        blank log-probability, then the token log-probabilities)."""
        return self.joint_projected(self.project_enc(enc_t),
                                    self.project_pred(pred_u))

    def joint_projected(self, enc_p: torch.Tensor, pred_p: torch.Tensor):
        """The join and the vocabulary head over projected inputs that
        broadcast against each other (e.g. (B, T, 1, J) and (B, 1, U, J))."""
        x = self._join(enc_p, pred_p)
        if not self.hat_joint:
            return dense(self.ffn_out, x)
        blank_logp = F.logsigmoid(dense(self.blank_pred, x))
        token_logp = torch.log1p(-torch.exp(blank_logp)) + torch.log_softmax(
            dense(self.token_pred, x), dim=-1)
        return torch.cat([blank_logp, token_logp], dim=-1)
