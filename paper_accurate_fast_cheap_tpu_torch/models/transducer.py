"""Transducer model: the decode surfaces of the JAX ``models/transducer.py``
(the combined training loss waits for the training slice)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from paper_accurate_fast_cheap_tpu_torch.models.conformer import (
    ConformerEncoder)
from paper_accurate_fast_cheap_tpu_torch.models.ctc_head import CTCHead
from paper_accurate_fast_cheap_tpu_torch.models.joint import TransducerJoint
from paper_accurate_fast_cheap_tpu_torch.models.predictor import RNNPredictor


class Transducer(nn.Module):
    def __init__(self, vocab_size: int, encoder_conf: dict,
                 predictor_conf: Optional[dict] = None,
                 joint_conf: Optional[dict] = None, blank_id: int = 0):
        super().__init__()
        enc_conf = dict(encoder_conf)
        pred_conf = dict(predictor_conf or {})
        joint_conf = dict(joint_conf or {})
        enc_dim = enc_conf.get("output_size", 512)
        joint_conf.setdefault("enc_output_size", enc_dim)
        joint_conf.setdefault("pred_output_size",
                              pred_conf.get("output_size", 640))
        self.vocab_size = vocab_size
        self.blank_id = blank_id
        self.encoder = ConformerEncoder(**enc_conf)
        self.predictor = RNNPredictor(vocab_size=vocab_size, **pred_conf)
        self.joint = TransducerJoint(vocab_size=vocab_size, **joint_conf)
        self.ctc = CTCHead(enc_dim, vocab_size)

    # ---- inference surfaces ----

    @torch.no_grad()
    def forward_encoder(self, feats: torch.Tensor, feat_lens: torch.Tensor):
        return self.encoder(feats, feat_lens)

    @torch.no_grad()
    def ctc_logprobs(self, enc_out: torch.Tensor):
        return self.ctc.log_probs(enc_out)

    def predictor_init_state(self, batch_size: int):
        return self.predictor.init_state(batch_size)

    @torch.no_grad()
    def predictor_step(self, tokens: torch.Tensor, state):
        """tokens (N,), state -> (pred_out (N, D), new_state)."""
        return self.predictor.forward_step(tokens, state)

    @torch.no_grad()
    def joint_step(self, enc_t: torch.Tensor, pred_out: torch.Tensor):
        """enc_t (N, De), pred_out (N, Dp) -> log-probs (N, V)."""
        return torch.log_softmax(self.joint.single_step(enc_t, pred_out), -1)

    @torch.no_grad()
    def joint_enc_proj(self, enc: torch.Tensor) -> torch.Tensor:
        return self.joint.project_enc(enc)

    @torch.no_grad()
    def joint_preact(self, enc_p_t: torch.Tensor, pred_out: torch.Tensor):
        return self.joint.preact(enc_p_t, pred_out)
