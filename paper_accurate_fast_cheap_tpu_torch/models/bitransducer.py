"""Bidirectional transducer (port of the JAX ``models/bitransducer.py``).

One encoder feeds two (predictor, joint) pairs: the left pair sees the
encoder output and the labels as they are, the right pair the encoder
output flipped in time within each utterance's valid prefix (padding 0)
and the labels reversed; the loss is ``0.7 * L + 0.3 * R``.  Both branches
run the chunked RNN-T loss of ``ops/rnnt.py`` (the joint recomputed in
T-chunks in the backward), so a functional train step binds its parameters
with ``train/train_step.bind_params``.  Submodules keep flax's names
(``predictor``, ``predictor_r``, ``joint``, ``joint_r``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from paper_accurate_fast_cheap_tpu_torch.models.encoder_registry import (
    build_encoder)
from paper_accurate_fast_cheap_tpu_torch.models.joint import TransducerJoint
from paper_accurate_fast_cheap_tpu_torch.models.transducer import (
    PREDICTORS, RNNT_T_CHUNK)
from paper_accurate_fast_cheap_tpu_torch.ops import rnnt
from paper_accurate_fast_cheap_tpu_torch.ops.common import (
    IGNORE_ID, add_blank, reverse_pad_list)


def reverse_features_pad_list(x: torch.Tensor,
                              lens: torch.Tensor) -> torch.Tensor:
    """Flip each (B, T, D) row's valid prefix in time; zero the padding."""
    T = x.shape[1]
    pos = torch.arange(T, device=x.device)[None, :]
    lens = lens.to(x.device).long()[:, None]
    idx = torch.clamp(lens - 1 - pos, 0, T - 1)
    rev = torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[2]))
    return torch.where((pos < lens)[..., None], rev, torch.zeros_like(rev))


class BiTransducer(nn.Module):
    """The dual RNN-T loss (no CTC or attention branch)."""

    def __init__(self, vocab_size: int, encoder_conf: dict,
                 encoder_type: str = "conformer", predictor: str = "rnn",
                 predictor_conf: Optional[dict] = None,
                 joint_conf: Optional[dict] = None, blank_id: int = 0,
                 weight_fwd: float = 0.7, weight_rev: float = 0.3,
                 ignore_id: int = IGNORE_ID,
                 rnnt_t_chunk: int = RNNT_T_CHUNK):
        super().__init__()
        enc_conf = dict(encoder_conf)
        pred_conf = dict(predictor_conf or {})
        joint_conf = dict(joint_conf or {})
        joint_conf.setdefault("enc_output_size",
                              enc_conf.get("output_size", 512))
        joint_conf.setdefault("pred_output_size",
                              pred_conf.get("output_size", 640))
        self.blank_id = blank_id
        self.weight_fwd = weight_fwd
        self.weight_rev = weight_rev
        self.ignore_id = ignore_id
        self.rnnt_t_chunk = rnnt_t_chunk
        self.encoder = build_encoder(encoder_type, enc_conf)
        self.predictor = PREDICTORS[predictor](vocab_size=vocab_size,
                                               **pred_conf)
        self.predictor_r = PREDICTORS[predictor](vocab_size=vocab_size,
                                                 **pred_conf)
        self.joint = TransducerJoint(vocab_size=vocab_size, **joint_conf)
        self.joint_r = TransducerJoint(vocab_size=vocab_size, **joint_conf)

    def _branch_loss(self, predictor, joint, enc, enc_lens, labels,
                     label_lens):
        pred_out = predictor(add_blank(labels, label_lens, self.blank_id))
        lab_lp, blank_lp = rnnt.gather_rnnt_logprobs_chunked(
            joint.project_enc(enc), joint.project_pred(pred_out), labels,
            joint.joint_projected, blank_id=self.blank_id,
            t_chunk=self.rnnt_t_chunk)
        return rnnt.rnnt_forward(lab_lp, blank_lp, enc_lens,
                                 label_lens).mean()

    def forward(self, feats, feat_lens, labels, label_lens):
        """{"loss", "loss_rnnt", "loss_rnnt_r"}; dropout follows
        ``.train()``/``.eval()``."""
        enc, enc_lens = self.encoder(feats, feat_lens)
        loss_l = self._branch_loss(self.predictor, self.joint, enc,
                                   enc_lens, labels, label_lens)
        enc_r = reverse_features_pad_list(enc, enc_lens)
        labels_r = reverse_pad_list(labels, label_lens, 0)
        loss_r = self._branch_loss(self.predictor_r, self.joint_r, enc_r,
                                   enc_lens, labels_r, label_lens)
        loss = self.weight_fwd * loss_l + self.weight_rev * loss_r
        return {"loss": loss, "loss_rnnt": loss_l, "loss_rnnt_r": loss_r}
