"""Transducer model (port of the JAX ``models/transducer.py``): the training
loss and the decode surfaces.

``forward`` is the combined loss ``transducer_weight * rnnt + ctc_weight *
ctc + attention_weight * att`` of the JAX ``loss_from_encoder``, with the
RNN-T lattice's joint computed in T-chunks of ``RNNT_T_CHUNK`` frames
(``ops/rnnt.py``) and the attention branch on the (bi)transformer decoder
(``models/decoder.py``).  As the flax model creates the decoder's
parameters only when its loss calls it, the decoder is built only for a
``decoder_conf`` with ``attention_weight > 0`` (its right half only for
``reverse_weight > 0``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from paper_accurate_fast_cheap_tpu_torch.models.conformer import (
    ConformerEncoder)
from paper_accurate_fast_cheap_tpu_torch.models.ctc_head import (
    CTCHead, ctc_loss)
from paper_accurate_fast_cheap_tpu_torch.models.decoder import (
    BiTransformerDecoder, attention_loss)
from paper_accurate_fast_cheap_tpu_torch.models.joint import TransducerJoint
from paper_accurate_fast_cheap_tpu_torch.models.predictor import RNNPredictor
from paper_accurate_fast_cheap_tpu_torch.ops import rnnt
from paper_accurate_fast_cheap_tpu_torch.ops.common import (
    IGNORE_ID, add_blank)

# encoder frames per chunk of the joint in the RNN-T loss (the JAX
# Transducer's rnnt_t_chunk)
RNNT_T_CHUNK = 16


class Transducer(nn.Module):
    def __init__(self, vocab_size: int, encoder_conf: dict,
                 predictor_conf: Optional[dict] = None,
                 joint_conf: Optional[dict] = None, blank_id: int = 0,
                 transducer_weight: float = 0.3, ctc_weight: float = 0.2,
                 attention_weight: float = 0.5,
                 decoder_conf: Optional[dict] = None,
                 reverse_weight: float = 0.3, lsm_weight: float = 0.1,
                 length_normalized_loss: bool = False,
                 sos: Optional[int] = None, eos: Optional[int] = None,
                 ignore_id: int = IGNORE_ID):
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
        self.transducer_weight = transducer_weight
        self.ctc_weight = ctc_weight
        self.attention_weight = attention_weight
        self.reverse_weight = reverse_weight
        self.lsm_weight = lsm_weight
        self.length_normalized_loss = length_normalized_loss
        self.sos = vocab_size - 1 if sos is None else sos
        self.eos = vocab_size - 1 if eos is None else eos
        self.ignore_id = ignore_id
        self.encoder = ConformerEncoder(**enc_conf)
        self.predictor = RNNPredictor(vocab_size=vocab_size, **pred_conf)
        self.joint = TransducerJoint(vocab_size=vocab_size, **joint_conf)
        self.ctc = CTCHead(enc_dim, vocab_size)
        self.decoder = None
        if decoder_conf is not None and attention_weight > 0.0:
            self.decoder = BiTransformerDecoder(
                vocab_size, enc_dim, **dict(decoder_conf),
                with_right=reverse_weight > 0.0)

    # ---- training ----

    def forward(self, feats: torch.Tensor, feat_lens: torch.Tensor,
                labels: torch.Tensor, label_lens: torch.Tensor):
        """The combined loss: {"loss", "loss_rnnt", "loss_ctc", "loss_att",
        "th_accuracy"}.  Dropout follows ``.train()``/``.eval()``."""
        enc, enc_lens = self.encoder(feats, feat_lens)
        ys_blank = add_blank(labels, label_lens, self.blank_id)
        pred_out = self.predictor(ys_blank)
        enc_p = self.joint.project_enc(enc)
        pred_p = self.joint.project_pred(pred_out)
        lab_lp, blank_lp = rnnt.gather_rnnt_logprobs_chunked(
            enc_p, pred_p, labels, self.joint.joint_projected,
            blank_id=self.blank_id, t_chunk=RNNT_T_CHUNK)
        loss_rnnt = rnnt.rnnt_forward(lab_lp, blank_lp, enc_lens,
                                      label_lens).mean()
        zero = torch.zeros((), device=enc.device)
        loss_ctc = zero
        if self.ctc_weight > 0.0:
            loss_ctc = ctc_loss(self.ctc(enc), enc_lens, labels, label_lens,
                                blank_id=self.blank_id)
        loss_att, acc_att = zero, zero
        if self.decoder is not None:
            loss_att, acc_att = self._att_loss(enc, enc_lens, labels,
                                               label_lens)
        loss = (self.transducer_weight * loss_rnnt
                + self.ctc_weight * loss_ctc
                + self.attention_weight * loss_att)
        return {"loss": loss, "loss_rnnt": loss_rnnt, "loss_ctc": loss_ctc,
                "loss_att": loss_att, "th_accuracy": acc_att}

    def _att_loss(self, enc, enc_lens, labels, label_lens):
        return attention_loss(self.decoder, enc, enc_lens, labels,
                              label_lens, self.sos, self.eos,
                              self.reverse_weight, self.lsm_weight,
                              self.ignore_id, self.length_normalized_loss)

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

    @torch.no_grad()
    def decoder_forward(self, enc, enc_lens, ys_in, ys_lens, r_ys_in,
                        reverse_weight: float):
        """(left logits, right logits) of the attention decoder (attention
        rescoring)."""
        if self.decoder is None:
            raise ValueError("this transducer has no attention decoder "
                             "(decoder: None or attention_weight 0)")
        return self.decoder(enc, enc_lens, ys_in, ys_lens, r_ys_in,
                            reverse_weight)
