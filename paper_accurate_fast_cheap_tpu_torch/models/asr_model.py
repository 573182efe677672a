"""Hybrid CTC / attention ASR model (port of the JAX ``models/asr_model.py``,
the default ``model:`` of the configs).

The loss is ``ctc_weight * ctc + (1 - ctc_weight) * att``, the attention
branch on the (bi)transformer decoder with the reversed-label right decoder
weighted by ``reverse_weight``.  The encoder is the conformer of the
flagship family (``models/factory.py`` refuses the other families, ROADMAP
Queue 1 item 12).  As in flax, the decoder's parameters exist only when the loss
calls it: a ``decoder_conf`` with ``ctc_weight < 1`` (and its right half
only for ``reverse_weight > 0``).
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
from paper_accurate_fast_cheap_tpu_torch.ops.common import IGNORE_ID


class ASRModel(nn.Module):
    def __init__(self, vocab_size: int, encoder_conf: dict,
                 decoder_conf: Optional[dict] = None,
                 ctc_weight: float = 0.3, reverse_weight: float = 0.0,
                 lsm_weight: float = 0.1,
                 length_normalized_loss: bool = False,
                 sos: Optional[int] = None, eos: Optional[int] = None,
                 ignore_id: int = IGNORE_ID, use_focal_ctc: bool = False):
        super().__init__()
        enc_conf = dict(encoder_conf)
        enc_dim = enc_conf.get("output_size", 512)
        self.vocab_size = vocab_size
        self.ctc_weight = ctc_weight
        self.reverse_weight = reverse_weight
        self.lsm_weight = lsm_weight
        self.length_normalized_loss = length_normalized_loss
        self.sos = vocab_size - 1 if sos is None else sos
        self.eos = vocab_size - 1 if eos is None else eos
        self.ignore_id = ignore_id
        self.use_focal_ctc = use_focal_ctc
        self.encoder = ConformerEncoder(**enc_conf)
        self.ctc = CTCHead(enc_dim, vocab_size)
        self.decoder = None
        if decoder_conf is not None and ctc_weight < 1.0:
            self.decoder = BiTransformerDecoder(
                vocab_size, enc_dim, **dict(decoder_conf),
                with_right=reverse_weight > 0.0)

    def forward(self, feats: torch.Tensor, feat_lens: torch.Tensor,
                labels: torch.Tensor, label_lens: torch.Tensor):
        """{"loss", "loss_ctc", "loss_att", "th_accuracy"}; dropout follows
        ``.train()``/``.eval()``."""
        enc, enc_lens = self.encoder(feats, feat_lens)
        zero = torch.zeros((), device=enc.device)
        loss_ctc = zero
        if self.ctc_weight > 0.0:
            loss_ctc = ctc_loss(self.ctc(enc), enc_lens, labels, label_lens,
                                use_focal_loss=self.use_focal_ctc)
        loss_att, acc_att = zero, zero
        if self.decoder is not None:
            loss_att, acc_att = attention_loss(
                self.decoder, enc, enc_lens, labels, label_lens, self.sos,
                self.eos, self.reverse_weight, self.lsm_weight,
                self.ignore_id, self.length_normalized_loss)
        loss = self.ctc_weight * loss_ctc + (1.0 - self.ctc_weight) * loss_att
        return {"loss": loss, "loss_ctc": loss_ctc, "loss_att": loss_att,
                "th_accuracy": acc_att}

    # ---- inference surfaces ----

    @torch.no_grad()
    def forward_encoder(self, feats: torch.Tensor, feat_lens: torch.Tensor):
        return self.encoder(feats, feat_lens)

    @torch.no_grad()
    def ctc_logprobs(self, enc_out: torch.Tensor):
        return self.ctc.log_probs(enc_out)

    @torch.no_grad()
    def decoder_forward(self, enc, enc_lens, ys_in, ys_lens, r_ys_in,
                        reverse_weight: float):
        if self.decoder is None:
            raise ValueError("this model has no attention decoder")
        return self.decoder(enc, enc_lens, ys_in, ys_lens, r_ys_in,
                            reverse_weight)

    @torch.no_grad()
    def decoder_one_step(self, enc, enc_lens, ys, ys_lens):
        """Log-probs (B, V) of the left decoder at position ys_lens - 1."""
        if self.decoder is None:
            raise ValueError("this model has no attention decoder")
        return self.decoder.forward_one_step(enc, enc_lens, ys, ys_lens)
