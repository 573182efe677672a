"""Hybrid CTC / attention ASR model (port of the JAX ``models/asr_model.py``,
the default ``model:`` of the configs).

The loss is ``ctc_weight * ctc + (1 - ctc_weight) * att``, the attention
branch on the (bi)transformer decoder with the reversed-label right decoder
weighted by ``reverse_weight``.  The encoder is any family of
``models/encoder_registry.py`` (``encoder_type``); ``cat_embs`` reaches its
language-specific blocks.  As in flax, the decoder's parameters exist only
when the loss calls it: a ``decoder_conf`` with ``ctc_weight < 1`` (and its
right half only for ``reverse_weight > 0``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from paper_accurate_fast_cheap_tpu_torch.models.ctc_head import (
    CTCHead, ctc_loss)
from paper_accurate_fast_cheap_tpu_torch.models.decoder import (
    BiTransformerDecoder, attention_loss)
from paper_accurate_fast_cheap_tpu_torch.models.encoder_registry import (
    build_encoder, forward_encoder)
from paper_accurate_fast_cheap_tpu_torch.ops.common import IGNORE_ID


class ASRModel(nn.Module):
    # maps a loss's count to the one this rank's shard stands for
    # (``ops/common.normaliser``; set by ``parallel/mesh.share_counts``)
    count_sync = None

    def __init__(self, vocab_size: int, encoder_conf: dict,
                 decoder_conf: Optional[dict] = None,
                 ctc_weight: float = 0.3, reverse_weight: float = 0.0,
                 lsm_weight: float = 0.1,
                 length_normalized_loss: bool = False,
                 sos: Optional[int] = None, eos: Optional[int] = None,
                 ignore_id: int = IGNORE_ID, use_focal_ctc: bool = False,
                 encoder_type: str = "conformer"):
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
        self.encoder = build_encoder(encoder_type, enc_conf)
        self.ctc = CTCHead(enc_dim, vocab_size)
        self.decoder = None
        if decoder_conf is not None and ctc_weight < 1.0:
            self.decoder = BiTransformerDecoder(
                vocab_size, enc_dim, **dict(decoder_conf),
                with_right=reverse_weight > 0.0)

    def forward(self, feats: torch.Tensor, feat_lens: torch.Tensor,
                labels: torch.Tensor, label_lens: torch.Tensor,
                cat_embs: Optional[torch.Tensor] = None):
        """{"loss", "loss_ctc", "loss_att", "th_accuracy"}; dropout follows
        ``.train()``/``.eval()``."""
        enc_kw = {} if cat_embs is None else {"cat_embs": cat_embs}
        enc, enc_lens = self.encoder(feats, feat_lens, **enc_kw)
        return self.loss_from_encoder(enc, enc_lens, labels, label_lens)

    def loss_from_encoder(self, enc: torch.Tensor, enc_lens: torch.Tensor,
                          labels: torch.Tensor, label_lens: torch.Tensor):
        """The post-encoder half of ``forward`` (JAX's
        ``loss_from_encoder``), for the pipelined trainer."""
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
                self.ignore_id, self.length_normalized_loss, self.count_sync)
        loss = self.ctc_weight * loss_ctc + (1.0 - self.ctc_weight) * loss_att
        return {"loss": loss, "loss_ctc": loss_ctc, "loss_att": loss_att,
                "th_accuracy": acc_att}

    # ---- inference surfaces ----

    @torch.no_grad()
    def forward_encoder(self, feats: torch.Tensor, feat_lens: torch.Tensor,
                        decoding_chunk_size: int = 0,
                        num_decoding_left_chunks: int = -1,
                        cat_embs: Optional[torch.Tensor] = None):
        return forward_encoder(self.encoder, feats, feat_lens,
                               decoding_chunk_size, num_decoding_left_chunks,
                               cat_embs)

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

    @torch.no_grad()
    def decoder_one_step_attn(self, enc, enc_lens, ys, ys_lens):
        """``decoder_one_step`` and the last decoder block's cross-attention
        at the last position, averaged over heads (B, T): the GNMT coverage
        scorer's step (``decode/search.make_gnmt_step_fn``)."""
        if self.decoder is None:
            raise ValueError("this model has no attention decoder")
        return self.decoder.forward_one_step(enc, enc_lens, ys, ys_lens,
                                             return_coverage=True)
