"""CTL: full-context and chunk-masked views of one utterance, with a
contrastive term (port of the JAX ``models/ctl_model.py``).

The utterance runs through the shared encoder twice, full context and
with ``decoding_chunk_size = chunk_size`` (``utils/masks`` chunk masks);
each view pays the ``ASRModel`` CTC/attention loss, and an InfoNCE term
pulls the chunked frames toward the full-context ones (the target
detached), against ``n_negatives`` frames of the same utterance at random
offsets (a negative equal to the positive masked to -inf):

    loss = loss_full + loss_chunk + ctl_weight * CTL(chunk, full, negs)

The offsets are a draw: in training from ``draw_negative_offsets`` on the
model's ``neg_generator`` (seeded 0 at first use); in evaluation from JAX's
fixed ``PRNGKey(0)`` (``utils/jax_prng``), part of the model as in JAX.
The recurrent encoders never read the chunk mask, so on the bi-RWKV
flagship the chunked view equals the full one, in JAX too.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from paper_accurate_fast_cheap_tpu_torch.models.asr_model import ASRModel
from paper_accurate_fast_cheap_tpu_torch.models.ctc_head import ctc_loss
from paper_accurate_fast_cheap_tpu_torch.models.decoder import attention_loss
from paper_accurate_fast_cheap_tpu_torch.ops.common import (
    cosine, normaliser)
from paper_accurate_fast_cheap_tpu_torch.utils import jax_prng
from paper_accurate_fast_cheap_tpu_torch.utils.masks import make_pad_mask


def draw_negative_offsets(shape: Tuple[int, ...], lo: int, hi: int,
                          generator: torch.Generator) -> torch.Tensor:
    """Training negatives: offsets uniform in [lo, hi), on the host."""
    return torch.randint(lo, hi, shape, generator=generator)


class CTLModel(nn.Module):
    # maps a loss's count to the one this rank's shard stands for
    # (``ops/common.normaliser``; set by ``parallel/mesh.share_counts``)
    count_sync = None

    def __init__(self, asr_conf: dict, ctl_weight: float = 1.0,
                 n_negatives: int = 50, logit_temp: float = 0.1,
                 chunk_size: int = 16, temperature: float = 0.1):
        super().__init__()
        self.asr = ASRModel(**dict(asr_conf))
        self.ctl_weight = ctl_weight
        self.n_negatives = n_negatives
        self.logit_temp = logit_temp
        self.chunk_size = chunk_size
        self.temperature = temperature   # JAX's alias, kept for configs
        self.neg_generator: Optional[torch.Generator] = None

    def _view_loss(self, enc, enc_lens, labels, label_lens):
        m = self.asr
        zero = torch.zeros((), device=enc.device)
        loss_ctc = zero
        if m.ctc_weight > 0.0:
            loss_ctc = ctc_loss(m.ctc(enc), enc_lens, labels, label_lens)
        loss_att, acc = zero, zero
        if m.decoder is not None:
            loss_att, acc = attention_loss(
                m.decoder, enc, enc_lens, labels, label_lens, m.sos, m.eos,
                m.reverse_weight, m.lsm_weight, m.ignore_id,
                m.length_normalized_loss, self.count_sync)
        return m.ctc_weight * loss_ctc + (1.0 - m.ctc_weight) * loss_att, acc

    def _offsets(self, shape, hi: int) -> torch.Tensor:
        if self.training:
            if self.neg_generator is None:
                self.neg_generator = torch.Generator().manual_seed(0)
            return draw_negative_offsets(shape, 1, hi, self.neg_generator)
        return torch.from_numpy(jax_prng.randint(jax_prng.key(0), shape, 1,
                                                 hi))

    def _ctl(self, x, y, valid, offs):
        """InfoNCE over the valid frames; ``offs`` (B, T, K)."""
        B, T, _ = x.shape
        idx = (torch.arange(T, device=x.device)[None, :, None]
               + offs.to(x.device).long()) % max(T, 1)
        negs = y[torch.arange(B, device=x.device)[:, None, None], idx]
        pos = cosine(x, y) / self.logit_temp
        neg = cosine(x[:, :, None], negs) / self.logit_temp
        same = ((negs - y[:, :, None]).abs() < 1e-12).all(-1)
        neg = neg.masked_fill(same, float("-inf"))
        logits = torch.cat([pos[..., None], neg], dim=-1)
        logp = torch.log_softmax(logits, dim=-1)[..., 0]
        logp = torch.where(valid, logp, torch.zeros((), device=x.device))
        return -logp.sum() / normaliser(valid.sum(), self.count_sync)

    def forward(self, feats, feat_lens, labels, label_lens):
        enc_full, lens_full = self.asr.encoder(feats, feat_lens)
        loss_full, acc_full = self._view_loss(enc_full, lens_full, labels,
                                              label_lens)
        enc_chunk, lens_chunk = self.asr.encoder(feats, feat_lens,
                                                 self.chunk_size)
        loss_chunk, acc_chunk = self._view_loss(enc_chunk, lens_chunk,
                                                labels, label_lens)
        loss_ctl = torch.zeros((), device=feats.device)
        if self.ctl_weight > 0 and self.n_negatives > 0:
            B, T = enc_chunk.shape[:2]
            valid = make_pad_mask(lens_chunk, T)
            offs = self._offsets((B, T, self.n_negatives), max(T - 1, 2))
            loss_ctl = self._ctl(enc_chunk, enc_full.detach(), valid, offs)
        loss = loss_full + loss_chunk + self.ctl_weight * loss_ctl
        return {"loss": loss, "loss_full": loss_full,
                "loss_chunk": loss_chunk, "loss_ctl": loss_ctl,
                "th_accuracy": acc_full, "chunk_th_accuracy": acc_chunk}
