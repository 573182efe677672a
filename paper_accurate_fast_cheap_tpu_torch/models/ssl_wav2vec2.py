"""wav2vec2-style contrastive self-supervised pretraining (port of the JAX
``models/ssl_wav2vec2.py``).

The clean features run through the encoder (dropout off); a Gumbel-softmax
product quantizer of the detached output gives the targets.  Spans of
encoder frames are replaced by a learned ``mask_emb``, projected
(``ctx_proj``), and each masked frame is scored by InfoNCE against its
target and ``num_negatives`` targets of the same utterance at shared random
offsets, plus a codebook-diversity term.

The three draws of a step (the span starts, the Gumbel uniforms, the
negative offsets) are host functions of a ``torch.Generator``
(``draw_span_starts``, ``draw_gumbel_uniform``, ``draw_negative_offsets``;
the model's ``generator``, seeded 0 at first use, unless the caller passes
one); w2v-BERT draws through the same functions.  Submodules keep flax's
names (``ctx_proj``, ``tgt_proj``, ``quantizer.proj``,
``quantizer.codebook``, ``mask_emb``).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn

from paper_accurate_fast_cheap_tpu_torch.models.encoder_registry import (
    build_encoder, eval_forward)
from paper_accurate_fast_cheap_tpu_torch.models.layers import dense, normal_
from paper_accurate_fast_cheap_tpu_torch.ops.common import (
    cosine, normaliser)
from paper_accurate_fast_cheap_tpu_torch.utils.masks import make_pad_mask


def draw_span_starts(shape: Tuple[int, ...], prob: float,
                     generator: torch.Generator) -> torch.Tensor:
    """Bernoulli(prob) span starts, bool, on the host."""
    return torch.rand(shape, generator=generator) < prob


def draw_gumbel_uniform(shape: Tuple[int, ...],
                        generator: torch.Generator) -> torch.Tensor:
    """The Gumbel noise's uniforms in [1e-6, 1 - 1e-6), on the host."""
    return 1e-6 + (1.0 - 2e-6) * torch.rand(shape, generator=generator)


def draw_negative_offsets(n: int, lo: int, hi: int,
                          generator: torch.Generator) -> torch.Tensor:
    """``n`` negative offsets uniform in [lo, hi), shared by every frame."""
    return torch.randint(lo, hi, (n,), generator=generator)


def span_mask(starts: torch.Tensor, mask_length: int) -> torch.Tensor:
    """Each start masks itself and the next ``mask_length - 1`` frames."""
    m = starts
    for i in range(1, mask_length):
        m = m | torch.nn.functional.pad(starts, (i, 0))[:, :starts.shape[1]]
    return m


def negatives(targets: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """targets (B, T, P), offsets (K,) -> (B, T, K, P): frame t's k-th
    negative is frame (t + offs[k]) mod T."""
    B, T = targets.shape[:2]
    dev = targets.device
    idx = (torch.arange(T, device=dev)[None, :, None]
           + offs.to(dev).long()[None, None, :]) % max(T, 1)
    return targets[torch.arange(B, device=dev)[:, None, None], idx]


def info_nce(context, targets, offs, mask, temperature: float,
             count_sync=None):
    """InfoNCE over the masked frames: (loss, accuracy); ``count_sync``:
    ``ops/common.normaliser``'s."""
    negs = negatives(targets, offs)
    pos = cosine(context, targets) / temperature
    neg = cosine(context[:, :, None], negs) / temperature
    logits = torch.cat([pos[..., None], neg], dim=-1)
    logp = torch.log_softmax(logits, dim=-1)[..., 0]
    denom = normaliser(mask.sum(), count_sync)
    zero = torch.zeros((), dtype=logp.dtype, device=logp.device)
    loss = -torch.where(mask, logp, zero).sum() / denom
    acc = (mask & (logits.argmax(-1) == 0)).sum() / denom
    return loss, acc


class ProductQuantizer(nn.Module):
    """Gumbel-softmax product quantizer (``groups`` x ``entries``), a
    straight-through one-hot when ``hard``."""

    def __init__(self, in_dim: int, groups: int = 2, entries: int = 320,
                 dim: int = 256):
        super().__init__()
        self.groups, self.entries, self.dim = groups, entries, dim
        self.proj = nn.Linear(in_dim, groups * entries)
        self.codebook = nn.Parameter(torch.zeros(groups, entries,
                                                 dim // groups))

    def reset_parameters_from(self, g: torch.Generator) -> None:
        normal_(self.codebook, 0.02, g)

    def forward(self, x, generator: torch.Generator,
                temperature: float = 2.0, hard: bool = True,
                return_ids: bool = False):
        B, T, _ = x.shape
        logits = dense(self.proj, x).reshape(B, T, self.groups,
                                             self.entries)
        u = draw_gumbel_uniform(tuple(logits.shape), generator).to(
            logits.device)
        y_soft = torch.softmax((logits - torch.log(-torch.log(u)))
                               / temperature, dim=-1)
        if hard:
            y_hard = torch.nn.functional.one_hot(
                y_soft.argmax(-1), self.entries).to(y_soft.dtype)
            y = y_hard + y_soft - y_soft.detach()
        else:
            y = y_soft
        q = torch.einsum("btge,ged->btgd", y, self.codebook.to(y.dtype))
        q = q.reshape(B, T, self.dim)
        probs = torch.softmax(logits, dim=-1).mean(dim=(0, 1))
        entropy = -(probs * torch.log(probs + 1e-8)).sum(-1)
        diversity = 1.0 - entropy.mean() / math.log(self.entries)
        if return_ids:
            # codebook ids (B, T, groups): w2v-BERT's MLM targets
            return q, diversity, logits.argmax(-1)
        return q, diversity


class Wav2Vec2Model(nn.Module):
    # maps a loss's count to the one this rank's shard stands for
    # (``ops/common.normaliser``; set by ``parallel/mesh.share_counts``)
    count_sync = None

    def __init__(self, encoder_conf: dict, encoder_type: str = "conformer",
                 proj_dim: int = 256, num_negatives: int = 50,
                 mask_prob: float = 0.065, mask_length: int = 10,
                 temperature: float = 0.1, diversity_weight: float = 0.1):
        super().__init__()
        d = dict(encoder_conf).get("output_size", 256)
        self.num_negatives = num_negatives
        self.mask_prob = mask_prob
        self.mask_length = mask_length
        self.temperature = temperature
        self.diversity_weight = diversity_weight
        self.generator: Optional[torch.Generator] = None
        self.encoder = build_encoder(encoder_type, dict(encoder_conf))
        self.ctx_proj = nn.Linear(d, proj_dim)
        self.tgt_proj = nn.Linear(proj_dim, proj_dim)
        self.quantizer = ProductQuantizer(d, dim=proj_dim)
        self.mask_emb = nn.Parameter(torch.zeros(d))

    def reset_parameters_from(self, g: torch.Generator) -> None:
        normal_(self.mask_emb, 0.1, g)

    def _generator(self, generator):
        if generator is not None:
            return generator
        if self.generator is None:
            self.generator = torch.Generator().manual_seed(0)
        return self.generator

    def forward(self, feats, feat_lens,
                generator: Optional[torch.Generator] = None):
        g = self._generator(generator)
        B = feats.shape[0]
        enc_clean, enc_lens = eval_forward(self.encoder, feats, feat_lens)
        Te = enc_clean.shape[1]
        starts = draw_span_starts((B, Te), self.mask_prob, g)
        q, diversity = self.quantizer(enc_clean.detach(), g)
        targets = dense(self.tgt_proj, q)
        mask_e = (span_mask(starts, self.mask_length).to(feats.device)
                  & make_pad_mask(enc_lens, Te))
        ctx_in = torch.where(mask_e[..., None],
                             self.mask_emb.to(enc_clean.dtype), enc_clean)
        context = dense(self.ctx_proj, ctx_in)
        offs = draw_negative_offsets(self.num_negatives, 1, max(Te - 1, 2),
                                     g)
        loss_c, acc = info_nce(context, targets, offs, mask_e,
                               self.temperature, self.count_sync)
        loss = loss_c + self.diversity_weight * diversity
        return {"loss": loss, "loss_contrastive": loss_c,
                "loss_diversity": diversity, "acc": acc,
                "num_masked": mask_e.sum()}
