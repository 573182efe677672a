"""BestRQ self-supervised pretraining (port of the JAX
``models/ssl_bestrq.py``).

A frozen random projection and random codebooks quantize the clean
features, stacked ``stack_frames`` at a time, into targets; the encoder
reads the features with spans replaced by noise and learns each masked
frame's codebook index (cross-entropy on the masked encoder frames).

The projection and the codebooks are JAX's draws from the fixed keys
``PRNGKey(0)`` and ``PRNGKey(100 + i)`` (``utils/jax_prng``), which JAX
recomputes on every call and stores nowhere: they are part of the model, so
a JAX-trained encoder meets the same targets here.  The model computes
them on the host at its first call and keeps them out of the
``state_dict``.  The step's own draws (the span starts, the noise) are
host functions of a ``torch.Generator``: ``draw_span_starts``
(wav2vec2's) and ``draw_noise`` (the model's ``generator``, seeded 0 at
first use, unless the caller passes one).
Submodules keep flax's names (``head_{i}``).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from paper_accurate_fast_cheap_tpu_torch.models.encoder_registry import (
    build_encoder)
from paper_accurate_fast_cheap_tpu_torch.models.layers import dense
from paper_accurate_fast_cheap_tpu_torch.models.ssl_wav2vec2 import (
    draw_span_starts, span_mask)
from paper_accurate_fast_cheap_tpu_torch.ops.common import normaliser
from paper_accurate_fast_cheap_tpu_torch.utils import jax_prng
from paper_accurate_fast_cheap_tpu_torch.utils.masks import make_pad_mask

def frozen_quantizer(in_dim: int, codebook_dim: int, codebook_size: int,
                     num_codebooks: int
                     ) -> Tuple[np.ndarray, List[np.ndarray]]:
    """(projection (in_dim, codebook_dim), [codebook (codebook_size,
    codebook_dim)] * num_codebooks): JAX's fixed draws, float32."""
    return (jax_prng.normal(jax_prng.key(0), (in_dim, codebook_dim)),
            [jax_prng.normal(jax_prng.key(100 + i),
                             (codebook_size, codebook_dim))
             for i in range(num_codebooks)])


def draw_noise(shape: Tuple[int, ...],
               generator: torch.Generator) -> torch.Tensor:
    """Standard normal noise (scaled by 0.1 where used), on the host."""
    return torch.randn(shape, generator=generator)


class BestRQModel(nn.Module):
    # maps a loss's count to the one this rank's shard stands for
    # (``ops/common.normaliser``; set by ``parallel/mesh.share_counts``)
    count_sync = None

    def __init__(self, encoder_conf: dict, encoder_type: str = "conformer",
                 input_size: int = 80, num_codebooks: int = 1,
                 codebook_size: int = 8192, codebook_dim: int = 16,
                 mask_prob: float = 0.01, mask_length: int = 10,
                 stack_frames: int = 4):
        super().__init__()
        d = dict(encoder_conf).get("output_size", 256)
        self.input_size = input_size
        self.num_codebooks = num_codebooks
        self.codebook_size = codebook_size
        self.codebook_dim = codebook_dim
        self.mask_prob = mask_prob
        self.mask_length = mask_length
        self.stack_frames = stack_frames
        self.generator: Optional[torch.Generator] = None
        self._frozen = None
        self.encoder = build_encoder(encoder_type, dict(encoder_conf))
        for i in range(num_codebooks):
            setattr(self, f"head_{i}", nn.Linear(d, codebook_size))

    def _quantize(self, feats: torch.Tensor) -> List[torch.Tensor]:
        """Codebook ids (B, ceil(T / s)) per codebook, from the frozen
        projection and codebooks."""
        B, T, D = feats.shape
        s = self.stack_frames
        stacked = F.pad(feats, (0, 0, 0, (-T) % s)).reshape(B, -1, s * D)
        if self._frozen is None:
            self._frozen = frozen_quantizer(s * D, self.codebook_dim,
                                            self.codebook_size,
                                            self.num_codebooks)
        proj, books = self._frozen
        dev = feats.device
        z = stacked @ torch.from_numpy(proj).to(dev, stacked.dtype)
        z = z / (torch.linalg.vector_norm(z, dim=-1, keepdim=True) + 1e-8)
        ids = []
        for b in books:
            b = torch.from_numpy(b).to(dev)
            b = b / (torch.linalg.vector_norm(b, dim=-1, keepdim=True)
                     + 1e-8)
            ids.append((z @ b.to(z.dtype).T).argmax(-1))
        return ids

    def forward(self, feats, feat_lens,
                generator: Optional[torch.Generator] = None):
        """{"loss", "acc", "num_masked"}; dropout follows ``.train()``."""
        if generator is None:
            if self.generator is None:
                self.generator = torch.Generator().manual_seed(0)
            generator = self.generator
        B, T, _ = feats.shape
        dev = feats.device
        targets = self._quantize(feats)
        starts = draw_span_starts((B, T), self.mask_prob, generator)
        mask = (span_mask(starts, self.mask_length).to(dev)
                & make_pad_mask(feat_lens, T))
        noise = draw_noise(tuple(feats.shape), generator).to(dev) * 0.1
        masked = torch.where(mask[..., None], noise.to(feats.dtype), feats)
        enc, _ = self.encoder(masked, feat_lens)
        # the frame mask at the encoder rate (ds4 ~ stack_frames)
        s = self.stack_frames
        m_enc = F.pad(mask, (0, (-T) % s)).reshape(B, -1, s).any(-1)
        Te = min(enc.shape[1], m_enc.shape[1])
        sel = m_enc[:, :Te]
        denom = normaliser(sel.sum(), self.count_sync)
        losses, accs = [], []
        for i in range(self.num_codebooks):
            logits = dense(getattr(self, f"head_{i}"), enc)[:, :Te]
            tgt = targets[i][:, :Te]
            nll = -torch.gather(torch.log_softmax(logits, dim=-1), -1,
                                tgt[..., None])[..., 0]
            zero = torch.zeros((), dtype=nll.dtype, device=dev)
            losses.append(torch.where(sel, nll, zero).sum() / denom)
            accs.append((sel & (logits.argmax(-1) == tgt)).sum() / denom)
        return {"loss": torch.stack(losses).mean(),
                "acc": torch.stack(accs).mean(), "num_masked": m_enc.sum()}
