"""W2V-BERT self-supervised pretraining (port of the JAX
``models/ssl_w2vbert.py``).

The clean pass (dropout off) gives Gumbel-quantized targets and their
codebook ids; the masked encoder frames (``mask_emb``) run through all the
blocks again as a pre-embedded input (``ConformerEncoder(pre_embedded=
True, return_layers=True)``); the output of block ``contrastive_blocks``
(half the stack by default) pays wav2vec2's InfoNCE, the top output an MLM
cross-entropy per codebook on the masked frames, with its weight ramped
over ``warmup_steps``, plus a feature L2 penalty.  The draws are
wav2vec2's (``ssl_wav2vec2.draw_*``).  Submodules keep flax's names
(``ctx_proj``, ``tgt_proj``, ``quantizer``, ``mlm_head_{i}``,
``mask_emb``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from paper_accurate_fast_cheap_tpu_torch.models import ssl_wav2vec2 as w2v
from paper_accurate_fast_cheap_tpu_torch.models.encoder_registry import (
    build_encoder, eval_forward)
from paper_accurate_fast_cheap_tpu_torch.models.layers import dense, normal_
from paper_accurate_fast_cheap_tpu_torch.ops.common import normaliser
from paper_accurate_fast_cheap_tpu_torch.utils.masks import make_pad_mask


class W2VBertModel(nn.Module):
    # maps a loss's count to the one this rank's shard stands for
    # (``ops/common.normaliser``; set by ``parallel/mesh.share_counts``)
    count_sync = None

    def __init__(self, encoder_conf: dict, encoder_type: str = "conformer",
                 proj_dim: int = 256, num_codebooks: int = 2,
                 codebook_entries: int = 320, num_negatives: int = 50,
                 mask_prob: float = 0.065, mask_length: int = 10,
                 temperature: float = 0.1, diversity_weight: float = 0.0,
                 features_regularization_weight: float = 0.01,
                 contrastive_blocks: int = 0, contrastive_weight: float = 1.0,
                 mlm_weight: float = 1.0, warmup_steps: int = 25000):
        super().__init__()
        conf = dict(encoder_conf)
        d = conf.get("output_size", 256)
        self.n_blocks = conf.get("num_blocks", 6)
        self.num_codebooks = num_codebooks
        self.num_negatives = num_negatives
        self.mask_prob = mask_prob
        self.mask_length = mask_length
        self.temperature = temperature
        self.diversity_weight = diversity_weight
        self.features_regularization_weight = features_regularization_weight
        self.contrastive_blocks = contrastive_blocks
        self.contrastive_weight = contrastive_weight
        self.mlm_weight = mlm_weight
        self.warmup_steps = warmup_steps
        self.generator: Optional[torch.Generator] = None
        self.encoder = build_encoder(encoder_type, conf)
        self.ctx_proj = nn.Linear(d, proj_dim)
        self.tgt_proj = nn.Linear(proj_dim, proj_dim)
        self.quantizer = w2v.ProductQuantizer(d, num_codebooks,
                                              codebook_entries, proj_dim)
        for i in range(num_codebooks):
            setattr(self, f"mlm_head_{i}", nn.Linear(d, codebook_entries))
        self.mask_emb = nn.Parameter(torch.zeros(d))

    def reset_parameters_from(self, g: torch.Generator) -> None:
        normal_(self.mask_emb, 0.1, g)

    def forward(self, feats, feat_lens,
                generator: Optional[torch.Generator] = None, steps: int = 0):
        if generator is None:
            if self.generator is None:
                self.generator = torch.Generator().manual_seed(0)
            generator = self.generator
        B = feats.shape[0]
        cblocks = self.contrastive_blocks or self.n_blocks // 2
        enc_clean, enc_lens = eval_forward(self.encoder, feats, feat_lens)
        Te = enc_clean.shape[1]
        starts = w2v.draw_span_starts((B, Te), self.mask_prob, generator)
        q, diversity, target_ids = self.quantizer(
            enc_clean.detach(), generator, return_ids=True)
        targets = dense(self.tgt_proj, q)
        mask_e = (w2v.span_mask(starts, self.mask_length).to(feats.device)
                  & make_pad_mask(enc_lens, Te))
        ctx_in = torch.where(mask_e[..., None],
                             self.mask_emb.to(enc_clean.dtype), enc_clean)
        _, _, layer_outs = self.encoder(ctx_in, enc_lens, return_layers=True,
                                        pre_embedded=True)
        context = dense(self.ctx_proj, layer_outs[cblocks - 1])
        offs = w2v.draw_negative_offsets(self.num_negatives, 1,
                                         max(Te - 1, 2), generator)
        loss_c, _ = w2v.info_nce(context, targets, offs, mask_e,
                                 self.temperature, self.count_sync)
        # MLM on the top output: each codebook's id of each masked frame
        denom = normaliser(mask_e.sum(), self.count_sync)
        loss_mlm = torch.zeros((), device=feats.device)
        accs = []
        for g in range(self.num_codebooks):
            lg = torch.log_softmax(dense(getattr(self, f"mlm_head_{g}"),
                                         layer_outs[-1]), dim=-1)
            tgt = target_ids[..., g]
            nll = -torch.gather(lg, -1, tgt[..., None])[..., 0]
            loss_mlm = loss_mlm + torch.where(
                mask_e, nll, torch.zeros((), dtype=nll.dtype,
                                         device=nll.device)).sum() / denom
            accs.append((mask_e & (lg.argmax(-1) == tgt)).sum() / denom)
        loss_mlm = loss_mlm / self.num_codebooks
        codes_acc = torch.stack(accs).mean()
        # the MLM weight's warm-up ramp
        ramp = min(1.0, 0.1 + 0.9 * steps / self.warmup_steps)
        mlm_w = self.mlm_weight * (1.0 if steps >= self.warmup_steps
                                   else ramp)
        feats_pen = enc_clean.float().square().mean()
        loss = (self.contrastive_weight * loss_c + mlm_w * loss_mlm
                + self.diversity_weight * diversity
                + self.features_regularization_weight * feats_pen)
        return {"loss": loss, "loss_contrastive": loss_c,
                "loss_mlm": loss_mlm, "loss_diversity": diversity,
                "codes_acc": codes_acc, "features_l2": feats_pen,
                "num_masked": mask_e.sum()}
