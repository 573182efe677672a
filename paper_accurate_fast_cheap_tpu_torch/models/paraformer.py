"""Paraformer: non-autoregressive ASR with a CIF predictor (port of the JAX
``models/paraformer.py``).

A continuous-integrate-and-fire (CIF) predictor accumulates per-frame
weights alpha until they cross 1.0 and emits one acoustic embedding per
token; a non-autoregressive decoder attends the encoder output with those
embeddings as queries.  Training scales alpha so its mass equals the label
count (the quantity loss), pays label smoothing on the decoder (and CTC),
and in ``.train()`` runs the glancing sampler: positions a first decoder
pass got wrong are replaced by target embeddings with probability
``sampling_ratio * error rate``, drawn by ``draw_sampler_uniform`` on the
model's ``sampler_generator`` (seeded 0 at first use).

``cif`` is a loop over frames with JAX's static ``max_tokens`` budget and
its order of operations in f32 (a fire at ``acc + a_t >= 1.0`` turns on
the last bit).  Submodules keep flax's names (``predictor_alpha``, ``ctc``,
``dec_{i}``, ``output_layer``, ``sampler_embed``; SAN-M's
``linear_q_k_v``, ``fsmn_block``, ``linear_out``).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from paper_accurate_fast_cheap_tpu_torch.models.ctc_head import (
    CTCHead, ctc_loss)
from paper_accurate_fast_cheap_tpu_torch.models.decoder import DecoderLayer
from paper_accurate_fast_cheap_tpu_torch.models.encoder_registry import (
    build_encoder)
from paper_accurate_fast_cheap_tpu_torch.models.layers import conv, dense
from paper_accurate_fast_cheap_tpu_torch.ops.common import (
    IGNORE_ID, accuracy)
from paper_accurate_fast_cheap_tpu_torch.ops.losses import (
    label_smoothing_loss)
from paper_accurate_fast_cheap_tpu_torch.utils.masks import make_pad_mask


def draw_sampler_uniform(shape: Tuple[int, ...],
                         generator: torch.Generator) -> torch.Tensor:
    """The glancing sampler's uniforms in [0, 1), on the host."""
    return torch.rand(shape, generator=generator)


def cif(enc: torch.Tensor, alpha: torch.Tensor, max_tokens: int,
        threshold: float = 1.0):
    """enc (B, T, D), alpha (B, T) non-negative -> (embeddings (B,
    max_tokens, D), fired counts (B,))."""
    B, T, D = enc.shape
    dev = enc.device
    acc = enc.new_zeros(B, dtype=alpha.dtype)
    frac = enc.new_zeros(B, D)
    out = enc.new_zeros(B, max_tokens, D)
    n = torch.zeros(B, dtype=torch.int32, device=dev)
    slots = torch.arange(max_tokens, device=dev)[None]
    zero = torch.zeros((), dtype=alpha.dtype, device=dev)
    for t in range(T):
        a_t, h_t = alpha[:, t], enc[:, t]
        new_acc = acc + a_t
        fire = new_acc >= threshold
        # the weight that completes the current token
        w_complete = torch.where(fire, threshold - acc, a_t)
        emb = frac + w_complete[:, None] * h_t
        # the leftover starts the next token
        leftover = torch.where(fire, new_acc - threshold, zero)
        frac = torch.where(fire[:, None], leftover[:, None] * h_t,
                           frac + a_t[:, None] * h_t)
        put = fire[:, None] & (n[:, None] == slots)
        out = torch.where(put[..., None], emb[:, None, :], out)
        n = torch.where(fire, torch.clamp(n + 1, max=max_tokens), n)
        acc = torch.where(fire, leftover, new_acc)
    return out, n


class SANMAttention(nn.Module):
    """SAN-M self-attention: fused q/k/v projection, plus an FSMN memory
    branch over v (depthwise conv, left/right split by ``sanm_shift``,
    residual, re-masked) added to the attention output."""

    def __init__(self, heads: int, d_model: int, kernel_size: int = 11,
                 sanm_shift: int = 0, dropout_rate: float = 0.1):
        super().__init__()
        self.heads, self.d_model = heads, d_model
        self.left = (kernel_size - 1) // 2 + sanm_shift
        self.right = kernel_size - 1 - self.left
        self.linear_q_k_v = nn.Linear(d_model, 3 * d_model)
        self.fsmn_block = nn.Conv1d(d_model, d_model, kernel_size,
                                    groups=d_model, bias=False)
        self.dropout = nn.Dropout(dropout_rate)
        self.linear_out = nn.Linear(d_model, d_model)

    def forward(self, x, mask=None, pad_mask=None):
        B, T, _ = x.shape
        H = self.heads
        Dk = self.d_model // H
        q, k, v = dense(self.linear_q_k_v, x).chunk(3, dim=-1)
        zero = torch.zeros((), dtype=v.dtype, device=x.device)
        vm = v if pad_mask is None else torch.where(pad_mask[..., None], v,
                                                    zero)
        mem = conv(self.fsmn_block, F.pad(vm.transpose(1, 2),
                                          (self.left, self.right)))
        mem = self.dropout(mem.transpose(1, 2) + vm)
        if pad_mask is not None:
            mem = torch.where(pad_mask[..., None], mem, zero)
        scores = torch.einsum("bthd,bshd->bhts", q.reshape(B, T, H, Dk),
                              k.reshape(B, T, H, Dk))
        scores = scores / torch.tensor(math.sqrt(Dk), dtype=x.dtype,
                                       device=x.device)
        if mask is not None:
            m = mask[:, None] if mask.ndim == 3 else mask
            scores = scores.masked_fill(~m, -1e9)
        probs = torch.softmax(scores, dim=-1)
        if mask is not None:
            probs = probs.masked_fill(~m, 0.0)
        att = torch.einsum("bhts,bshd->bthd", probs, v.reshape(B, T, H, Dk))
        return dense(self.linear_out, att.reshape(B, T, -1)) + mem


def cif_peaks(alphas: torch.Tensor, token_nums: torch.Tensor,
              threshold: float = 1.0) -> torch.Tensor:
    """The timestamp branch: alphas rescaled so their mass equals
    ``token_nums``, accumulated, fire marks (B, T) bool."""
    total = alphas.sum(-1, keepdim=True)
    nums = token_nums.to(alphas.dtype)[:, None].clamp(min=1e-6)
    scaled = alphas / (total / nums).clamp(min=1e-6)
    acc = alphas.new_zeros(alphas.shape[0])
    fired = []
    for t in range(alphas.shape[1]):
        acc = acc + scaled[:, t]
        f = acc >= threshold - 1e-4
        acc = torch.where(f, acc - (threshold - 1e-4), acc)
        fired.append(f)
    return torch.stack(fired, dim=1)


class Paraformer(nn.Module):
    # maps a loss's count to the one this rank's shard stands for
    # (``ops/common.normaliser``; set by ``parallel/mesh.share_counts``)
    count_sync = None

    def __init__(self, vocab_size: int, encoder_conf: dict,
                 encoder_type: str = "conformer", decoder_blocks: int = 4,
                 decoder_heads: int = 4, decoder_linear_units: int = 1024,
                 ctc_weight: float = 0.3, quantity_weight: float = 1.0,
                 lsm_weight: float = 0.1, max_tokens: int = 128,
                 ignore_id: int = IGNORE_ID, sampler: bool = True,
                 sampling_ratio: float = 0.75):
        super().__init__()
        d = dict(encoder_conf).get("output_size", 256)
        self.d_model = d
        self.vocab_size = vocab_size
        self.decoder_blocks = decoder_blocks
        self.ctc_weight = ctc_weight
        self.quantity_weight = quantity_weight
        self.lsm_weight = lsm_weight
        self.max_tokens = max_tokens
        self.ignore_id = ignore_id
        self.sampler = sampler
        self.sampling_ratio = sampling_ratio
        self.sampler_generator: Optional[torch.Generator] = None
        self.encoder = build_encoder(encoder_type, dict(encoder_conf))
        self.predictor_alpha = nn.Linear(d, 1)
        self.ctc = CTCHead(d, vocab_size)
        for i in range(decoder_blocks):
            setattr(self, f"dec_{i}", DecoderLayer(d, decoder_heads,
                                                   decoder_linear_units))
        self.output_layer = nn.Linear(d, vocab_size)
        if sampler:
            self.sampler_embed = nn.Embedding(vocab_size, d)

    def _alphas(self, enc, enc_lens):
        alpha = torch.sigmoid(dense(self.predictor_alpha, enc))[..., 0]
        valid = make_pad_mask(enc_lens, enc.shape[1])
        return torch.where(valid, alpha, torch.zeros((), dtype=alpha.dtype,
                                                     device=alpha.device))

    def _decode_embs(self, enc, enc_lens, embs, n_tokens):
        tok_mask = make_pad_mask(n_tokens, self.max_tokens)
        self_mask = tok_mask[:, None, :] & tok_mask[:, :, None]
        mem_mask = make_pad_mask(enc_lens, enc.shape[1])[:, None, :]
        x = embs
        for i in range(self.decoder_blocks):
            x = getattr(self, f"dec_{i}")(x, self_mask, enc, mem_mask)
        return dense(self.output_layer, x)

    def forward(self, feats, feat_lens, labels, label_lens):
        """{"loss", "loss_decoder", "loss_quantity", "loss_ctc",
        "th_accuracy"}; dropout and the sampler follow ``.train()``."""
        enc, enc_lens = self.encoder(feats, feat_lens)
        alpha = self._alphas(enc, enc_lens)
        total = alpha.sum(1)
        lens_f = label_lens.to(torch.float32)
        loss_quantity = (total - lens_f).abs().mean()
        scale = lens_f / total.clamp(min=1e-6)
        embs, _ = cif(enc, alpha * scale[:, None], self.max_tokens)
        B, U = labels.shape
        keep = torch.arange(U, device=labels.device)[None] < label_lens[:,
                                                                        None]
        tgt = torch.full((B, self.max_tokens), self.ignore_id,
                         dtype=labels.dtype, device=labels.device)
        tgt[:, :U] = torch.where(keep, labels,
                                 torch.full_like(labels, self.ignore_id))
        if self.sampler and self.training:
            embs = self._sampler(enc, enc_lens, embs, tgt, label_lens)
        logits = self._decode_embs(enc, enc_lens, embs, label_lens)
        loss_dec = label_smoothing_loss(logits, tgt, self.lsm_weight,
                                        self.ignore_id)
        loss_ctc = torch.zeros((), device=enc.device)
        if self.ctc_weight > 0:
            loss_ctc = ctc_loss(self.ctc(enc), enc_lens, labels, label_lens)
        loss = (loss_dec + self.quantity_weight * loss_quantity
                + self.ctc_weight * loss_ctc)
        return {"loss": loss, "loss_decoder": loss_dec,
                "loss_quantity": loss_quantity, "loss_ctc": loss_ctc,
                "th_accuracy": accuracy(logits, tgt, self.ignore_id,
                                        self.count_sync)}

    def _sampler(self, enc, enc_lens, acoustic_embs, tgt, label_lens):
        """The glancing sampler: a first decoder pass in eval mode and
        without gradient, then per position a Bernoulli replacement."""
        tok_valid = tgt != self.ignore_id
        tgt_ids = torch.where(tok_valid, tgt, torch.zeros_like(tgt))
        tgt_embs = self.sampler_embed(tgt_ids.long())
        was = self.training
        self.eval()
        try:
            with torch.no_grad():
                first = self._decode_embs(enc, enc_lens, acoustic_embs,
                                          label_lens)
        finally:
            self.train(was)
        wrong = (first.argmax(-1) != tgt_ids) & tok_valid
        n_tok = tok_valid.sum(1).clamp(min=1)
        p_replace = (self.sampling_ratio * wrong.sum(1) / n_tok)[:, None]
        if self.sampler_generator is None:
            self.sampler_generator = torch.Generator().manual_seed(0)
        u = draw_sampler_uniform(tuple(tgt_ids.shape),
                                 self.sampler_generator).to(enc.device)
        replace = (u < p_replace) & tok_valid
        mixed = torch.where(replace[..., None], tgt_embs.to(
            acoustic_embs.dtype), acoustic_embs)
        return torch.where(tok_valid[..., None], mixed,
                           torch.zeros((), dtype=mixed.dtype,
                                       device=mixed.device))

    @torch.no_grad()
    def forward_cif_peaks(self, feats, feat_lens, token_nums):
        """CIF fire marks (B, T) at the encoder rate, rescaled to
        ``token_nums``."""
        enc, enc_lens = self.encoder(feats, feat_lens)
        return cif_peaks(self._alphas(enc, enc_lens), token_nums)

    @torch.no_grad()
    def recognize(self, feats, feat_lens):
        """Non-autoregressive decode: (token ids (B, max_tokens), fired
        counts (B,)); the fires set each row's length."""
        enc, enc_lens = self.encoder(feats, feat_lens)
        embs, n_fired = cif(enc, self._alphas(enc, enc_lens),
                            self.max_tokens)
        logits = self._decode_embs(enc, enc_lens, embs, n_fired)
        return logits.argmax(-1), n_fired
