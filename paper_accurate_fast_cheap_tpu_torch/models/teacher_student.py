"""Teacher-student distillation (port of the JAX
``models/teacher_student.py``).

A frozen teacher gives CTC posterior targets; the student pays its own
supervised loss plus ``KL(teacher || student)`` over the valid frames of
the CTC distributions (and optionally an L2 between encoder outputs).
``make_ts_loss_fn`` returns a ``loss_fn(params, batch, seed)`` for
``train/train_step.make_train_step``.  As in JAX, three encoder passes a
step: the student's training forward, the student's deterministic
``forward_encoder`` (differentiable: the KL's gradient flows through it) and
the teacher's, under ``torch.no_grad`` and detached (JAX's
``stop_gradient``).  The teacher carries its own weights (JAX passes
``teacher_params`` beside it).
"""
from __future__ import annotations

from typing import Callable

import torch

from paper_accurate_fast_cheap_tpu_torch.models.encoder_registry import (
    eval_forward)
from paper_accurate_fast_cheap_tpu_torch.ops.common import normaliser
from paper_accurate_fast_cheap_tpu_torch.train.train_step import bind_params
from paper_accurate_fast_cheap_tpu_torch.utils.masks import make_pad_mask


def kl_ctc_distill(student_logp: torch.Tensor, teacher_logp: torch.Tensor,
                   enc_mask: torch.Tensor, count_sync=None) -> torch.Tensor:
    """KL(teacher || student) over the frames of ``enc_mask``;
    ``count_sync``: ``ops/common.normaliser``'s."""
    kl = (teacher_logp.exp() * (teacher_logp - student_logp)).sum(-1)
    kl = torch.where(enc_mask, kl, torch.zeros((), device=kl.device))
    return kl.sum() / normaliser(enc_mask.sum(), count_sync)


def make_ts_loss_fn(student_model, teacher_model,
                    distill_weight: float = 1.0, student_weight: float = 1.0,
                    encoder_l2_weight: float = 0.0) -> Callable:
    """``loss_fn(params, batch, seed) -> (loss, metrics)``: ``params`` are
    the student's, bound into it; the step's dropout masks come from
    ``seed``."""

    def loss_fn(params, batch, seed):
        feats, feat_lens, labels, label_lens = batch
        torch.manual_seed(seed)
        student_model.train()
        bind_params(student_model, params)
        out = student_model(feats, feat_lens, labels, label_lens)
        s_enc, s_lens = eval_forward(student_model.encoder, feats,
                                     feat_lens)
        s_logp = student_model.ctc.log_probs(s_enc)
        with torch.no_grad():
            t_enc, _ = eval_forward(teacher_model.encoder, feats,
                                    feat_lens)
            t_logp = teacher_model.ctc.log_probs(t_enc)
        mask = make_pad_mask(s_lens, s_enc.shape[1])
        loss_distill = kl_ctc_distill(s_logp, t_logp.detach(), mask,
                                      student_model.count_sync)
        loss = student_weight * out["loss"] + distill_weight * loss_distill
        if encoder_l2_weight > 0.0:
            l2 = (s_enc - t_enc.detach()).square().mean()
            loss = loss + encoder_l2_weight * l2
        return loss, {"loss_student": out["loss"].detach(),
                      "loss_distill": loss_distill.detach()}

    return loss_fn
