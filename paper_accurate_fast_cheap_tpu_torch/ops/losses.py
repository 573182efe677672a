"""Label-smoothing loss of the attention decoder (port of the JAX
``ops/losses.py``): the KL divergence against a (1 - eps, eps / (V - 1))
smoothed distribution, its constant entropy term included, ``ignore_id``
positions dropped, normalised by the batch (default) or by the token count
(``normalize_length``, through ``ops/common.normaliser``)."""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from paper_accurate_fast_cheap_tpu_torch.ops.common import (
    IGNORE_ID, normaliser)


def label_smoothing_loss(logits: torch.Tensor, targets: torch.Tensor,
                         smoothing: float = 0.1, ignore_id: int = IGNORE_ID,
                         normalize_length: bool = False,
                         count_sync: Optional[Callable] = None
                         ) -> torch.Tensor:
    """logits (B, U, V), targets (B, U) with ``ignore_id`` padding."""
    B, U, V = logits.shape
    logp = torch.log_softmax(logits.float(), dim=-1)
    valid = targets != ignore_id
    tgt = torch.where(valid, targets, torch.zeros_like(targets)).long()
    confidence = 1.0 - smoothing
    low = smoothing / (V - 1)
    # sum of p log p of the smoothed distribution: V entries of ``low``
    # (the f32 sum of the JAX package), the target's low replaced by the
    # confidence
    lows = torch.full((V,), low, dtype=torch.float32)
    kl_const = torch.sum(torch.where(lows > 0, lows * torch.log(lows),
                                     torch.zeros(())))
    if confidence > 0:
        kl_const = kl_const + (confidence * math.log(confidence)
                               - low * math.log(low))
    tgt_logp = torch.gather(logp, -1, tgt[..., None])[..., 0]
    sum_logp = logp.sum(dim=-1)
    cross = -(confidence * tgt_logp + low * (sum_logp - tgt_logp))
    kl = torch.where(valid, cross + kl_const.to(logp.device),
                     torch.zeros((), device=logp.device))
    denom = (normaliser(valid.sum().float(), count_sync)
             if normalize_length
             else torch.tensor(float(B), device=logp.device))
    return kl.sum() / denom
