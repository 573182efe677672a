"""Spectrogram augmentation on the device: SpecAugment masks, spec_sub and
spec_trim (port of the JAX ``frontend/augment.py``).

Batched over (B, T, D) features with each utterance's own draws from an
explicit ``torch.Generator`` on the features' device (no host round trip).
The bounds are JAX's: a span starts uniformly in [0, max(limit, 1)) --
``limit`` the utterance's valid length for time spans, D for frequency
spans -- and is 1..max wide (it may run past ``limit``, as in JAX);
spec_sub copies the span from ``pos`` frames earlier, ``pos`` uniform in
[0, start]; spec_trim shortens a length by l in [1, max_t] when
l < length // 2.  No time warp, as in the reference.  The bits of JAX's
``jax.random`` draws cannot be reproduced: the distributions are JAX's.
"""
from __future__ import annotations

import torch


def _uniform_below(limit: torch.Tensor, shape, generator) -> torch.Tensor:
    """Integers uniform in [0, limit) per row of ``limit`` (B,) -> shape."""
    u = torch.rand(shape, generator=generator, device=limit.device)
    return torch.minimum((u * limit[:, None]).long(), limit[:, None] - 1)


def _spans(limit: torch.Tensor, n: int, max_len: int, generator):
    """n spans per row: (start (B, n), width (B, n)), both int64."""
    B = limit.shape[0]
    start = _uniform_below(torch.clamp(limit.long(), min=1), (B, n),
                           generator)
    width = torch.randint(1, max_len + 1, (B, n), generator=generator,
                          device=limit.device)
    return start, width


def _span_mask(start, width, size: int) -> torch.Tensor:
    """(B, n) spans -> bool (B, size), True inside any span."""
    idx = torch.arange(size, device=start.device)[None, None, :]
    return ((idx >= start[..., None])
            & (idx < (start + width)[..., None])).any(dim=1)


def spec_aug(x: torch.Tensor, lengths: torch.Tensor,
             generator: torch.Generator, num_t_mask: int = 2,
             num_f_mask: int = 2, max_t: int = 50,
             max_f: int = 10) -> torch.Tensor:
    """SpecAugment zero masks on (B, T, D): ``num_t_mask`` time spans within
    each utterance's length, ``num_f_mask`` frequency spans."""
    B, T, D = x.shape
    lengths = lengths.to(x.device)
    y = x
    if num_t_mask > 0:
        tm = _span_mask(*_spans(lengths, num_t_mask, max_t, generator), T)
        y = y.masked_fill(tm[:, :, None], 0.0)
    if num_f_mask > 0:
        dims = torch.full((B,), D, device=x.device)
        fm = _span_mask(*_spans(dims, num_f_mask, max_f, generator), D)
        y = y.masked_fill(fm[:, None, :], 0.0)
    return y


def spec_sub(x: torch.Tensor, lengths: torch.Tensor,
             generator: torch.Generator, max_t: int = 20,
             num_t_sub: int = 3) -> torch.Tensor:
    """U2++ spec substitute on (B, T, D): each of ``num_t_sub`` spans
    [start, start + w) takes the frames ``pos`` earlier (of the input)."""
    B, T, D = x.shape
    lengths = lengths.to(x.device)
    idx = torch.arange(T, device=x.device)
    y = x
    for _ in range(num_t_sub):
        start, width = _spans(lengths, 1, max_t, generator)
        pos = _uniform_below(start[:, 0] + 1, (B, 1), generator)
        m = _span_mask(start, width, T)
        src = torch.clamp(idx[None, :] - pos, min=0)
        shifted = torch.gather(x, 1, src[:, :, None].expand(B, T, D))
        y = torch.where(m[:, :, None], shifted, y)
    return y


def spec_trim_length(lengths: torch.Tensor, generator: torch.Generator,
                     max_t: int = 20) -> torch.Tensor:
    """TrimTail: per utterance l in [1, max_t]; the new length is
    length - l where l < length // 2, else length."""
    l = torch.randint(1, max_t + 1, lengths.shape, generator=generator,
                      device=lengths.device).to(lengths.dtype)
    return torch.where(l < lengths // 2, lengths - l, lengths)
