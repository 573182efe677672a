"""Mask helpers (True = valid), as in the JAX package's ``utils/masks.py``.

The dynamic-chunk training mask is split in two: ``draw_dynamic_chunk``
draws ``(chunk, nleft)`` once per batch on the host from an explicit
``torch.Generator`` (the distribution of JAX's draw: full context with
probability 1/2, else a chunk in [1, max_chunk_cap]; ``nleft`` in
[0, max(T // chunk - 1, 1)) when the left context is dynamic, else -1), and
the mask is a pure function of ``(chunk, nleft)``.  The bits of JAX's
``jax.random`` draw cannot be reproduced, so tests replace
``draw_dynamic_chunk`` with JAX's draw.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def make_pad_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) lengths -> bool (B, max_len), True on valid positions."""
    return (torch.arange(max_len, device=lengths.device)[None, :]
            < lengths[:, None])


def subsequent_mask(size: int, device=None) -> torch.Tensor:
    """Causal (size, size) mask, True where s <= t."""
    return torch.ones(size, size, dtype=torch.bool, device=device).tril()


def subsequent_chunk_mask(size: int, chunk_size: int,
                          num_left_chunks: int = -1,
                          device=None) -> torch.Tensor:
    """Chunk-causal (size, size) mask: position t attends within its chunk
    and up to ``num_left_chunks`` previous chunks (all history when
    negative)."""
    chunk_of = torch.arange(size, device=device) // chunk_size
    s_chunk, t_chunk = chunk_of[None, :], chunk_of[:, None]
    ok = s_chunk <= t_chunk
    if num_left_chunks >= 0:
        ok = ok & (s_chunk >= t_chunk - num_left_chunks)
    return ok


def draw_dynamic_chunk(T: int, use_dynamic_left_chunk: bool,
                       generator: torch.Generator,
                       max_chunk_cap: int = 25) -> Tuple[int, int]:
    """One batch's dynamic chunk: (chunk, nleft), drawn on the host."""
    full = bool(torch.rand((), generator=generator) < 0.5)
    chunk = int(torch.randint(1, max_chunk_cap + 1, (),
                              generator=generator))
    if full:
        chunk = T
    nleft = -1
    if use_dynamic_left_chunk:
        max_left = max(T // chunk - 1, 1)
        nleft = int(torch.randint(0, max_left, (), generator=generator))
    return chunk, nleft


def add_optional_chunk_mask(pad_mask: torch.Tensor, use_dynamic_chunk: bool,
                            use_dynamic_left_chunk: bool,
                            decoding_chunk_size: int, static_chunk_size: int,
                            num_decoding_left_chunks: int,
                            generator: Optional[torch.Generator] = None,
                            max_chunk_cap: int = 25) -> torch.Tensor:
    """The padding mask (B, T) combined with a chunk mask -> bool (B, T, T),
    the branches of JAX's ``add_optional_chunk_mask`` in its order.  With
    ``use_dynamic_chunk`` the chunk is drawn from ``generator``
    (``draw_dynamic_chunk``)."""
    T = pad_mask.shape[1]
    dev = pad_mask.device
    att = pad_mask[:, None, :] & pad_mask[:, :, None]
    if use_dynamic_chunk:
        if generator is None:
            raise ValueError("a dynamic chunk needs a generator")
        chunk, nleft = draw_dynamic_chunk(T, use_dynamic_left_chunk,
                                          generator, max_chunk_cap)
        return att & subsequent_chunk_mask(T, chunk, nleft, dev)[None]
    if static_chunk_size > 0:
        cs = (decoding_chunk_size if decoding_chunk_size > 0
              else static_chunk_size)
        return att & subsequent_chunk_mask(T, cs, num_decoding_left_chunks,
                                           dev)[None]
    if decoding_chunk_size > 0:
        return att & subsequent_chunk_mask(T, decoding_chunk_size,
                                           num_decoding_left_chunks, dev)[None]
    return att


def causal_or_lookahead_mask(size: int, right_context: int,
                             left_context: int = -1,
                             device=None) -> torch.Tensor:
    """Limited left/right context (size, size) mask: s - t <= right_context
    and, when ``left_context >= 0``, s - t >= -left_context."""
    t = torch.arange(size, device=device)
    d = t[None, :] - t[:, None]
    ok = d <= right_context
    if left_context >= 0:
        ok = ok & (d >= -left_context)
    return ok
