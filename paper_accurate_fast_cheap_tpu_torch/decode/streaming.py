"""Chunk-by-chunk streaming encoder loop (port of the JAX
``decode/streaming.py``).

Feature windows of ``(chunk - 1) * subsampling + context`` frames advance by
``chunk * subsampling`` frames; the per-layer streaming state (the WKV or SSD
state, the token shift, the conv caches, the MHA KV cache) is carried from
window to window, so a causal encoder's chunked output equals its
full-utterance output.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch


def forward_chunk_by_chunk(encoder_apply: Callable, feats: torch.Tensor,
                           decoding_chunk_size: int, subsampling: int = 4,
                           context: int = 7
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``encoder_apply(xs, xs_lens, streaming_state, offset) -> (ys,
    out_lens, new_state)``; feats (1, T, D).  Returns the concatenated
    encoder outputs (1, T', D') and their length (1,).  A window shorter
    than the context ends the loop."""
    T = feats.shape[1]
    stride = subsampling * decoding_chunk_size
    window = (decoding_chunk_size - 1) * subsampling + context
    outs, state, offset = [], None, 0
    for start in range(0, max(T - context + 1, 1), stride):
        chunk = feats[:, start:start + window]
        if chunk.shape[1] < context:
            break
        lens = torch.tensor([chunk.shape[1]], device=feats.device)
        ys, out_lens, state = encoder_apply(chunk, lens, state, offset)
        n = int(out_lens[0])
        outs.append(ys[:, :n])
        offset += n
    if not outs:
        return (feats.new_zeros(1, 0, feats.shape[-1]),
                torch.zeros(1, dtype=torch.int64))
    full = torch.cat(outs, dim=1)
    return full, torch.tensor([full.shape[1]])
