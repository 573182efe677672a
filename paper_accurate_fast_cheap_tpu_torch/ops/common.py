"""Small tensor helpers shared by the ops and the models; the label helpers
are ports of the JAX package's ``utils/common.py``."""
from typing import Callable, Optional

import torch

IGNORE_ID = -1


def as_f32(*xs):
    return tuple(x.to(torch.float32) for x in xs)


def revcumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Reverse (suffix) cumulative sum along ``dim``."""
    return torch.flip(torch.cumsum(torch.flip(x, (dim,)), dim), (dim,))


def add_blank(ys: torch.Tensor, ys_lens: torch.Tensor,
              blank: int) -> torch.Tensor:
    """Prepend the blank for the transducer predictor's input, (B, U) ->
    (B, U+1); positions past each length become the blank too."""
    B, U = ys.shape
    valid = (torch.arange(1, U + 1, device=ys.device)[None, :]
             <= ys_lens.to(ys.device)[:, None])
    return torch.cat([torch.full((B, 1), blank, dtype=ys.dtype,
                                 device=ys.device),
                      torch.where(valid, ys, torch.full_like(ys, blank))],
                     dim=1)


def add_sos_eos(ys: torch.Tensor, ys_lens: torch.Tensor, sos: int, eos: int,
                ignore_id: int = IGNORE_ID):
    """Padded (B, U) labels -> (ys_in (B, U+1): <sos> then the labels,
    <eos> past each length; ys_out (B, U+1): the labels, <eos> at each
    length, ``ignore_id`` after it)."""
    B, U = ys.shape
    lens = ys_lens.to(ys.device)[:, None]
    pos = torch.arange(U + 1, device=ys.device)[None, :]
    ys_in = torch.cat([torch.full((B, 1), sos, dtype=ys.dtype,
                                  device=ys.device),
                       torch.where(pos[:, 1:] <= lens, ys,
                                   torch.full_like(ys, eos))], dim=1)
    ys_ext = torch.cat([ys, torch.zeros((B, 1), dtype=ys.dtype,
                                        device=ys.device)], dim=1)
    ys_out = torch.where(pos < lens, ys_ext, torch.where(
        pos == lens, torch.full_like(ys_ext, eos),
        torch.full_like(ys_ext, ignore_id)))
    return ys_in, ys_out


def reverse_pad_list(ys: torch.Tensor, ys_lens: torch.Tensor,
                     pad_value: int = IGNORE_ID) -> torch.Tensor:
    """Reverse each row's valid prefix; fill the rest with ``pad_value``."""
    B, U = ys.shape
    lens = ys_lens.to(ys.device)[:, None].long()
    pos = torch.arange(U, device=ys.device)[None, :]
    idx = torch.clamp(lens - 1 - pos, 0, U - 1)
    rev = torch.gather(ys, 1, idx)
    return torch.where(pos < lens, rev, torch.full_like(rev, pad_value))


def cosine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cosine similarity along the last axis, each side normalised with
    1e-8 added to its norm."""
    a = a / (torch.linalg.vector_norm(a, dim=-1, keepdim=True) + 1e-8)
    b = b / (torch.linalg.vector_norm(b, dim=-1, keepdim=True) + 1e-8)
    return (a * b).sum(-1)


def normaliser(count: torch.Tensor,
               count_sync: Optional[Callable] = None) -> torch.Tensor:
    """The count a loss or a metric divides by (tokens, frames), clamped at
    1; ``count_sync``, when given, maps this rank's count to the one its
    shard stands for (data parallelism: ``parallel/mesh.share_counts``)."""
    count = count.clamp(min=1)
    return count if count_sync is None else count_sync(count)


def accuracy(logits: torch.Tensor, targets: torch.Tensor,
             ignore_id: int = IGNORE_ID,
             count_sync: Optional[Callable] = None) -> torch.Tensor:
    """Token accuracy over the positions that are not ``ignore_id``."""
    valid = targets != ignore_id
    correct = ((logits.argmax(dim=-1) == targets) & valid).sum()
    return correct / normaliser(valid.sum(), count_sync)
