"""Mask helpers (True = valid), as in the JAX package's ``utils/masks.py``."""
import torch


def make_pad_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) lengths -> bool (B, max_len), True on valid positions."""
    return (torch.arange(max_len, device=lengths.device)[None, :]
            < lengths[:, None])
