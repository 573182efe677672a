"""Small numeric helpers shared by the recurrence ops."""
import torch


def as_f32(*xs):
    return tuple(x.to(torch.float32) for x in xs)


def revcumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Reverse (suffix) cumulative sum along ``dim``."""
    return torch.flip(torch.cumsum(torch.flip(x, (dim,)), dim), (dim,))
