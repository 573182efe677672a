"""Small tensor helpers shared by the ops and the models."""
import torch


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
