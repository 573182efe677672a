"""PyTorch/CUDA port of the long-form ASR framework, for one NVIDIA H100.

Mirrors the JAX package's layout (``ops/ frontend/ models/ decode/``); the
hand-written Hopper kernels live in ``csrc/`` and build at first use.  Entry
points put work on ``cuda`` unless the caller passes ``device="cpu"``.
"""
import torch


def resolve_device(device=None) -> torch.device:
    """``cuda`` by default; the CPU only when asked for.  Raises when no card
    is present and the caller did not ask for the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "plain PyTorch versions on the CPU")
    return dev
