"""Global CMVN: JSON stats loading and application (port of the JAX
``frontend/cmvn.py``)."""
from __future__ import annotations

import json

import numpy as np
import torch


def _finalize(mean_stat: np.ndarray, var_stat: np.ndarray, count: float):
    mean = mean_stat / count
    var = var_stat / count - mean * mean
    var = np.maximum(var, 1.0e-20)
    istd = 1.0 / np.sqrt(var)
    return mean.astype(np.float32), istd.astype(np.float32)


def load_cmvn_json(path: str):
    """JSON stats {mean_stat, var_stat, frame_num} -> (mean, istd) f32."""
    with open(path) as f:
        stats = json.load(f)
    return _finalize(np.asarray(stats["mean_stat"], np.float64),
                     np.asarray(stats["var_stat"], np.float64),
                     float(stats["frame_num"]))


def apply_cmvn(x: torch.Tensor, mean, istd) -> torch.Tensor:
    """(..., D) normalised: (x - mean) * istd."""
    mean = torch.as_tensor(mean, dtype=x.dtype, device=x.device)
    istd = torch.as_tensor(istd, dtype=x.dtype, device=x.device)
    return (x - mean) * istd
