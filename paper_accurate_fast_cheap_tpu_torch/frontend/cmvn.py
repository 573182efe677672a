"""Global CMVN: JSON and Kaldi-text stats loading and application (port of
the JAX ``frontend/cmvn.py``)."""
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


def load_cmvn_kaldi_text(path: str):
    """Kaldi text-format global cmvn '[ m1..mD count v1..vD 0 ]' ->
    (mean, istd) f32."""
    with open(path) as f:
        head = f.read(2)
        if head == "\0B":
            raise ValueError("kaldi binary cmvn not supported; use "
                             "--binary=false")
        f.seek(0)
        arr = f.read().split()
    if not (arr[0] == "[" and arr[-1] == "]" and arr[-2] == "0"):
        raise ValueError(f"{path}: not a Kaldi text cmvn")
    dim = (len(arr) - 4) // 2
    means = np.asarray([float(x) for x in arr[1: dim + 1]], np.float64)
    count = float(arr[dim + 1])
    variances = np.asarray([float(x) for x in arr[dim + 2: 2 * dim + 2]],
                           np.float64)
    return _finalize(means, variances, count)


def load_cmvn(path: str, is_json: bool = True):
    return load_cmvn_json(path) if is_json else load_cmvn_kaldi_text(path)


def apply_cmvn(x: torch.Tensor, mean, istd) -> torch.Tensor:
    """(..., D) normalised: (x - mean) * istd."""
    mean = torch.as_tensor(mean, dtype=x.dtype, device=x.device)
    istd = torch.as_tensor(istd, dtype=x.dtype, device=x.device)
    return (x - mean) * istd
