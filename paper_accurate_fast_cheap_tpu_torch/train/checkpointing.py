"""Checkpoint save and restore, snapshot names and model averaging (port of
the JAX ``train/checkpointing.py``, ``torch.save`` files in place of Orbax
directories).

A checkpoint is named as in JAX (``snapshot_name``: ``epoch_{e:04d}``,
``step_{s:09d}``, ``snapshot``, ``snapshot_and_optimizer``) and is up to
three files beside each other: ``<name>.pt``, the model's ``state_dict``
(what ``recognize_wav --checkpoint``, ``recognize`` and ``api.load_model``
read, with no conversion); ``<name>.opt.pt``, the optimizer state
(``train_step.TrainState.opt_state``), only when saved with one; and the
sidecar ``<name>.yaml`` (epoch, step, frames seen, tag, cv loss).
``list_checkpoints`` returns the model files, sorted by name as JAX sorts
its directories.
"""
from __future__ import annotations

import glob
import os
import re
from typing import Any, Dict, List, Optional

import torch

_OPT = ".opt.pt"


def _stem(path: str) -> str:
    """A checkpoint's name without the model file's suffix."""
    return path[:-3] if path.endswith(".pt") else path


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree


def save_checkpoint(path: str, params: Dict[str, torch.Tensor],
                    opt_state: Any = None,
                    info: Optional[Dict] = None) -> str:
    """Save the model ``params`` (a state_dict) as ``<path>.pt``, the
    optimizer state as ``<path>.opt.pt`` (an earlier one is removed when
    ``opt_state`` is None, as JAX overwrites its directory) and ``info`` as
    ``<path>.yaml``.  Returns the model file's path."""
    stem = _stem(path)
    os.makedirs(os.path.dirname(os.path.abspath(stem)), exist_ok=True)
    torch.save(_to_cpu(dict(params)), stem + ".pt")
    if opt_state is not None:
        torch.save(_to_cpu(opt_state), stem + _OPT)
    elif os.path.exists(stem + _OPT):
        os.remove(stem + _OPT)
    if info is not None:
        import yaml

        with open(stem + ".yaml", "w") as f:
            yaml.safe_dump(info, f)
    return stem + ".pt"


def load_checkpoint(path: str):
    """Returns (state_dict, optimizer state or None, info dict) of the
    checkpoint ``path`` (its name, or its model file)."""
    stem = _stem(path)
    params = torch.load(stem + ".pt", map_location="cpu", weights_only=True)
    opt = None
    if os.path.exists(stem + _OPT):
        opt = torch.load(stem + _OPT, map_location="cpu", weights_only=True)
    info = {}
    if os.path.exists(stem + ".yaml"):
        import yaml

        with open(stem + ".yaml") as f:
            info = yaml.safe_load(f) or {}
    return params, opt, info


def check_forced_full_snapshot_flag(model_dir: str,
                                    remove: bool = True) -> bool:
    """The operator's touch file ``force_full_snapshot``: the next snapshot
    carries the optimizer."""
    flag = os.path.join(model_dir, "force_full_snapshot")
    if os.path.exists(flag):
        if remove:
            os.remove(flag)
        return True
    return False


def snapshot_name(model_dir: str, step: Optional[int] = None,
                  epoch: Optional[int] = None,
                  with_optimizer: bool = False,
                  use_named: bool = False) -> str:
    if epoch is not None:
        return os.path.join(model_dir, f"epoch_{epoch:04d}")
    if use_named and step is not None:
        return os.path.join(model_dir, f"step_{step:09d}")
    return os.path.join(
        model_dir,
        "snapshot_and_optimizer" if with_optimizer else "snapshot")


def list_checkpoints(model_dir: str) -> List[str]:
    """The model files of ``model_dir``'s checkpoints (epoch, step and
    snapshot names), sorted."""
    out = []
    for p in glob.glob(os.path.join(model_dir, "*.pt")):
        if (os.path.isfile(p) and not p.endswith(_OPT)
                and re.match(r".*(epoch_\d+|step_\d+|snapshot)", _stem(p))):
            out.append(p)
    return sorted(out)


def average_checkpoints(paths: List[str]) -> Dict[str, torch.Tensor]:
    """Uniform average of the checkpoints' parameters, accumulated in
    float64 and cast back to each parameter's dtype."""
    if not paths:
        raise ValueError("no checkpoints to average")
    acc, dtypes = None, None
    for p in paths:
        sd = torch.load(_stem(p) + ".pt", map_location="cpu",
                        weights_only=True)
        if acc is None:
            acc = {k: v.double() for k, v in sd.items()}
            dtypes = {k: v.dtype for k, v in sd.items()}
        else:
            for k, v in sd.items():
                acc[k] += v.double()
    n = len(paths)
    return {k: (a / n).to(dtypes[k]) for k, a in acc.items()}


def select_best_checkpoints(model_dir: str, num: int,
                            metric: str = "cv_loss",
                            minimize: bool = True) -> List[str]:
    """The best ``num`` checkpoints by a sidecar metric."""
    import yaml

    cands = []
    for p in list_checkpoints(model_dir):
        yml = _stem(p) + ".yaml"
        if os.path.exists(yml):
            with open(yml) as f:
                info = yaml.safe_load(f) or {}
            if metric in info:
                cands.append((info[metric], p))
    cands.sort(reverse=not minimize)
    return [p for _, p in cands[:num]]
