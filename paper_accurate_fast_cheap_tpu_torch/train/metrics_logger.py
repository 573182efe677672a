"""Training metrics logging (port of the JAX ``train/metrics_logger.py``):
an append-only JSON-lines file (``metrics.jsonl``) as the local record,
TensorBoard when ``torch.utils.tensorboard`` imports, and wandb (metrics,
run artifacts, checkpoint artifacts, resume) only when ``wandb`` imports;
without it every wandb call does nothing, as in JAX.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricsLogger:
    def __init__(self, log_dir: Optional[str], use_tensorboard: bool = True,
                 use_wandb: bool = False, wandb_config: Dict = None):
        self.log_dir = log_dir
        self._jsonl = None
        self._tb = None
        self._wandb = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a",
                               buffering=1)
            if use_tensorboard:
                try:
                    from torch.utils.tensorboard import SummaryWriter

                    self._tb = SummaryWriter(
                        os.path.join(log_dir, "tensorboard"))
                except ImportError:
                    pass
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb
                wandb.init(config=wandb_config or {}, dir=log_dir)
            except ImportError:
                pass

    def log(self, step: int, metrics: Dict[str, float],
            prefix: str = "train"):
        rec = {"step": step, "time": time.time(),
               **{f"{prefix}/{k}": float(v) for k, v in metrics.items()}}
        if self._jsonl:
            self._jsonl.write(json.dumps(rec) + "\n")
        if self._tb:
            for k, v in metrics.items():
                self._tb.add_scalar(f"{prefix}/{k}", float(v), step)
        if self._wandb:
            self._wandb.log(rec, step=step)

    def log_artifact(self, name: str, path: str, type_: str = "file",
                     metadata: Optional[Dict] = None,
                     aliases: Optional[list] = None):
        """Upload a file or directory as a wandb artifact."""
        if not self._wandb:
            return
        art = self._wandb.Artifact(name, type=type_, metadata=metadata or {})
        if os.path.isdir(path):
            art.add_dir(path)
        else:
            art.add_file(path)
        self._wandb.log_artifact(art, aliases=aliases)

    def log_run_artifacts(self, code_dir: Optional[str] = None,
                          data_lists: Optional[list] = None,
                          tokenizer_files: Optional[list] = None):
        """The run's provenance: code tree, data lists, tokenizer files."""
        if not self._wandb:
            return
        if code_dir:
            self.log_artifact("code", code_dir, type_="code")
        for pth in data_lists or []:
            if pth and os.path.exists(pth):
                self.log_artifact(os.path.basename(pth), pth,
                                  type_="data_list")
        for pth in tokenizer_files or []:
            if pth and os.path.exists(pth):
                self.log_artifact(os.path.basename(pth), pth,
                                  type_="tokenizer")

    def log_checkpoint(self, path: str, metadata: Optional[Dict] = None,
                       with_optimizer: bool = False):
        """A checkpoint's files (model, optimizer, sidecar) as one wandb
        artifact."""
        if not self._wandb:
            return
        meta = dict(metadata or {})
        meta["with_optimizer"] = with_optimizer
        aliases = ["latest"] + (["latest-optimizer"] if with_optimizer
                                else [])
        stem = path[:-3] if path.endswith(".pt") else path
        art = self._wandb.Artifact(os.path.basename(stem), type="model",
                                   metadata=meta)
        for ext in (".pt", ".opt.pt", ".yaml"):
            if os.path.exists(stem + ext):
                art.add_file(stem + ext)
        self._wandb.log_artifact(art, aliases=aliases)

    def close(self):
        if self._jsonl:
            self._jsonl.close()
        if self._tb:
            self._tb.close()
        if self._wandb:
            self._wandb.finish()


def download_checkpoint_from_wandb(project: str, entity: str = None,
                                   run_id: str = None,
                                   dest: str = "wandb_ckpt"):
    """The latest optimizer-bearing checkpoint artifact, for resume.
    Returns the local checkpoint name or None when wandb (or the artifact)
    is unavailable."""
    try:
        import wandb
    except ImportError:
        return None
    api = wandb.Api()
    path = "/".join(x for x in (entity, project) if x)
    runs = [api.run(f"{path}/{run_id}")] if run_id else api.runs(path)
    best = None
    for run in runs:
        for art in run.logged_artifacts():
            if art.type != "model":
                continue
            if not art.metadata.get("with_optimizer", False):
                continue
            step = art.metadata.get("step", -1)
            if best is None or step > best[0]:
                best = (step, art)
    if best is None:
        return None
    root = best[1].download(root=dest)
    return os.path.join(root, best[1].name.split(":")[0])
