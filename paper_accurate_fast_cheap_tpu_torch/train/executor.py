"""Training executor: the epoch loop, cv, snapshots and metrics (port of the
JAX ``train/executor.py``).

Per batch: features on the device (fbank, CMVN and, in training, dither,
spec_sub and SpecAugment from the executor's ``torch.Generator`` on that
device; a batch's ``cat_embs`` rides along for the language-specific
encoder blocks), the train step, frames-seen accounting; every ``log_interval``
batches the loss and metrics are read on the host and logged (the loss is
not read between), and every ``save_interval`` steps a mid-epoch cv and a
snapshot (with the optimizer every ``save_optimizer_every``-th snapshot or
when the ``force_full_snapshot`` flag file exists).  Each step's dropout
seed is drawn from a host generator seeded with ``seed``.
"""
from __future__ import annotations

import logging
import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from paper_accurate_fast_cheap_tpu_torch.train import checkpointing

log = logging.getLogger(__name__)


class Executor:
    def __init__(self, train_step: Callable, eval_loss: Callable,
                 featurize: Callable, model_dir: str = None,
                 log_interval: int = 100, save_interval: int = 0,
                 save_optimizer_every: int = 10,
                 use_named_snapshots: bool = False, seed: int = 0,
                 metrics_logger=None, device=None,
                 state_dict_of: Optional[Callable] = None,
                 accum_steps: int = 1,
                 batch_shard: Optional[Callable] = None):
        """``train_step(state, batch, seed) -> (state, loss, metrics)``;
        ``eval_loss(params, batch) -> (loss, metrics)``;
        ``featurize(wavs, wav_lens, train, generator)``; ``state_dict_of``
        turns the state's parameters into the checkpoint's state_dict;
        ``batch_shard``, when given, takes this rank's part of a training
        batch's tensors after the features (data parallelism: the global
        batch is featurized alike on every rank, then sliced)."""
        self.train_step = train_step
        self.eval_loss = eval_loss
        self.featurize = featurize
        self.model_dir = model_dir
        self.log_interval = log_interval
        self.save_interval = save_interval
        self.save_optimizer_every = save_optimizer_every
        self.use_named_snapshots = use_named_snapshots
        self.metrics_logger = metrics_logger
        self.state_dict_of = state_dict_of or dict
        self.accum_steps = accum_steps
        self.batch_shard = batch_shard
        self.device = torch.device(device or "cpu")
        self.step = 0
        self.frames_seen = 0
        self.snapshots_saved = 0
        self.generator = torch.Generator(device=self.device).manual_seed(
            seed)
        self._seeds = torch.Generator().manual_seed(seed)

    def _prepare(self, batch: Dict[str, np.ndarray], train: bool):
        feats, feat_lens = self.featurize(
            torch.from_numpy(batch["wavs"]),
            torch.from_numpy(batch["wav_lens"]), train=train,
            generator=self.generator if train else None)
        out = (feats, feat_lens,
               torch.from_numpy(batch["labels"]).to(self.device),
               torch.from_numpy(batch["label_lens"]).to(self.device))
        if "cat_embs" in batch:
            # the LSL conditioning vector, the model's fifth argument
            out = out + (torch.from_numpy(
                np.asarray(batch["cat_embs"], np.float32)).to(self.device),)
        if train and self.batch_shard is not None:
            out = self.batch_shard(out)
        a = self.accum_steps
        if train and a > 1:
            B = out[0].shape[0]
            if B % a:
                raise ValueError(f"batch of {B} is not divisible by "
                                 f"accum_grad {a}")
            out = tuple(x.reshape((a, B // a) + x.shape[1:]) for x in out)
        return out

    def train_epoch(self, state, batches: Iterable[Dict[str, np.ndarray]],
                    epoch: int = 0, cv_batches: Optional[Callable] = None,
                    lr_of_step: Optional[Callable] = None):
        t0 = time.time()
        for batch_idx, raw in enumerate(batches):
            dev_batch = self._prepare(raw, train=True)
            seed = int(torch.randint(0, 2 ** 31 - 1, (),
                                     generator=self._seeds))
            state, loss, metrics = self.train_step(state, dev_batch, seed)
            self.step += 1
            self.frames_seen += int(np.sum(raw["wav_lens"])) // 160
            if batch_idx % self.log_interval == 0:
                lr = float(lr_of_step(self.step)) if lr_of_step else None
                vals = {k: float(v) for k, v in metrics.items()}
                loss_v = float(loss)
                if self.metrics_logger is not None:
                    self.metrics_logger.log(
                        self.step, dict(vals, loss=loss_v,
                                        frames_seen=self.frames_seen,
                                        **({"lr": lr} if lr is not None
                                           else {})))
                log.info("epoch %d batch %d step %d loss %.4f %s lr %s "
                         "(%.1f s)", epoch, batch_idx, self.step, loss_v,
                         " ".join(f"{k}={v:.4f}" for k, v in vals.items()),
                         f"{lr:.2e}" if lr else "-", time.time() - t0)
            if (self.save_interval > 0
                    and self.step % self.save_interval == 0
                    and self.model_dir):
                self._mid_epoch_snapshot(state, epoch, cv_batches)
        return state

    def _mid_epoch_snapshot(self, state, epoch, cv_batches):
        info = {"epoch": epoch, "step": self.step,
                "frames_seen": self.frames_seen, "tag": "snapshot"}
        if cv_batches is not None:
            cv_loss = self.cv(state.params, cv_batches())
            info["cv_loss"] = float(cv_loss)
            log.info("step %d cv_loss %.4f", self.step, cv_loss)
            if self.metrics_logger is not None:
                self.metrics_logger.log(self.step, {"loss": cv_loss},
                                        prefix="cv")
        self.snapshots_saved += 1
        forced = self.model_dir and \
            checkpointing.check_forced_full_snapshot_flag(self.model_dir)
        with_opt = forced or (
            self.snapshots_saved % self.save_optimizer_every == 0)
        path = checkpointing.snapshot_name(
            self.model_dir, step=self.step, with_optimizer=with_opt,
            use_named=self.use_named_snapshots)
        path = checkpointing.save_checkpoint(
            path, self.state_dict_of(state.params),
            state.opt_state if with_opt else None, info)
        if self.metrics_logger is not None:
            self.metrics_logger.log_checkpoint(path, metadata=info,
                                               with_optimizer=with_opt)

    def cv(self, params, batches: Iterable[Dict[str, np.ndarray]]):
        total, count = 0.0, 0
        for raw in batches:
            dev_batch = self._prepare(raw, train=False)
            loss, _ = self.eval_loss(params, dev_batch)
            bs = len(raw["keys"])
            total += float(loss) * bs
            count += bs
        return total / max(count, 1)

    def save_epoch(self, state, epoch: int, cv_loss: float = None):
        if not self.model_dir:
            return
        info = {"epoch": epoch, "step": self.step,
                "frames_seen": self.frames_seen, "tag": f"epoch_{epoch}"}
        if cv_loss is not None:
            info["cv_loss"] = float(cv_loss)
        path = checkpointing.snapshot_name(self.model_dir, epoch=epoch)
        checkpointing.save_checkpoint(path, self.state_dict_of(state.params),
                                      state.opt_state, info)
