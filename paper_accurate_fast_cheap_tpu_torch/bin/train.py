"""Training CLI (port of the JAX ``bin/train.py``): tar shards (or raw or
zip lists) -> the training data pipeline -> features on the device -> the
train step, epochs with cv, checkpoints that ``average_model``,
``recognize_wav``, ``recognize`` and ``api.load_model`` read.

The JAX CLI's flags, plus ``--device`` (``cuda`` unless ``cpu`` is asked
for).  The config (``--override_config a.b=value``, repeatable) gives the
tokenizer, the global CMVN, the model (weights from ``--seed``), the
scheduler, the optimizer (optax's chain, ``train/train_step.py``) with
``restrict_learning``, ``dtype: bf16`` for bf16 compute over f32 master
weights, ``accum_grad`` and ``clip_hard_maxvalue``.  ``--checkpoint``
resumes from a checkpoint name or its ``.pt`` file: the model, the
optimizer state when saved, and the step and epoch from its sidecar.  The
run directory gets ``train.yaml``, ``logs/metrics.jsonl`` and the
checkpoints (``train/checkpointing.py``).

Ranks (``torch.distributed``, ``parallel/``): ``--dist_auto`` takes the
process group from torchrun's environment, ``--dist_coordinator host:port
--dist_num_processes N --dist_process_id i`` from a coordinator; the
backend is ``nccl`` when every rank has a card of its own and ``gloo``
when ranks share a card or run on the CPU (``parallel/mesh.choose_backend``).
``--multichip``: data parallelism over the world group: every rank builds
the same global batch (the same shuffle seed) and takes its slice, and the
gradients are averaged over the ranks before the clip.  ``--pp_stages S``
(a world of S ranks): the encoder's blocks pipelined over the ranks (GPipe,
``--pp_microbatches`` microbatches, default S; the blocks without dropout),
the block gradients summed over the stages.  Only rank 0 writes the run
directory (config, logs, checkpoints).

Usage:
  python -m paper_accurate_fast_cheap_tpu_torch.bin.train \\
      --config conf/train.yaml --train_data shards.txt --cv_data cv.txt \\
      --data_type shard --model_dir exp/run1 [--device cpu]
  torchrun --nproc_per_node 2 \\
      -m paper_accurate_fast_cheap_tpu_torch.bin.train \\
      ... --dist_auto --multichip [--device cpu]
"""
from __future__ import annotations

import argparse
import logging
import os
import sys

import torch


def get_args(argv=None):
    p = argparse.ArgumentParser(description="train an ASR model")
    p.add_argument("--config", required=True)
    p.add_argument("--train_data", required=True)
    p.add_argument("--cv_data", default=None)
    p.add_argument("--data_type", default="shard",
                   choices=["raw", "shard", "zip_shard"])
    p.add_argument("--model_dir", required=True)
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint to resume from (name or .pt file)")
    p.add_argument("--override_config", action="append", default=[])
    p.add_argument("--num_epochs", type=int, default=None)
    p.add_argument("--seed", type=int, default=777)
    p.add_argument("--multichip", action="store_true",
                   help="data parallel over every rank of the process "
                        "group")
    p.add_argument("--pp_stages", type=int, default=0,
                   help="pipeline parallel: the encoder's blocks over this "
                        "many ranks (GPipe; no dropout in the blocks)")
    p.add_argument("--pp_microbatches", type=int, default=None,
                   help="microbatches for --pp_stages (default = stages)")
    p.add_argument("--dist_auto", action="store_true",
                   help="process group from torchrun's environment")
    p.add_argument("--dist_coordinator", default=None,
                   help="coordinator host:port (every process passes the "
                        "same value)")
    p.add_argument("--dist_num_processes", type=int, default=None)
    p.add_argument("--dist_process_id", type=int, default=None)
    p.add_argument("--print_model", action="store_true")
    p.add_argument("--use_wandb", action="store_true")
    p.add_argument("--wandb_project", default=None)
    p.add_argument("--load_from_wandb", default=None,
                   help="wandb project to resume from (latest optimizer-"
                        "bearing checkpoint artifact)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def _init_ranks(args):
    """(device, rank, the parallel mesh or None) from the ``--dist_*``,
    ``--multichip`` and ``--pp_stages`` flags."""
    from paper_accurate_fast_cheap_tpu_torch import resolve_device
    from paper_accurate_fast_cheap_tpu_torch.parallel import mesh as mesh_lib

    dev = None
    if args.dist_auto:
        dev = mesh_lib.init_distributed(args.device)
    elif args.dist_coordinator:
        dev = mesh_lib.init_distributed(
            args.device, args.dist_coordinator, args.dist_num_processes,
            args.dist_process_id)
    dev = dev or resolve_device(args.device)
    rank, world, _ = mesh_lib.world()
    if args.multichip and args.pp_stages:
        raise ValueError("--multichip and --pp_stages: one parallel form "
                         "at a time")
    mesh = None
    if args.multichip:
        if world < 2:
            raise ValueError("--multichip needs an initialised process "
                             "group of more than one rank (--dist_auto "
                             "under torchrun, or --dist_coordinator)")
        mesh = mesh_lib.make_mesh(world, ("data",))
        logging.info("data parallelism over %d ranks", world)
    elif args.pp_stages:
        if world != args.pp_stages:
            raise ValueError(f"--pp_stages {args.pp_stages} needs a process "
                             f"group of that many ranks (have {world})")
        mesh = mesh_lib.make_mesh(world, ("stage",))
        logging.info("pipeline parallelism: %d stages", world)
    return dev, rank, mesh


def main(argv=None):
    args = get_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    dev, rank, mesh = _init_ranks(args)
    from paper_accurate_fast_cheap_tpu_torch.data import (
        pipeline as data_pipeline)
    from paper_accurate_fast_cheap_tpu_torch.frontend import cmvn as cmvn_lib
    from paper_accurate_fast_cheap_tpu_torch.frontend.pipeline import (
        make_feature_fn)
    from paper_accurate_fast_cheap_tpu_torch.models import factory
    from paper_accurate_fast_cheap_tpu_torch.parallel import (
        mesh as mesh_lib, pp_encoder)
    from paper_accurate_fast_cheap_tpu_torch.text.tokenizers import (
        init_tokenizer)
    from paper_accurate_fast_cheap_tpu_torch.train import (
        checkpointing, executor as executor_lib, schedulers,
        train_step as ts)
    from paper_accurate_fast_cheap_tpu_torch.train.metrics_logger import (
        MetricsLogger, download_checkpoint_from_wandb)
    from paper_accurate_fast_cheap_tpu_torch.utils.config import (
        load_config, override_config, save_config)

    config = override_config(load_config(args.config),
                             args.override_config)
    tokenizer = init_tokenizer(config)
    vocab_size = tokenizer.vocab_size()
    cmvn_stats = None
    if config.get("cmvn") == "global_cmvn":
        cc = config.get("cmvn_conf", {})
        cmvn_stats = cmvn_lib.load_cmvn(cc["cmvn_file"],
                                        cc.get("is_json_cmvn", True))
    dataset_conf = config.get("dataset_conf", {})
    input_dim = dataset_conf.get("fbank_conf", {}).get("num_mel_bins", 80)
    model, model_type = factory.init_model(
        config, vocab_size, input_dim, device=dev,
        generator=torch.Generator().manual_seed(args.seed))
    model.encoder.chunk_generator = torch.Generator().manual_seed(args.seed)
    model.train()
    featurize = make_feature_fn(dataset_conf, cmvn_stats, device=dev)
    params = {n: p.detach() for n, p in model.named_parameters()}
    if args.print_model:
        n = sum(p.numel() for p in params.values())
        print(f"model: {model_type}, params: {n/1e6:.2f} M")

    optim_conf = config.get("optim_conf", {})
    sched = schedulers.SCHEDULERS[config.get("scheduler", "warmuplr")](
        optim_conf.get("lr", 1e-3),
        config.get("scheduler_conf", {}).get("warmup_steps", 25000))
    trainable_mask = None
    rl = config.get("restrict_learning")
    if rl:
        trainable_mask = ts.restrict_learning_mask(
            params, exclude=rl.get("exclude"), include=rl.get("include"))
    optimizer = ts.make_optimizer(
        config.get("optim", "adam"), sched,
        weight_decay=optim_conf.get("weight_decay", 0.0),
        grad_clip=config.get("grad_clip", 5.0))

    def loss_fn(p, batch, seed):
        torch.manual_seed(seed)  # the step's dropout masks
        model.train()
        ts.bind_params(model, p)
        out = model(*batch)
        return out["loss"], {k: v.detach() for k, v in out.items()
                             if k != "loss"}

    grad_sync = batch_shard = None
    if args.multichip:
        mesh_lib.share_counts(mesh, model)
        grad_sync = mesh_lib.dp_sync(mesh)
        batch_shard = lambda b: mesh_lib.shard_batch(mesh, b)  # noqa: E731
    elif args.pp_stages:
        loss_fn = pp_encoder.make_pp_loss_fn(
            model, mesh, n_microbatches=args.pp_microbatches)
        grad_sync = pp_encoder.pp_grad_sync(model, mesh)

    train_dtype = str(config.get("dtype", "fp32")).lower()
    if train_dtype in ("bf16", "bfloat16"):
        loss_fn = ts.wrap_mixed_precision(loss_fn)
        logging.info("mixed precision: bf16 compute over fp32 master")
    elif train_dtype not in ("fp32", "float32"):
        raise SystemExit(f"unsupported dtype {train_dtype!r} "
                         "(fp32 or bf16)")
    accum = config.get("accum_grad", 1)
    step_fn = ts.make_train_step(
        loss_fn, optimizer, accum_steps=accum,
        clip_hard_maxvalue=config.get("clip_hard_maxvalue", 0.0),
        trainable_mask=trainable_mask, grad_sync=grad_sync)
    state = ts.init_train_state(params, optimizer)

    start_epoch = 0
    if args.load_from_wandb and not args.checkpoint:
        fetched = download_checkpoint_from_wandb(args.load_from_wandb)
        if fetched:
            args.checkpoint = fetched
            logging.info("resuming from wandb snapshot %s", fetched)
        else:
            logging.warning("--load_from_wandb: no snapshot found "
                            "(or wandb unavailable); fresh start")
    if args.checkpoint:
        sd, opt, info = checkpointing.load_checkpoint(args.checkpoint)
        model.load_state_dict(sd, strict=True)
        params = {n: p.detach() for n, p in model.named_parameters()}
        opt_state = state.opt_state
        if opt is not None:
            opt_state = dict(opt, mu={n: opt["mu"][n].to(dev)
                                      for n in params},
                             nu={n: opt["nu"][n].to(dev) for n in params})
        state = ts.TrainState(int(info.get("step", 0)), params, opt_state)
        start_epoch = int(info.get("epoch", -1)) + 1

    def eval_loss(p, batch):
        model.eval()
        ts.bind_params(model, p)
        with torch.no_grad():
            out = model(*batch)
        model.train()
        return out["loss"], out

    def state_dict_of(p):
        sd = model.state_dict()
        sd.update({n: t.detach() for n, t in p.items()})
        return sd

    # only rank 0 writes the run directory
    model_dir = args.model_dir if rank == 0 else None
    logger = None
    if model_dir:
        os.makedirs(model_dir, exist_ok=True)
        save_config(config, os.path.join(model_dir, "train.yaml"))
        logger = MetricsLogger(os.path.join(model_dir, "logs"),
                               use_wandb=args.use_wandb,
                               wandb_config={"project": args.wandb_project,
                                             "config": config})
    if logger is not None and args.use_wandb:
        tok_conf = config.get("tokenizer_conf", {})
        logger.log_run_artifacts(
            code_dir=os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))),
            data_lists=[args.train_data, args.cv_data],
            tokenizer_files=[tok_conf.get("symbol_table_path"),
                             tok_conf.get("bpe_path")])
    snap_conf = config.get("snapshot_saving_conf", {})
    ex = executor_lib.Executor(
        step_fn, eval_loss, featurize, model_dir=model_dir,
        log_interval=config.get("log_interval", 100),
        save_interval=snap_conf.get("save_interval", 0),
        save_optimizer_every=snap_conf.get("save_optimizer_every", 10),
        use_named_snapshots=snap_conf.get("use_named_snapshots", False),
        seed=args.seed, metrics_logger=logger, device=dev,
        state_dict_of=state_dict_of, accum_steps=accum,
        batch_shard=batch_shard)
    ex.step = int(state.step)
    num_epochs = args.num_epochs or config.get("max_epoch", 1)

    def train_batches(epoch):
        return data_pipeline.build_dataset(
            args.data_type, args.train_data, tokenizer, dataset_conf,
            partition=True, mode="train", seed=args.seed + epoch)

    def cv_batches():
        if args.cv_data is None:
            return iter(())
        cv_conf = dict(dataset_conf, speed_perturb=False, spec_aug=False,
                       shuffle=False)
        return data_pipeline.build_dataset(
            args.data_type, args.cv_data, tokenizer, cv_conf,
            partition=False, mode="cv")

    try:
        for epoch in range(start_epoch, num_epochs):
            state = ex.train_epoch(state, train_batches(epoch), epoch,
                                   cv_batches=cv_batches, lr_of_step=sched)
            cv_loss = (ex.cv(state.params, cv_batches()) if args.cv_data
                       else None)
            logging.info("epoch %d done, cv_loss=%s", epoch, cv_loss)
            ex.save_epoch(state, epoch, cv_loss)
    finally:
        if logger is not None:
            logger.close()
    if mesh is not None:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
