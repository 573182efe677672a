"""Rank functions for ``tests/test_torch_parallel.py`` (not collected).

The ranks are gloo processes from ``torch.multiprocessing``; this module
imports only torch, numpy and the port, so the children never import JAX.
The parent (which computes the JAX references) hands the inputs over as
one ``torch.save`` payload and reads rank 0's results back the same way.
"""
import os
import time

import numpy as np
import torch
import torch.multiprocessing as mp
import torch.nn.functional as F

from paper_accurate_fast_cheap_tpu_torch.models import factory
from paper_accurate_fast_cheap_tpu_torch.parallel import collectives as cc
from paper_accurate_fast_cheap_tpu_torch.parallel import mesh as mesh_lib


def spawn(fn, n: int, workdir: str, payload=None, timeout: float = 300.0):
    """Run ``fn(rank, n, payload) -> results`` on ``n`` gloo CPU ranks
    (``file://`` rendezvous in ``workdir``); returns rank 0's results.
    A rank that is still running after ``timeout`` seconds fails the call
    (the processes are terminated) instead of hanging the suite."""
    pin = os.path.join(workdir, "payload.pt")
    out = os.path.join(workdir, "rank0.pt")
    torch.save(payload, pin)
    ctx = mp.start_processes(_entry, args=(n, workdir, fn, pin, out),
                             nprocs=n, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.terminate()
            raise TimeoutError(f"{fn.__name__} on {n} ranks: still running "
                               f"after {timeout} s")
    return torch.load(out, weights_only=False)


def _entry(rank, n, workdir, fn, pin, out):
    torch.set_num_threads(1)
    payload = torch.load(pin, weights_only=False)
    res = fn(rank, n, workdir, payload)
    if rank == 0:
        torch.save(res, out)


def _init(rank, n, workdir):
    mesh_lib.init_distributed("cpu", f"file://{workdir}/rendezvous", n, rank)


def _gather_t(y, mesh, axis="seq"):
    with mesh:
        return cc.all_gather(y, axis, dim=1, tiled=True)


def _shard_t(x, mesh, axis="seq"):
    ax = mesh.axes[axis]
    t = x.shape[1] // ax.size
    return x[:, ax.index * t:(ax.index + 1) * t]


def _sp_call(mesh, module, x, *args, **kw):
    """``module`` on this rank's T-shard of ``x`` inside ``mesh``."""
    with mesh:
        return module(_shard_t(x, mesh), *args, **kw)


def _module(cls, state, *args, **kw):
    m = cls(*args, **kw)
    m.load_state_dict(state)
    return m.eval()


def sp_and_model_parallel(rank, n, workdir, p):
    """Sequence, tensor, expert and pipeline parallelism, then the dp
    step, then ``recognize_wav --seq_parallel n`` (which ends the process
    group)."""
    from paper_accurate_fast_cheap_tpu_torch.bin import recognize_wav
    from paper_accurate_fast_cheap_tpu_torch.models.convolution import (
        MoEFFNLayer)
    from paper_accurate_fast_cheap_tpu_torch.models.conformer import (
        ConformerEncoder)
    from paper_accurate_fast_cheap_tpu_torch.models.mamba import (
        MambaAttention)
    from paper_accurate_fast_cheap_tpu_torch.models.rwkv import RWKVAttention
    from paper_accurate_fast_cheap_tpu_torch.parallel import (
        pipeline, pp_encoder, sequence as sp)
    from paper_accurate_fast_cheap_tpu_torch.train import (
        schedulers, train_step as ts)

    _init(rank, n, workdir)
    res = {}
    seq = mesh_lib.make_mesh(n, ("seq",))
    with torch.no_grad():
        w = p["wkv"]
        res["wkv_y"] = sp.wkv6_sequence_parallel(
            *(w[k] for k in "rkvwu"), seq)
        res["wkv_y_s"], res["wkv_S"] = sp.wkv6_sequence_parallel(
            *(w[k] for k in "rkvwu"), seq, state=w["S0"], return_state=True)

        x, wc = p["halo"]["x"], p["halo"]["w"]
        K = wc.shape[0]
        with seq:
            xp = sp.halo_exchange(_shard_t(x, seq), "seq", K // 2, K // 2)
        tl = xp.shape[1] - (K - 1)
        res["halo"] = _gather_t(sum(xp[:, k:k + tl] * wc[k]
                                    for k in range(K)), seq)
        with seq:
            flipped = sp.flip_sharded(_shard_t(p["flip"], seq), "seq")
        res["flip"] = _gather_t(flipped, seq)

        s = p["ssd"]
        res["ssd"] = sp.ssd_sequence_parallel(
            s["x"], s["dt"], s["A"], s["B"], s["C"], s["D"], seq,
            chunk_size=16)

        rw = p["rwkv_layer"]
        att_rwkv = _module(RWKVAttention, rw["state"], **rw["kw"],
                           spmd_axis="seq")
        with seq:
            res["rwkv_layer"] = _gather_t(att_rwkv(_shard_t(rw["x"], seq)),
                                          seq)
        mb = p["mamba_layer"]
        att = _module(MambaAttention, mb["state"], **mb["kw"],
                      spmd_axis="seq")
        with seq:
            res["mamba_layer"] = _gather_t(att(_shard_t(mb["x"], seq)),
                                           seq)

        full = p["sp_full"]
        enc = _module(ConformerEncoder, full["state"],
                      **dict(full["conf"], rwkv_conf=dict(
                          full["conf"]["rwkv_conf"], spmd_axis="seq")))
        cc.reset_counts()
        with seq:
            xs = _shard_t(full["x"], seq)
            y, _ = enc(xs, torch.full((xs.shape[0],), xs.shape[1]))
        res["sp_full_counts"] = cc.read_counts()
        res["sp_full"] = _gather_t(y, seq)

        # JAX's refusals: ragged T, lengths, a ds4 shard not divisible by 4
        refused = []
        for call in (
                lambda: sp.wkv6_sequence_parallel(
                    *(w[k][:, :-2] for k in "rkvw"), w["u"], seq),
                lambda: _sp_call(seq, att_rwkv, rw["x"],
                                 lengths=torch.tensor([8, 8])),
                lambda: _sp_call(seq, enc, full["x"][:, :-8],
                                 torch.full((2,), 30))):
            try:
                call()
            except ValueError as e:
                refused.append(str(e))
        res["refusals"] = refused

        moe = _module(MoEFFNLayer, p["moe"]["state"], **p["moe"]["kw"])
        res["ep_rep"] = moe(p["moe"]["x"])
        ep = mesh_lib.make_dp_tp_mesh(n, tp=n)
        mesh_lib.shard_params_ep(ep, moe)
        with ep:
            res["ep"] = moe(p["moe"]["x"])

    # the GPipe pipeline over n stages, forward and gradients
    stage = mesh_lib.make_mesh(n, ("stage",))
    pipe = p["pipe"]
    with stage:
        mine = {k: v.clone().requires_grad_(True) for k, v in
                pipeline.own_stage(pipe["stacked"], "stage").items()}
    y = pipeline.pipeline_apply(_blk, mine, pipe["x"], stage,
                                axis="stage", n_microbatches=pipe["M"])
    res["pipe_y"] = y.detach()
    (y ** 2).sum().backward()
    with stage:
        res["pipe_grads"] = {k: cc.all_gather(v.grad, "stage")
                             for k, v in mine.items()}

    # the ASR model: dp x tp(2) forward, pp forward and pp gradients,
    # then the dp step
    a = p["asr"]

    def asr_model():
        m, _ = factory.init_model(a["config"], a["vocab"], a["idim"],
                                  device="cpu")
        m.load_state_dict(a["state"])
        return m

    batch = a["batch"]
    with torch.no_grad():
        m = asr_model().eval()
        dptp = mesh_lib.make_dp_tp_mesh(n, tp=2)
        mesh_lib.shard_params_tp(dptp, m)
        with dptp:
            local = m(*mesh_lib.shard_batch(dptp, batch))["loss"]
            res["dp_tp_loss"] = cc.psum(local, "data") / dptp.shape["data"]
        m = asr_model().eval()
        res["pp_enc"], res["pp_lens"] = pp_encoder.pp_encoder_forward(
            m.encoder, batch[0], batch[1], stage, n_microbatches=n)

    m = asr_model()
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in m.named_parameters()}
    loss, _ = pp_encoder.make_pp_loss_fn(m, stage)(leaves, batch, 0)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    grads = {k: torch.zeros_like(v) if g is None else g
             for (k, v), g in zip(leaves.items(), grads)}
    res["pp_loss"] = loss.detach()
    res["pp_grads"], _, _ = pp_encoder.pp_grad_sync(m, stage)(grads, loss,
                                                               {})

    m = asr_model().train()
    data = mesh_lib.make_mesh(n, ("data",))
    mesh_lib.share_counts(data, m)

    def loss_fn(params, b, seed):
        ts.bind_params(m, params)
        out = m(*b)
        return out["loss"], {}

    opt = ts.make_optimizer("adam", schedulers.warmup_lr(*a["lr"]),
                            grad_clip=5.0)
    step = ts.make_train_step(loss_fn, opt, grad_sync=mesh_lib.dp_sync(data))
    params = {k: v.detach() for k, v in m.named_parameters()}
    state, res["dp_loss"], metrics = step(
        ts.init_train_state(params, opt), mesh_lib.shard_batch(data, batch),
        1)
    res["dp_grad_norm"] = metrics["grad_norm"]
    res["dp_params"] = state.params
    res["collectives"] = cc.read_counts()

    assert recognize_wav.main(p["cli_argv"]) == 0
    return res


def _blk(p, x):
    """x + Dense_0(relu(Dense_1(x))): the JAX tests' pipeline stage, whose
    flax ``Dense_0`` is the outer (created first) of its two Denses."""
    return x + F.linear(F.relu(F.linear(x, p["Dense_1.weight"],
                                        p["Dense_1.bias"])),
                        p["Dense_0.weight"], p["Dense_0.bias"])


def train_cli(rank, n, workdir, argv):
    """``bin/train.py`` on this rank (it initialises the process group);
    TensorBoard's import is kept out, as in the parent's run."""
    import sys

    from paper_accurate_fast_cheap_tpu_torch.bin import train

    sys.modules["torch.utils.tensorboard"] = None
    assert train.main(argv + [
        "--dist_coordinator", f"file://{workdir}/rendezvous",
        "--dist_num_processes", str(n), "--dist_process_id", str(rank)]) == 0
    return {"rank": rank, "pid": os.getpid()}


def as_numpy(tree):
    """Tensors of a results tree -> numpy arrays."""
    if isinstance(tree, dict):
        return {k: as_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(as_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().float().numpy()
    return np.asarray(tree) if isinstance(tree, (int, float)) else tree
