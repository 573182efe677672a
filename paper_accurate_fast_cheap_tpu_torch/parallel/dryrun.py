"""The multichip dry run: each parallel form against one rank (the port's
counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``).

:func:`dryrun_multichip` runs on every rank of an initialised process group
of n ranks and makes the seven checks of JAX's dry run, each against the
same computation on one rank (every rank also computes the unsharded
reference), within JAX's bounds:

1. dp: one training step (loss, gradient norm, parameters after Adam) of a
   2-block bi-RWKV ``ASRModel`` on a global batch of 2n, the batch sharded
   over the ranks, against the step on the whole batch (1e-5 relative);
2. dp x tp(2) (n >= 4): the loss with the FFNs and vocab heads tensor-
   parallel and the batch over the data axis (1e-5 relative);
3. sequence-parallel WKV: K1's summary and replay passes with T = 32 n
   over the ranks, against K1 on the whole sequence (2e-4);
4. the sequence-parallel full model from raw features (halo'd ds4, sp
   WKV, conv halo, CTC head) against the unsharded model on the window
   zero-padded by 6 frames (5e-4);
5. ep (n >= 4): an n-expert MoE FFN with its experts over the ranks
   (1e-5);
6. the GPipe pipeline over n stages, forward (1e-5), and
7. its backward: the stages' gradients against the sequential stack's
   (1e-3 relative).

It prints one line per check with its error and returns {check: error}.
:func:`spawn_dryrun` starts n ranks (``torch.multiprocessing``, a
``file://`` rendezvous, the backend of ``mesh.choose_backend``: gloo when
they share one card) and returns rank 0's results and collective counts.
Run alone: ``python -m paper_accurate_fast_cheap_tpu_torch.parallel.dryrun
--n 4 [--device cpu]``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from paper_accurate_fast_cheap_tpu_torch.parallel import collectives as cc
from paper_accurate_fast_cheap_tpu_torch.parallel import mesh as mesh_lib

BOUNDS = {"dp": 1e-5, "dp_tp": 1e-5, "sp_wkv": 2e-4, "sp_full": 5e-4,
          "ep": 1e-5, "pp_forward": 1e-5, "pp_backward": 1e-3}
VOCAB = 32


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _randn(shape, seed: int, dev, scale: float = 1.0, shift: float = 0.0):
    return (torch.randn(shape, generator=_gen(seed)) * scale + shift).to(dev)


def params_rel_err(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]):
    """max |a - b| over every parameter, relative to the largest |b|.
    (Adam's first step moves each element by about the learning rate
    whatever its gradient's size, so a per-tensor ratio on a tensor of
    zeros would measure the sign of f32 noise.)"""
    return (max(float((a[k] - b[k]).abs().max()) for k in b)
            / max(float(b[k].abs().max()) for k in b))


def _asr_model(dev):
    from paper_accurate_fast_cheap_tpu_torch.models.asr_model import ASRModel
    from paper_accurate_fast_cheap_tpu_torch.models.layers import (
        init_default)

    model = ASRModel(
        VOCAB, dict(input_size=80, output_size=64, attention_heads=4,
                    linear_units=128, num_blocks=2, dropout_rate=0.0,
                    positional_dropout_rate=0.0,
                    selfattention_layer_type="rwkv_tmix60_bidirectional"),
        dict(attention_heads=4, linear_units=128, num_blocks=1,
             r_num_blocks=1, dropout_rate=0.0, positional_dropout_rate=0.0),
        ctc_weight=0.3, reverse_weight=0.3)
    init_default(model, _gen(0))
    return model.to(dev).train()


def _asr_batch(n: int, dev):
    B, T, U = 2 * n, 64, 8
    g = _gen(42)
    return (torch.randn(B, T, 80, generator=g).to(dev),
            torch.full((B,), T, dtype=torch.int64, device=dev),
            torch.randint(1, VOCAB - 1, (B, U), generator=g).to(dev),
            torch.full((B,), U, dtype=torch.int64, device=dev))


def check_dp(n: int, dev) -> float:
    """One Adam step, the batch over the data axis, against one rank."""
    from paper_accurate_fast_cheap_tpu_torch.train import (
        schedulers, train_step as ts)

    model = _asr_model(dev)
    batch = _asr_batch(n, dev)
    mesh = mesh_lib.make_mesh(n, ("data",))
    mesh_lib.share_counts(mesh, model)

    def loss_fn(p, b, seed):
        ts.bind_params(model, p)
        out = model(*b)
        return out["loss"], {"loss_ctc": out["loss_ctc"].detach()}

    def run(b, sync):
        opt = ts.make_optimizer("adam", schedulers.warmup_lr(1e-3, 1000),
                                grad_clip=5.0)
        params = {k: v.detach().clone() for k, v in
                  model.named_parameters()}
        step = ts.make_train_step(loss_fn, opt, clip_hard_maxvalue=1e4,
                                  grad_sync=sync)
        state, loss, m = step(ts.init_train_state(params, opt), b, 1)
        return state.params, loss, m["grad_norm"]

    p_dp, loss_dp, gn_dp = run(mesh_lib.shard_batch(mesh, batch),
                               mesh_lib.dp_sync(mesh))
    p_1, loss_1, gn_1 = run(batch, None)
    err = max(params_rel_err(p_dp, p_1), float(abs(loss_dp - loss_1) / loss_1),
              float(abs(gn_dp - gn_1) / gn_1))
    _say(n, f"dp loss={float(loss_dp):.4f} grad_norm={float(gn_dp):.4f} "
         f"max rel err vs one rank = {err:.2e}")
    return err


def check_dp_tp(n: int, dev) -> float:
    """The loss with tp(2) parameters and the batch over the data axis."""
    model = _asr_model(dev)
    batch = _asr_batch(n, dev)
    with torch.no_grad():
        ref = float(model(*batch)["loss"])
        mesh = mesh_lib.make_dp_tp_mesh(n, tp=2)
        mesh_lib.shard_params_tp(mesh, model)
        with mesh:
            local = model(*mesh_lib.shard_batch(mesh, batch))["loss"]
            loss = float(cc.psum(local, "data")) / mesh.shape["data"]
    err = abs(loss - ref) / abs(ref)
    _say(n, f"dp x tp(2) loss={loss:.4f} rel err vs one rank = {err:.2e}")
    return err


def check_sp_wkv(n: int, dev) -> float:
    from paper_accurate_fast_cheap_tpu_torch.ops.wkv6_cuda import wkv6_cuda
    from paper_accurate_fast_cheap_tpu_torch.parallel.sequence import (
        wkv6_sequence_parallel)

    B, T, H, N = 2, 32 * n, 2, 16
    shape = (B, T, H, N)
    r, k, v = (_randn(shape, 70 + i, dev, 0.5 if i == 1 else 1.0)
               for i in range(3))
    w = _randn(shape, 73, dev, shift=-2.0)
    u = _randn((H, N), 74, dev, 0.1)
    mesh = mesh_lib.make_mesh(n, ("seq",))
    with torch.no_grad():
        y_sp = wkv6_sequence_parallel(r, k, v, w, u, mesh)
        y_1 = wkv6_cuda(r, k, v, w, u)
    err = float((y_sp - y_1).abs().max())
    _say(n, f"seq-parallel wkv max|err| vs one rank = {err:.2e}")
    return err


def _enc_ctc(spmd, dev, input_size: int = 80, vocab: int = VOCAB):
    """The dry run's encoder + CTC head (2 bi-RWKV blocks, d 32, f32),
    with ``spmd_axis`` ``spmd``; weights from seed 13."""
    from paper_accurate_fast_cheap_tpu_torch.models.conformer import (
        ConformerEncoder)
    from paper_accurate_fast_cheap_tpu_torch.models.ctc_head import CTCHead
    from paper_accurate_fast_cheap_tpu_torch.models.layers import (
        init_default)

    m = nn.Module()
    m.encoder = ConformerEncoder(
        input_size=input_size, output_size=32, attention_heads=2,
        linear_units=48, num_blocks=2, dropout_rate=0.0,
        positional_dropout_rate=0.0, cnn_module_kernel=7,
        selfattention_layer_type="rwkv_tmix60_bidirectional",
        rwkv_conf={"rwkv_do_bfloat16": False, "spmd_axis": spmd})
    m.ctc = CTCHead(32, vocab)
    init_default(m, _gen(13))
    return m.to(dev).eval()


def _sp_logits(model, feats, mesh, axis: str = "seq"):
    """``model``'s (an :func:`_enc_ctc` with ``spmd_axis``) CTC logits with
    T sharded over ``mesh``: this rank's shard in, the whole logits out."""
    with mesh:
        n, i = cc.axis_size(axis), cc.axis_index(axis)
        t = feats.shape[1] // n
        lens = torch.full((feats.shape[0],), t, device=feats.device)
        enc, _ = model.encoder(feats[:, i * t:(i + 1) * t], lens)
        return cc.all_gather(model.ctc(enc), axis, dim=1, tiled=True)


def check_sp_full(n: int, dev) -> float:
    T = 32 * n
    feats = _randn((2, T, 80), 12, dev)
    ref = _enc_ctc(None, dev)
    sp = _enc_ctc("seq", dev)
    sp.load_state_dict(ref.state_dict())
    with torch.no_grad():
        enc, _ = ref.encoder(F.pad(feats, (0, 0, 0, 6)),
                             torch.full((2,), T + 6, device=dev))
        y_ref = ref.ctc(enc)
        y_sp = _sp_logits(sp, feats, mesh_lib.make_mesh(n, ("seq",)))
    err = float((y_sp - y_ref).abs().max())
    _say(n, f"seq-parallel FULL model (raw features -> ctc logits) "
         f"max|err| = {err:.2e}")
    return err


def check_ep(n: int, dev) -> float:
    from paper_accurate_fast_cheap_tpu_torch.models.convolution import (
        MoEFFNLayer)
    from paper_accurate_fast_cheap_tpu_torch.models.layers import (
        init_default)

    moe = MoEFFNLayer(d_model=32, hidden=64, n_experts=n,
                      n_expert_per_token=2)
    init_default(moe, _gen(9))
    moe = moe.to(dev)
    x = _randn((2, 16, 32), 8, dev)
    with torch.no_grad():
        y_rep = moe(x)
        mesh = mesh_lib.make_dp_tp_mesh(n, tp=n)
        mesh_lib.shard_params_ep(mesh, moe)
        with mesh:
            y_ep = moe(x)
    err = float((y_ep - y_rep).abs().max())
    _say(n, f"expert-parallel moe max|err| vs replicated = {err:.2e}")
    return err


class _Blk(nn.Module):
    """x + Dense(relu(Dense_24(x))), the JAX dry run's stage."""

    def __init__(self, d: int = 12, hidden: int = 24):
        super().__init__()
        self.Dense_0 = nn.Linear(d, hidden)
        self.Dense_1 = nn.Linear(hidden, d)


def _blk(p, x):
    return x + F.linear(F.relu(F.linear(x, p["Dense_0.weight"],
                                        p["Dense_0.bias"])),
                        p["Dense_1.weight"], p["Dense_1.bias"])


def _stage_params(n: int, dev):
    from paper_accurate_fast_cheap_tpu_torch.models.layers import (
        init_default)

    out = []
    for i in range(n):
        blk = _Blk()
        init_default(blk, _gen(20 + i))
        out.append({k: v.detach().to(dev)
                    for k, v in blk.state_dict().items()})
    return out


def check_pipeline(n: int, dev):
    from paper_accurate_fast_cheap_tpu_torch.parallel.pipeline import (
        own_stage, pipeline_apply, stack_stage_params)

    mesh = mesh_lib.make_mesh(n, ("stage",))
    x = _randn((2 * n, 6, 12), 10, dev)
    stacked = stack_stage_params(_stage_params(n, dev))
    with mesh:
        mine = {k: v.clone().requires_grad_(True)
                for k, v in own_stage(stacked, "stage").items()}
    y_pp = pipeline_apply(_blk, mine, x, mesh, axis="stage",
                          n_microbatches=n)
    seq = {k: v.clone().requires_grad_(True) for k, v in stacked.items()}
    y_seq = x
    for i in range(n):
        y_seq = _blk({k: v[i] for k, v in seq.items()}, y_seq)
    err_f = float((y_pp - y_seq).detach().abs().max())
    _say(n, f"pipeline({n} stages) max|err| vs sequential = {err_f:.2e}")
    (y_pp ** 2).sum().backward()
    (y_seq ** 2).sum().backward()
    err_b = _pp_grad_err(mine, seq, mesh)
    _say(n, f"pipeline BACKWARD max|grad err| vs sequential = {err_b:.2e}")
    return err_f, err_b


def _pp_grad_err(mine, seq, mesh) -> float:
    """The largest relative error of any stage's gradients: each rank
    holds its own stage's, the max is taken over the ranks."""
    with mesh:
        i = cc.axis_index("stage")
    err = max(float((mine[k].grad - seq[k].grad[i]).abs().max()
                    / (seq[k].grad.abs().max() + 1e-6)) for k in seq)
    with mesh:
        return float(cc.all_gather(torch.tensor(err), "stage").max())


def _say(n: int, msg: str) -> None:
    if mesh_lib.world()[0] == 0:
        print(f"dryrun_multichip({n}): {msg}", flush=True)


def dryrun_multichip(n_devices: int, device: str = "cuda"
                     ) -> Dict[str, float]:
    """The seven checks on this rank of a process group of ``n_devices``
    ranks, on ``device`` (``cuda`` unless the caller asks for the CPU).
    Raises RuntimeError when a check misses its bound."""
    n = n_devices
    if mesh_lib.world()[1] != n:
        raise ValueError(f"dryrun_multichip({n}) needs a process group of "
                         f"{n} ranks (have {mesh_lib.world()[1]})")
    dev = (torch.device("cuda", torch.cuda.current_device())
           if device == "cuda" else torch.device(device))
    errs = {"dp": check_dp(n, dev)}
    if n >= 4:
        errs["dp_tp"] = check_dp_tp(n, dev)
    errs["sp_wkv"] = check_sp_wkv(n, dev)
    errs["sp_full"] = check_sp_full(n, dev)
    if n >= 4:
        errs["ep"] = check_ep(n, dev)
    errs["pp_forward"], errs["pp_backward"] = check_pipeline(n, dev)
    bad = {k: e for k, e in errs.items() if not e < BOUNDS[k]}
    if bad:
        raise RuntimeError(f"dryrun_multichip({n}): over the bounds {bad}")
    return errs


def _rank_main(rank: int, n: int, init: str, device: str, out: str) -> None:
    torch.set_num_threads(1)
    # the checks compare f32 results: no TF32 in cuBLAS or cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh_lib.init_distributed(device, init, n, rank, local_world_size=n)
    cc.reset_counts()
    errs = dryrun_multichip(n, device)
    if rank == 0:
        with open(out, "w") as f:
            json.dump({"errors": errs, "collectives": cc.read_counts(),
                       "backend": mesh_lib.world()[2]}, f)
    torch.distributed.destroy_process_group()


def spawn_dryrun(n: int, device: str = "cuda") -> dict:
    """Run :func:`dryrun_multichip` on ``n`` spawned ranks of this host;
    returns rank 0's {"errors", "collectives", "backend"}."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "rank0.json")
        mp.spawn(_rank_main, args=(n, f"file://{d}/rendezvous", device, out),
                 nprocs=n, join=True)
        with open(out) as f:
            return json.load(f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    print(json.dumps(spawn_dryrun(args.n, args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
