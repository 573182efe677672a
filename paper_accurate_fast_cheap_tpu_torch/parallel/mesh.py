"""Process meshes and parameter layouts (port of the JAX ``parallel/mesh.py``).

JAX lays out a ``jax.sharding.Mesh`` of devices and lets XLA insert the
collectives; here a :class:`Mesh` is a grid of ``torch.distributed`` ranks
with one process group per axis line, and the modules close their sharded
products with the collectives of ``parallel/collectives.py`` (the FFN's
row-parallel product and the MoE's combine with one ``psum``,
``models/convolution.py``; the vocab heads with a gather,
:class:`GatheredLinear`).
A mesh is entered as a context manager while the sharded code runs, so the
modules resolve their axis names in it, as JAX's bodies do in
``shard_map``.

* :func:`make_mesh` (one axis of n ranks, JAX's shape ``(n, 1, ...)`` for
  more names) and :func:`make_dp_tp_mesh` (``(n / tp, tp)``, axes
  ``data`` and ``model``; rank = d * tp + m).
* :func:`shard_batch`: rank r takes the r-th slice of every leaf's leading
  axis of the global batch; :func:`share_counts` makes the losses that
  divide by a count (tokens, frames) divide by the ranks' mean count, and
  :func:`dp_sync` averages the gradients, so the step is the global
  batch's.
* :func:`tp_param_spec` / :func:`tp_shardings` / :func:`shard_params_tp`:
  JAX's rules in the port's state-dict names and torch's (out, in)
  layout: FFN up-projections (``feed_forward``/``mlp`` ``Dense_0``) and
  the vocab heads (``ctc_lo``, ``output_layer``) shard their output rows,
  FFN down-projections (``Dense_1``) their input columns, the rest is
  replicated.  JAX replicates the 1-D biases and XLA slices them inside
  the product; here a column-parallel Linear keeps its bias's slice.
* :func:`ep_param_spec` / :func:`shard_params_ep`: ``MoEFFNLayer``'s
  expert-stacked ``w1`` and ``w2`` shard their expert axis.
* :func:`init_distributed` and :func:`choose_backend`: the process group
  from torchrun's environment or a coordinator address, its backend chosen
  from the layout before ``init_process_group`` (``nccl`` when every rank
  has a card of its own, ``gloo`` when ranks share a card or run on the
  CPU) and logged; nothing is retried or switched on a failure.
"""
from __future__ import annotations

import logging
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from paper_accurate_fast_cheap_tpu_torch.parallel import collectives
from paper_accurate_fast_cheap_tpu_torch.parallel.collectives import Axis

log = logging.getLogger(__name__)


def choose_backend(device: str, local_world_size: int) -> str:
    """``nccl`` when ``device`` is ``cuda`` and this host has a card for
    each of its ``local_world_size`` ranks, else ``gloo`` (ranks that
    share a card, or CPU ranks)."""
    if device == "cuda" and torch.cuda.device_count() >= local_world_size:
        return "nccl"
    return "gloo"


def init_distributed(device: str = "cuda", coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     local_world_size: Optional[int] = None) -> torch.device:
    """Initialise the default process group and return this rank's device.

    Without ``coordinator`` the rank, world size and rendezvous come from
    torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``); with it,
    ``tcp://<coordinator>`` (or the coordinator itself when it is a URL,
    such as ``file://<path>``) with ``num_processes`` and ``process_id``
    (every process passes the same address).  ``local_world_size`` (the
    ranks on this host) defaults to torchrun's, or to the world size.  A
    ``cuda`` rank runs on card ``LOCAL_RANK mod the card count``."""
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' for CPU ranks")
    if coordinator is None:
        rank = int(os.environ["RANK"])
        world = int(os.environ["WORLD_SIZE"])
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        init_method = "env://"
    else:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs num_processes and "
                             "process_id")
        rank, world, local_rank = process_id, num_processes, process_id
        init_method = (coordinator if "://" in coordinator
                       else f"tcp://{coordinator}")
    local = local_world_size or int(os.environ.get("LOCAL_WORLD_SIZE",
                                                   world))
    backend = choose_backend(device, local)
    log.info("torch.distributed: rank %d of %d, backend %s (%s ranks, %d "
             "on this host, %d cards)", rank, world, backend, device, local,
             torch.cuda.device_count() if device == "cuda" else 0)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank)
    if backend == "gloo" and device == "cuda":
        log.info("ranks share a card: collectives on CUDA tensors copy "
                 "through the host (counted as host_copy)")
    if device != "cuda":
        return torch.device("cpu")
    dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def world() -> Tuple[int, int, Optional[str]]:
    """(rank, world size, backend); (0, 1, None) without a process group."""
    if not dist.is_initialized():
        return 0, 1, None
    return dist.get_rank(), dist.get_world_size(), dist.get_backend()


class Mesh:
    """A grid of global ranks with named axes.  ``shape`` maps each axis
    name to its size (JAX's ``mesh.shape``); ``axes`` holds this rank's
    :class:`~parallel.collectives.Axis` for each name.  Every rank of the
    world builds the same mesh (the groups are created collectively).  As
    a context manager it makes its axis names resolvable."""

    def __init__(self, ranks: np.ndarray, axis_names: Sequence[str]):
        rank, n_world, backend = world()
        ranks = np.asarray(ranks, dtype=np.int64)
        if ranks.ndim != len(axis_names):
            raise ValueError(f"a {ranks.ndim}-D rank grid needs as many "
                             f"axis names, got {tuple(axis_names)}")
        if sorted(ranks.ravel().tolist()) != list(range(n_world)):
            raise ValueError(f"the mesh must hold every rank of the world "
                             f"({n_world}) once, got {ranks.ravel().tolist()}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, ranks.shape))
        me = tuple(int(i[0]) for i in np.nonzero(ranks == rank))
        self.axes: Dict[str, Axis] = {}
        for a, name in enumerate(self.axis_names):
            mine = None
            lines = np.moveaxis(ranks, a, -1).reshape(-1, ranks.shape[a])
            for line in lines:
                line = tuple(int(r) for r in line)
                group = None
                if len(line) > 1:
                    group = (dist.group.WORLD if len(line) == n_world
                             and line == tuple(range(n_world))
                             else dist.new_group(list(line)))
                if rank in line:
                    mine = (line, group)
            line, group = mine
            self.axes[name] = Axis(name, len(line), me[a], line, group,
                                   backend)

    def __enter__(self):
        collectives._ACTIVE.append(self)
        return self

    def __exit__(self, *exc):
        collectives._ACTIVE.remove(self)
        return False


def _world_ranks(n_devices: Optional[int]) -> np.ndarray:
    n_world = world()[1]
    if n_devices is not None and n_devices != n_world:
        raise ValueError(f"a mesh of {n_devices} ranks needs a world of "
                         f"that size (this one has {n_world}): start that "
                         "many ranks and initialise their group")
    return np.arange(n_world)


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("data",)) -> Mesh:
    """Every rank of the world on the first axis; the other axes size 1."""
    ranks = _world_ranks(n_devices)
    shape = (len(ranks),) + (1,) * (len(axis_names) - 1)
    return Mesh(ranks.reshape(shape), axis_names)


def make_dp_tp_mesh(n_devices: Optional[int] = None, tp: int = 2) -> Mesh:
    """2-D mesh ``(data, model)`` for hybrid data + tensor parallelism."""
    ranks = _world_ranks(n_devices)
    if len(ranks) % tp:
        raise ValueError(f"{len(ranks)} ranks do not split into tp={tp}")
    return Mesh(ranks.reshape(len(ranks) // tp, tp), ("data", "model"))


def _slice(t: torch.Tensor, dim: int, index: int, n: int) -> torch.Tensor:
    if t.shape[dim] % n:
        raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not "
                         f"split over {n} ranks")
    size = t.shape[dim] // n
    return t.narrow(dim, index * size, size).contiguous()


def shard_batch(mesh: Mesh, batch, axis: str = "data"):
    """This rank's slice of every leaf's leading axis (tuples, lists and
    dicts are walked; None stays)."""
    ax = mesh.axes[axis]
    if batch is None:
        return None
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v, axis) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(mesh, v, axis) for v in batch)
    return _slice(batch, 0, ax.index, ax.size)


def dp_sync(mesh: Mesh, axis: str = "data"):
    """``grad_sync`` for ``train_step.make_train_step`` under data
    parallelism: the mean over ``axis`` of the gradients (one flat psum),
    the loss and the metrics.  Each rank's loss is its shard's mean (counts
    that differ between shards shared by :func:`share_counts`), so the
    means are those of the step on the global batch."""

    def sync(grads, loss, metrics):
        n = mesh.shape[axis]
        with mesh:
            grads = {k: v / n for k, v in collectives.psum_tree(
                grads, axis).items()}
            both = collectives.psum_tree(
                dict(metrics, __loss__=loss.float()), axis)
        both = {k: v / n for k, v in both.items()}
        return grads, both.pop("__loss__"), both

    return sync


def share_counts(mesh: Mesh, model: nn.Module,
                 axis: str = "data") -> nn.Module:
    """Under data parallelism a loss that divides by a count that differs
    between shards (tokens, frames) must divide by the ranks' mean count:
    then the ranks' losses average to the global batch's, where averaging
    per-rank means would weigh each rank's tokens unequally.  Sets
    ``count_sync`` (read by ``ops/common.normaliser``) on every module of
    ``model`` that has one; returns ``model``."""
    n = mesh.shape[axis]

    def mean_count(count: torch.Tensor) -> torch.Tensor:
        with mesh:
            return collectives.psum(count.detach().float(), axis) / n

    for m in model.modules():
        if hasattr(m, "count_sync"):
            m.count_sync = mean_count
    return model


class GatheredLinear(nn.Linear):
    """A vocab head (``ctc_lo``, ``output_layer``) whose output rows are
    sharded over a tensor-parallel axis (:func:`shard_params_tp`): the
    product on this rank's rows, the logits gathered over the axis
    (``models/layers.dense`` runs a Linear subclass's own forward)."""

    axis = "model"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = collectives.pvary(x, self.axis)
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        b = None if self.bias is None else self.bias.to(dt)
        y = torch.nn.functional.linear(x.to(dt), self.weight.to(dt), b)
        return collectives.gather_replicated(y, self.axis)


def tp_param_spec(path_str: str, shape) -> Tuple:
    """Tensor-parallel spec of one parameter: one axis name (or None) per
    dimension of its torch layout, () when replicated."""
    if len(shape) != 2:
        return ()
    if "ctc_lo" in path_str or "output_layer" in path_str:
        return ("model", None)
    if "feed_forward" in path_str or "mlp" in path_str:
        if "Dense_0" in path_str:
            return ("model", None)
        if "Dense_1" in path_str:
            return (None, "model")
    return ()


def tp_shardings(mesh: Mesh, model: nn.Module) -> Dict[str, Tuple]:
    """{parameter name: :func:`tp_param_spec`}, the layout
    :func:`shard_params_tp` gives."""
    return {n: tp_param_spec(n, tuple(p.shape))
            for n, p in model.named_parameters()}


def _keep(module: nn.Module, leaf: str, t: torch.Tensor) -> None:
    module._parameters[leaf] = nn.Parameter(
        t, requires_grad=module._parameters[leaf].requires_grad)


def shard_params_tp(mesh: Mesh, model: nn.Module,
                    axis: str = "model") -> nn.Module:
    """Keep this rank's slices of the tensor-parallel parameters in
    ``model`` (in place) and mark the modules that own them, so their
    forwards close the products over ``axis``: the FFNs
    (``PositionwiseFeedForward.tp_axis``) and the vocab heads (made
    :class:`GatheredLinear`).  Raises
    if a parameter the rules shard belongs to no such module."""
    from paper_accurate_fast_cheap_tpu_torch.models.convolution import (
        PositionwiseFeedForward)

    ax = mesh.axes[axis]
    done = set()
    for path, m in model.named_modules():
        if isinstance(m, PositionwiseFeedForward) and (
                "feed_forward" in path or "mlp" in path):
            up, down = m.Dense_0, m.Dense_1
            _keep(up, "weight", _slice(up.weight.data, 0, ax.index, ax.size))
            _keep(up, "bias", _slice(up.bias.data, 0, ax.index, ax.size))
            _keep(down, "weight", _slice(down.weight.data, 1, ax.index,
                                         ax.size))
            m.tp_axis = axis
            done.update({f"{path}.Dense_0.weight", f"{path}.Dense_1.weight"})
        elif isinstance(m, nn.Linear) and path.rsplit(".", 1)[-1] in (
                "ctc_lo", "output_layer"):
            _keep(m, "weight", _slice(m.weight.data, 0, ax.index, ax.size))
            if m.bias is not None:
                _keep(m, "bias", _slice(m.bias.data, 0, ax.index, ax.size))
            m.__class__, m.axis = GatheredLinear, axis
            done.add(f"{path}.weight")
    for name, spec in tp_shardings(mesh, model).items():
        if spec and name not in done:
            raise ValueError(f"shard_params_tp: {name} matches a tensor-"
                             "parallel rule but no tp-aware module owns it")
    return model


def ep_param_spec(path_str: str, shape) -> Tuple:
    """Expert-parallel spec: the expert-stacked ``w1``/``w2`` (E, ...) of
    ``MoEFFNLayer`` shard their expert axis; the rest is replicated."""
    if len(shape) == 3 and path_str.rsplit(".", 1)[-1] in ("w1", "w2"):
        return ("model", None, None)
    return ()


def shard_params_ep(mesh: Mesh, model: nn.Module,
                    axis: str = "model") -> nn.Module:
    """Keep this rank's experts of every ``MoEFFNLayer`` (in place); each
    closes its combine with one psum over ``axis``."""
    from paper_accurate_fast_cheap_tpu_torch.models.convolution import (
        MoEFFNLayer)

    ax = mesh.axes[axis]
    for m in model.modules():
        if isinstance(m, MoEFFNLayer):
            for leaf in ("w1", "w2"):
                _keep(m, leaf, _slice(getattr(m, leaf).data, 0, ax.index,
                                      ax.size))
            m.ep_axis = axis
    return model
