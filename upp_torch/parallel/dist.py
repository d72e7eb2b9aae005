"""The process group and its collectives (counterpart of
``upp_tpu/parallel/mesh.py``; the reference's ``utils/dist_utils.py``).

One process per card, launched by ``torchrun`` (``python -m
torch.distributed.run``) and joined by ``init_dist``. The JAX package needs
no explicit collective: its jitted step has global semantics and XLA inserts
them. Here they are explicit:

* ``all_reduce_sum`` and ``all_gather_rows``: differentiable, for what a
  train step shares across ranks (BatchNorm statistics, the rows of the
  propagation's cross-cloud gather); the backward of each sums the
  gradients over ranks;
* ``average_gradients``: the optimizer's mean of the gradients, one
  coalesced all-reduce an update;
* ``reduce_mean``, ``gather_rows`` / ``gather_samples``,
  ``broadcast_object`` and ``barrier``: logged metrics, evaluation results
  (host arrays), the run directory, checkpoint order.

Every collective takes a ``group``: None is the whole world. A (data,
model) grid of groups (``make_grid``, the counterpart of ``mesh.py:26-32``
``make_mesh(devices, model_parallel)``) splits the world into data ranks,
which hold different rows of a batch, and model ranks, which hold the same
rows and split the transformer blocks' products (``parallel.tensor``). What
spans the rows of a global batch (BatchNorm's statistics, the propagation's
gather, the gradients' mean, a step's logged loss) runs over
``data_group()``; without a grid that is the world.

The collectives on tensors are all-reduces, which NCCL and gloo both take
on a card's tensors (gloo takes no all-gather and no reduce-scatter of CUDA
tensors: ``all_gather_dim`` and ``reduce_scatter_dim`` sum into per-rank
slots over gloo, and use NCCL's own collectives over NCCL). With one
process none runs, as ``shard_batch`` bypasses sharding on a mesh of one
(``mesh.py:49-51``). ``COUNTS`` counts the collectives by kind
(``forward``, ``backward``, ``gradients``, ``host``, ``fsdp``, ``tp``) and
their bytes (``<kind>_bytes``)."""

from __future__ import annotations

import dataclasses
import os
from collections import Counter
from typing import Iterable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

COUNTS: Counter = Counter()


def get_dist_info(group=None) -> Tuple[int, int]:
    """(rank, size) of this process in ``group`` (None: the world); (0, 1)
    without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(group), dist.get_world_size(group)
    return 0, 1


@dataclasses.dataclass(frozen=True)
class Grid:
    """This rank's place in a (data, model) grid of ``world // model`` x
    ``model`` ranks: rank ``d * model + m`` is data index ``d`` and model
    index ``m``, the order of JAX's ``np.array(devices).reshape(n // mp,
    mp)``. ``data``: the ranks with this model index (they hold different
    rows); ``model``: the ranks with this data index (they hold the same
    rows); this rank's place in ``data``."""
    data: object
    model: object
    data_rank: int
    data_size: int


_GRID: Optional[Grid] = None


def make_grid(model_parallel: int) -> Grid:
    """Build and install the (data, model) grid of the world: every rank
    calls it at the same point (``dist.new_group`` is collective over the
    world). ``model_parallel`` 1 gives a data group of the whole world."""
    global _GRID
    rank, world = get_dist_info()
    if model_parallel < 1 or world % model_parallel:
        raise ValueError(f"model_parallel {model_parallel} does not divide the world {world}")
    n_data = world // model_parallel
    data = model = None
    for m in range(model_parallel):
        g = dist.new_group([d * model_parallel + m for d in range(n_data)])
        if rank % model_parallel == m:
            data = g
    for d in range(n_data):
        g = dist.new_group([d * model_parallel + m for m in range(model_parallel)])
        if rank // model_parallel == d:
            model = g
    _GRID = Grid(data, model, rank // model_parallel, n_data)
    return _GRID


def clear_grid() -> None:
    """Back to one data group of the whole world."""
    global _GRID
    _GRID = None


def data_group():
    """The group over which the rows of a global batch spread: the grid's
    data group, the world (None) without a grid."""
    return _GRID.data if _GRID is not None else None


def model_group():
    """The grid's model group (ranks holding the same rows); None without a
    grid."""
    return _GRID.model if _GRID is not None else None


def data_info() -> Tuple[int, int]:
    """(rank, size) of this process in ``data_group()``."""
    if _GRID is not None:
        return _GRID.data_rank, _GRID.data_size
    return get_dist_info()


def init_dist(launcher: str, device, backend: str = None) -> torch.device:
    """Join the process group ``torchrun`` describes in the environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``) and return this rank's device: on CUDA card
    ``LOCAL_RANK``, made current. The backend is NCCL on CUDA and gloo on
    the CPU unless ``backend`` names another. Raises without that
    environment: a run under a launcher never falls back to one process."""
    if launcher != "pytorch":
        raise ValueError(f"launcher {launcher!r}: the port launches with 'pytorch' (torchrun)")
    missing = [k for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
               if k not in os.environ]
    if missing:
        raise RuntimeError(f"--launcher pytorch needs the environment torchrun sets; "
                           f"{', '.join(missing)} unset (launch with python -m "
                           "torch.distributed.run --nproc_per_node N -m upp_torch.main ...)")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ["LOCAL_RANK"])
    dev = torch.device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_dist: device cuda but no CUDA device is available")
        # NCCL takes one rank a card; gloo ranks may share the cards
        card = local_rank if backend == "nccl" else local_rank % torch.cuda.device_count()
        torch.cuda.set_device(card)
        dev = torch.device("cuda", card)
    dist.init_process_group(backend, rank=rank, world_size=world)
    return dev


def _count(kind: str, t: torch.Tensor) -> None:
    COUNTS[kind] += 1
    COUNTS[f"{kind}_bytes"] += t.numel() * t.element_size()


def _all_reduce(t: torch.Tensor, kind: str, group=None) -> torch.Tensor:
    """Sum ``t`` over the ranks of ``group`` in place."""
    _count(kind, t)
    dist.all_reduce(t, group=group)
    return t


def _nccl(group) -> bool:
    return dist.get_backend(group) == "nccl"


def all_gather_dim(x: torch.Tensor, dim: int, kind: str, group=None) -> torch.Tensor:
    """Every rank's ``x`` (one shape on all ranks of ``group``) concatenated
    along ``dim`` in rank order (no gradient). NCCL: one
    ``all_gather_into_tensor``; else one all-reduce of per-rank slots, each
    rank's own filled and the rest zero (gloo takes no all-gather of CUDA
    tensors)."""
    rank, world = get_dist_info(group)
    x = x.contiguous()
    if _nccl(group):
        slots = x.new_empty((world,) + tuple(x.shape))
        _count(kind, slots)
        dist.all_gather_into_tensor(slots, x, group=group)
    else:
        slots = x.new_zeros((world,) + tuple(x.shape))
        slots[rank] = x
        _all_reduce(slots, kind, group)
    return torch.cat(slots.unbind(0), dim)


def reduce_scatter_dim(x: torch.Tensor, dim: int, kind: str, group=None) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of ``x`` over the ranks of
    ``group`` (no gradient): NCCL's ``reduce_scatter_tensor``, else an
    all-reduce of the whole and this rank's slice of it."""
    rank, world = get_dist_info(group)
    if _nccl(group):
        parts = x.movedim(dim, 0).contiguous()
        out = parts.new_empty((parts.shape[0] // world,) + tuple(parts.shape[1:]))
        _count(kind, parts)
        dist.reduce_scatter_tensor(out, parts, group=group)
        return out.movedim(0, dim).contiguous()
    x = _all_reduce(x.clone(memory_format=torch.contiguous_format), kind, group)
    n = x.shape[dim] // world
    return x.narrow(dim, rank * n, n).contiguous()


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x.clone(memory_format=torch.contiguous_format), "forward", group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad.clone(memory_format=torch.contiguous_format), "backward",
                           ctx.group), None


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        rank, world = get_dist_info(group)
        ctx.rank, ctx.world, ctx.group = rank, world, group
        slots = x.new_zeros((world,) + tuple(x.shape))
        slots[rank] = x
        return _all_reduce(slots, "forward", group).reshape((world * x.shape[0],) + x.shape[1:])

    @staticmethod
    def backward(ctx, grad):
        grad = _all_reduce(grad.clone(memory_format=torch.contiguous_format), "backward",
                           ctx.group)
        return grad.reshape((ctx.world, -1) + grad.shape[1:])[ctx.rank], None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group``; its backward sums the
    gradients over them. ``x`` itself without a group of more than one."""
    return _AllReduceSum.apply(x, group) if get_dist_info(group)[1] > 1 else x


def all_gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` (one shape on all ranks of ``group``) concatenated
    along the first axis in rank order; differentiable. One all-reduce of
    world x ``x``'s bytes into per-rank slots each way."""
    return _AllGatherRows.apply(x, group) if get_dist_info(group)[1] > 1 else x


def reduce_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of ``x`` over the ranks of ``group`` (no gradient): a logged
    metric."""
    world = get_dist_info(group)[1]
    if world == 1:
        return x
    return _all_reduce(x.detach().clone(), "host", group) / world


def gather_rows(x: np.ndarray) -> np.ndarray:
    """Every rank's rows of the host array ``x`` [n_rank, ...] (n may
    differ between ranks) concatenated in rank order, on every rank; the
    reference's ``gather_tensor``."""
    world = get_dist_info()[1]
    if world == 1:
        return x
    parts = [None] * world
    COUNTS["host"] += 1
    dist.all_gather_object(parts, x)
    return np.concatenate(parts)


def gather_samples(index, *columns):
    """(index, columns) of every rank's evaluated samples, each sample once,
    in index order: the per-sample rows are gathered, then the duplicates
    that a sharded loader's padding adds are dropped by their dataset index
    (after the gather: a duplicate may sit on another rank than its
    original), as ``upp_tpu/train/runner_cls.py:146-199`` does. One process
    only sorts by index."""
    index = gather_rows(np.asarray(index, np.int64).reshape(-1))
    columns = [gather_rows(np.asarray(c)) for c in columns]
    index, first = np.unique(index, return_index=True)
    return index, [c[first] for c in columns]


def average_gradients(params: Iterable[torch.Tensor], group=None) -> None:
    """Replace each parameter's gradient by its mean over the ranks of
    ``group``: one all-reduce of all of them flattened. Every rank passes
    the same parameters in the same order (the ones with a gradient: every
    rank runs the same graph)."""
    world = get_dist_info(group)[1]
    grads = [p.grad for p in params]
    if world == 1 or not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    _all_reduce(flat, "gradients", group).div_(world)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def broadcast_object(obj):
    """Rank 0's ``obj`` (picklable) on every rank."""
    if get_dist_info()[1] == 1:
        return obj
    box = [obj]
    COUNTS["host"] += 1
    dist.broadcast_object_list(box, src=0)
    return box[0]


def barrier() -> None:
    """Wait until every rank is here."""
    if get_dist_info()[1] > 1:
        COUNTS["host"] += 1
        dist.barrier()
