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

The collectives on tensors are all-reduces, which NCCL and gloo both take
on a card's tensors (gloo takes no all-gather of CUDA tensors). With
one process none runs, as ``shard_batch`` bypasses sharding on a mesh of
one (``mesh.py:49-51``). ``COUNTS`` counts the collectives by kind
(``forward``, ``backward``, ``gradients``, ``host``) and their bytes
(``<kind>_bytes``)."""

from __future__ import annotations

import os
from collections import Counter
from typing import Iterable, Tuple

import numpy as np
import torch
import torch.distributed as dist

COUNTS: Counter = Counter()


def get_dist_info() -> Tuple[int, int]:
    """(rank, world size) of this process; (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


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
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_dist: device cuda but no CUDA device is available")
        torch.cuda.set_device(local_rank)
        dev = torch.device("cuda", local_rank)
    dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"),
                            rank=rank, world_size=world)
    return dev


def _all_reduce(t: torch.Tensor, kind: str) -> torch.Tensor:
    """Sum ``t`` over ranks in place."""
    COUNTS[kind] += 1
    COUNTS[f"{kind}_bytes"] += t.numel() * t.element_size()
    dist.all_reduce(t)
    return t


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _all_reduce(x.clone(memory_format=torch.contiguous_format), "forward")

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad.clone(memory_format=torch.contiguous_format), "backward")


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        rank, world = get_dist_info()
        ctx.rank, ctx.world = rank, world
        slots = x.new_zeros((world,) + tuple(x.shape))
        slots[rank] = x
        return _all_reduce(slots, "forward").reshape((world * x.shape[0],) + x.shape[1:])

    @staticmethod
    def backward(ctx, grad):
        grad = _all_reduce(grad.clone(memory_format=torch.contiguous_format), "backward")
        return grad.reshape((ctx.world, -1) + grad.shape[1:])[ctx.rank]


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over ranks; its backward sums the gradients over
    ranks. ``x`` itself without a process group of more than one."""
    return _AllReduceSum.apply(x) if get_dist_info()[1] > 1 else x


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` (one shape on all ranks) concatenated along the
    first axis in rank order; differentiable. One all-reduce of
    world x ``x``'s bytes into per-rank slots each way."""
    return _AllGatherRows.apply(x) if get_dist_info()[1] > 1 else x


def reduce_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over ranks (no gradient): a logged metric."""
    world = get_dist_info()[1]
    if world == 1:
        return x
    return _all_reduce(x.detach().clone(), "host") / world


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


def average_gradients(params: Iterable[torch.Tensor]) -> None:
    """Replace each parameter's gradient by its mean over ranks: one
    all-reduce of all of them flattened. Every rank passes the same
    parameters in the same order (the ones with a gradient: every rank runs
    the same graph)."""
    world = get_dist_info()[1]
    grads = [p.grad for p in params]
    if world == 1 or not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    _all_reduce(flat, "gradients").div_(world)
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
