"""The global batch a train step is one rank's share of.

JAX's train step is one jit over the global batch of B clouds: its random
draws are made for all B rows, BatchNorm normalises with the statistics of
all B rows, and the propagation's reference gather
(``models/scan_blocks.py::PromptedBlock._propagate``) reads rows of other
clouds of the batch. Here each of N ranks runs B/N rows of that batch, and
inside ``global_batch(shard, generator)``:

* a per-cloud random draw (``rand``, ``randn``, ``bernoulli``) is made for
  the global batch from the common generator, which every rank holds in the
  same state, and this rank keeps its rows; a draw the batch shares (an
  index, a ratio) needs no care, since every rank draws the same;
* the model's own draws (dropout, drop-path) come from ``generator``;
* ``is_global`` tells BatchNorm and the propagation to reach the other
  ranks.

So N ranks draw, normalise and gather what one process does on the B
clouds. Outside (evaluation, a single process) every draw is local and
``current()`` is ``Shard()``, a world of one."""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Callable, Optional, Sequence

import torch

from .dist import data_info


@dataclasses.dataclass(frozen=True)
class Shard:
    """This rank's rows of a global batch. A block: rows ``rank * b :
    (rank + 1) * b`` of ``world * b``, JAX's global row order
    (``make_array_from_process_local_data`` concatenates the processes'
    rows rank by rank, ``upp_tpu/parallel/mesh.py:54-57``). ``strided``:
    rows ``rank, rank + world, ...``, the order of a sharded loader's batch
    (``data/loader.py``) within the one-process batch of ``rows`` clouds
    (a draw covers ``rows`` whatever this batch's size, so a short last
    batch draws as the one-process run does)."""
    rank: int = 0
    world: int = 1
    strided: bool = False
    rows: Optional[int] = None

    @property
    def is_global(self) -> bool:
        """A train step's share of a batch spread over ranks."""
        return self.world > 1 and not self.strided

    def take(self, draw: Callable[[Sequence[int]], torch.Tensor],
             shape: Sequence[int]) -> torch.Tensor:
        """``draw(shape)`` for this rank's ``shape[0]`` rows of the global
        batch: ``draw`` runs once at the global batch's size."""
        b = shape[0]
        n = self.rows if self.rows is not None else b * self.world
        if n == b:
            return draw(tuple(shape))
        full = draw((n,) + tuple(shape[1:]))
        if self.strided:
            return full[self.rank::self.world][:b]
        return full[self.rank * b:(self.rank + 1) * b]


def this_rank() -> Shard:
    """This rank's block of a train step's global batch: its place in the
    data group (``dist.data_group``); the ranks of a model group hold the
    same block and draw the same."""
    return Shard(*data_info())


_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "upp_torch_global_batch", default=(Shard(), None))


@contextlib.contextmanager
def global_batch(shard: Shard, generator: Optional[torch.Generator] = None):
    """Run the body as ``shard`` of a global batch, the model's own draws
    from ``generator``."""
    token = _CURRENT.set((shard, generator))
    try:
        yield
    finally:
        _CURRENT.reset(token)


def current() -> Shard:
    return _CURRENT.get()[0]


def model_generator() -> Optional[torch.Generator]:
    """The generator of the model's draws (dropout, drop-path), None
    outside ``global_batch`` (torch's RNG)."""
    return _CURRENT.get()[1]


def rand(shape, *, generator=None, device=None) -> torch.Tensor:
    """U(0, 1) draws for this rank's ``shape[0]`` clouds."""
    return current().take(lambda s: torch.rand(s, generator=generator, device=device), shape)


def randn(shape, *, generator=None, device=None) -> torch.Tensor:
    """Standard normal draws for this rank's ``shape[0]`` clouds."""
    return current().take(lambda s: torch.randn(s, generator=generator, device=device), shape)


def bernoulli(shape, p: float, *, generator=None, device=None, dtype=None) -> torch.Tensor:
    """Bernoulli(``p``) draws (1 or 0) for this rank's ``shape[0]`` clouds."""
    return current().take(lambda s: torch.empty(s, device=device, dtype=dtype)
                          .bernoulli_(p, generator=generator), shape)
