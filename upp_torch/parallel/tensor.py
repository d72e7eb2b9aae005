"""Tensor parallelism of the transformer blocks over the model ranks
(counterpart of ``upp_tpu/parallel/mesh.py:146-190`` ``_tp_spec`` /
``tp_shardings``).

Megatron's factorisation, in every block stack of the model (the JAX
package's scanned stacks; ``models/scan_blocks.py``): ``Attention.qkv`` and
``Mlp.fc1`` column parallel (a rank holds rows of the output features),
``Attention.proj`` and ``Mlp.fc2`` row parallel (the matching input
columns); everything else, biases included, stays replicated, as in JAX.
JAX shards ``attn_qkv_kernel`` [L, C, 3C] in halves of 3C and GSPMD keeps
the semantics; the port computes attention locally, so a rank takes whole
heads: of ``qkv.weight`` [3C, C], whose rows are ordered (3, H, hd), the q,
k and v rows of heads ``rank * H / tp`` to ``(rank + 1) * H / tp``.

The collectives are Megatron's f and g over the model group: f (the
column-parallel input) is the identity forward and a sum of the gradient
backward; g (the row-parallel output) is a sum forward and the identity
backward, since what follows is replicated. ``dist.all_reduce_sum`` would
sum that gradient again. The row-parallel bias is added once, after g;
``fc1``'s replicated bias is sliced at use, through f. The ranks of a model
group hold the same rows, so every draw (dropout, drop-path) is the same on
them (``parallel.shard`` draws by data rank), and the replicated
parameters' gradients are equal on them in exact arithmetic; the optimizer
averages those over every rank (the card's atomic adds may round them
apart between model ranks), the split ones over the data group, and takes
the global norm with the split tensors' squares summed over the model
group (``train/optim.py``)."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from . import dist as pdist


class _CopyIn(torch.autograd.Function):
    """Megatron's f: identity forward, the gradient summed over the model
    group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return pdist._all_reduce(grad.clone(memory_format=torch.contiguous_format), "tp",
                                 ctx.group), None


class _ReduceOut(torch.autograd.Function):
    """Megatron's g: the partial products summed over the model group
    forward, the identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return pdist._all_reduce(x.clone(memory_format=torch.contiguous_format), "tp", group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


@dataclasses.dataclass(frozen=True)
class ModelParallel:
    """This rank's place in the model group, as a block's products see it."""
    group: object
    rank: int
    size: int

    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        return _CopyIn.apply(x, self.group)

    def reduce_out(self, x: torch.Tensor) -> torch.Tensor:
        return _ReduceOut.apply(x, self.group)

    def local_rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``t``'s first axis."""
        n = t.shape[0] // self.size
        return t[self.rank * n:(self.rank + 1) * n]


# (module kind, parameter) -> (the port dimension split, its leading groups):
# qkv's rows are (3, H, hd), so each of q, k and v is split alone
SPLITS = {("attn", "qkv.weight"): (0, 3), ("mlp", "fc1.weight"): (0, 1),
          ("attn", "proj.weight"): (1, 1), ("mlp", "fc2.weight"): (1, 1)}


def _block(t: torch.Tensor, dim: int, groups: int, rank: int, size: int) -> torch.Tensor:
    parts = t.unflatten(dim, (groups, t.shape[dim] // groups))
    n = parts.shape[dim + 1] // size
    return parts.narrow(dim + 1, rank * n, n).flatten(dim, dim + 1).clone()


def _whole(t: torch.Tensor, dim: int, groups: int, group) -> torch.Tensor:
    parts = pdist.all_gather_dim(t.detach().unflatten(dim, (groups, -1)).unsqueeze(0), 0,
                                 "tp", group)                  # [ranks, ...]
    return torch.cat(parts.unbind(0), dim + 1).flatten(dim, dim + 1)


def split_params(model: nn.Module) -> Dict[str, Tuple[int, int]]:
    """Port name -> (dimension, leading groups) of every parameter tensor
    parallelism splits: qkv/fc1 column, proj/fc2 row, in every block of
    every block stack."""
    from ..models.scan_blocks import ScannedDecoderStack, ScannedEncoderStack
    out = {}
    for sname, st in model.named_modules():
        if isinstance(st, (ScannedEncoderStack, ScannedDecoderStack)):
            for i in range(len(st.blocks)):
                for (kind, pname), split in SPLITS.items():
                    out[".".join(x for x in (sname, "blocks", str(i), kind, pname) if x)] = split
    return out


def shard_model(model: nn.Module, group=None) -> ModelParallel:
    """Split ``model``'s block products in place over the ranks of ``group``
    (``dist.model_group()`` under a grid). Every block's head count and
    hidden width must divide by the group's size."""
    from .dist import get_dist_info
    rank, size = get_dist_info(group)
    tp = ModelParallel(group, rank, size)
    params = dict(model.named_parameters())
    splits = split_params(model)
    for name, (dim, groups) in splits.items():
        p = params[name]
        if (p.shape[dim] // groups) % size:
            raise ValueError(f"{name} {tuple(p.shape)}: dimension {dim} does not split over "
                             f"{size} ranks")
        p.data = _block(p.data, dim, groups, rank, size)
        p._upp_split = ("tp", group)
    for name, m in model.named_modules():
        if name + ".qkv.weight" in splits or name + ".fc1.weight" in splits:
            if getattr(m, "num_heads", size) % size:
                raise ValueError(f"{name}: {m.num_heads} heads over {size} ranks")
            m.tp = tp
    model._upp_tp = (splits, group)
    return tp


def full_tensor(model: nn.Module, name: str, t: torch.Tensor) -> torch.Tensor:
    """A tensor of parameter ``name``'s shape on this rank (the parameter,
    its gradient, a moment) gathered whole over the model group (every rank
    of the group calls it); ``t`` itself for a replicated parameter."""
    splits, group = model._upp_tp
    if name not in splits:
        return t
    return _whole(t, *splits[name], group)


def full_state_dict(model: nn.Module, state: Optional[Dict[str, torch.Tensor]] = None
                    ) -> Dict[str, torch.Tensor]:
    """The one-process state dict of a tensor-parallel model (every rank of
    the model group calls it and gets it)."""
    state = model.state_dict() if state is None else state
    return {k: full_tensor(model, k, v).detach().clone() for k, v in state.items()}
