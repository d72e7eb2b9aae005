"""ZeRO-3 sharding of the parameters and the optimizer moments over the data
ranks (counterpart of ``upp_tpu/parallel/mesh.py:104-143`` ``fsdp_shardings``
and ``:70-101`` ``host_local_variables``; the pretrain runner's ``fsdp:
true``).

Placement, JAX's rule on JAX's leaves: a leaf with at least ``min_size``
elements is sharded over the data ranks along its largest dimension the
number of ranks divides (the later one on equal sizes: ``max((s, i))``);
every other leaf stays replicated. The JAX package stacks each block
stack's per-block tensors ([L, ...]) and keeps Dense kernels as [in, out],
so a port tensor is judged by the leaf it is a row of, in JAX's layout
(``jax_leaves``), and sharded along the port dimension that leaf's sharded
dimension is. Where a stacked leaf's sharded dimension is the stack axis
itself, each row is sharded along its own largest divisible dimension
instead (the same elements a rank, another cut; no configuration of the
repo has a stack deeper than its width).

Storage: between steps a rank holds its block of every sharded parameter
(``p.data``; the parameter keeps its number of dimensions, which the
optimizer's no-decay rule reads) and, since the optimizer steps these
parameters, its block of their moments. Use: each unit (a transformer
block, an encoder, a head; the rest of the model is the root unit) gathers
its parameters when its forward starts and drops them when it ends; a
tensor the autograd graph saves from them is not kept but gathered again
when the backward reads it (``saved_tensors_hooks``). The gradient of a
gathered parameter is reduce-scattered into the blocks as the mean over
the data ranks, ``dist.average_gradients``'s mean; the optimizer averages
the replicated gradients and clips on the global norm
(``train/optim.py``). Every rank runs the same units in the same order, so
the collectives pair up; over gloo they are all-reduces into per-rank slots
(``dist.all_gather_dim``), which run on a card's tensors.

``full_state_dict`` / ``full_optimizer_state_dict`` gather the one-process
state (what ``train/checkpoint.py`` writes), ``load_full_state`` shards a
one-process state again, and ``gathered`` is the evaluation counterpart of
``host_local_variables``: the whole parameters on every rank for the body,
the blocks again after it."""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from . import dist as pdist

MIN_SIZE = 16384
_NORMS = (nn.LayerNorm, nn.GroupNorm, nn.modules.batchnorm._BatchNorm)


def shard_dim(shape: Sequence[int], world: int, min_size: int = MIN_SIZE) -> Optional[int]:
    """JAX's placement of one leaf (``mesh.py:128-137``): the dimension
    sharded over ``world`` ranks, None for a replicated leaf."""
    if world == 1 or math.prod(shape) < min_size:
        return None
    cands = [(s, i) for i, s in enumerate(shape) if s % world == 0]
    return max(cands)[1] if cands else None


def _jax_layout(module: nn.Module, leaf: str, shape: Tuple[int, ...]):
    """(JAX's shape of a port tensor, the port dimension of each JAX
    dimension): a Dense or pointwise-conv ``weight`` [out, in(, 1...)] is
    the kernel [in, out]; everything else keeps its shape."""
    if (leaf == "weight" and not isinstance(module, _NORMS) and len(shape) >= 2
            and all(s == 1 for s in shape[2:])):
        return (shape[1], shape[0]), (1, 0)
    return shape, tuple(range(len(shape)))


def jax_leaves(model: nn.Module) -> List[Tuple[Tuple[int, ...], List[Tuple[str, Tuple[int, ...]]]]]:
    """The model's parameters as the JAX package's leaves: (JAX shape, [(port
    name, the port dimension of each JAX dimension of one row)]). A block
    stack's per-block tensors of one name form one leaf [rows, ...]; every
    other tensor is a leaf of its own."""
    from ..models.scan_blocks import ScannedDecoderStack, ScannedEncoderStack
    modules = dict(model.named_modules())
    rows: Dict[str, Tuple[str, str]] = {}
    for sname, st in modules.items():
        if isinstance(st, (ScannedEncoderStack, ScannedDecoderStack)):
            for i, blk in enumerate(st.blocks):
                for pname, _ in blk.named_parameters():
                    full = ".".join(x for x in (sname, "blocks", str(i), pname) if x)
                    rows[full] = (sname, pname)
    stacked: Dict[Tuple[str, str], list] = {}
    leaves = []
    for name, p in model.named_parameters():
        mod, _, leaf = name.rpartition(".")
        jshape, dims = _jax_layout(modules[mod], leaf, tuple(p.shape))
        if name in rows:
            stacked.setdefault(rows[name], []).append((name, jshape, dims))
        else:
            leaves.append((jshape, [(name, dims)]))
    for members in stacked.values():
        leaves.append(((len(members),) + members[0][1], [(n, d) for n, _, d in members]))
    return leaves


def placement(model: nn.Module, world: int, min_size: int = MIN_SIZE) -> Dict[str, Optional[int]]:
    """The port dimension each parameter is sharded along over ``world``
    data ranks (None: replicated), by JAX's rule on its leaf."""
    out: Dict[str, Optional[int]] = {}
    for jshape, members in jax_leaves(model):
        jdim = shard_dim(jshape, world, min_size)
        stacked = len(jshape) > len(members[0][1])
        for name, dims in members:
            if jdim is None:
                out[name] = None
            elif not stacked:
                out[name] = dims[jdim]
            elif jdim > 0:
                out[name] = dims[jdim - 1]
            else:                                   # the stack axis: cut each row
                row = tuple(jshape[1:])
                d = shard_dim(row, world, 0)
                out[name] = None if d is None else dims[d]
    return out


@dataclasses.dataclass
class _Meta:
    dim: int
    group: object
    rank: int
    world: int


def _gather(t: torch.Tensor, meta: _Meta) -> torch.Tensor:
    return pdist.all_gather_dim(t.detach(), meta.dim, "fsdp", meta.group)


def _block(t: torch.Tensor, meta: _Meta) -> torch.Tensor:
    n = t.shape[meta.dim] // meta.world
    return t.narrow(meta.dim, meta.rank * n, n).clone()


class _Gather(torch.autograd.Function):
    """A parameter's blocks gathered whole; the backward reduce-scatters the
    gradient into this rank's block, as the mean over the ranks."""

    @staticmethod
    def forward(ctx, block, meta):
        ctx.meta = meta
        return _gather(block, meta)

    @staticmethod
    def backward(ctx, grad):
        meta = ctx.meta
        return pdist.reduce_scatter_dim(grad, meta.dim, "fsdp", meta.group).div_(meta.world), None


@dataclasses.dataclass
class _Saved:
    """A saved tensor that is (a view of) a gathered parameter: gathered
    again when the backward reads it."""
    param: nn.Parameter
    size: torch.Size
    stride: Tuple[int, ...]
    offset: int


def _storage(t: torch.Tensor) -> Optional[int]:
    try:
        return t.untyped_storage().data_ptr()
    except (RuntimeError, NotImplementedError):
        return None


class _State:
    """The hooks' state on a sharded model."""

    def __init__(self, model: nn.Module, metas: Dict[str, _Meta]):
        self.metas = metas
        self.enabled = True
        self.live: Dict[int, nn.Parameter] = {}     # storage of a gathered parameter -> it
        self.hooks: List[torch.autograd.graph.saved_tensors_hooks] = []
        self.units: Dict[int, List[Tuple[nn.Module, str, nn.Parameter]]] = {}
        params = dict(model.named_parameters())
        self.param_meta = {id(params[n]): m for n, m in metas.items()}

    def pack(self, t: torch.Tensor):
        p = self.live.get(_storage(t)) if self.live else None
        if p is None:
            return t
        return _Saved(p, t.size(), t.stride(), t.storage_offset())

    def unpack(self, x):
        if not isinstance(x, _Saved):
            return x
        full = _gather(x.param.data, self.param_meta[id(x.param)])
        return full.as_strided(x.size, x.stride, x.offset)

    def pre(self, module, _args):
        if not self.enabled:
            return
        for owner, pname, p in self.units[id(module)]:
            full = _Gather.apply(p, self.param_meta[id(p)])
            owner._parameters[pname] = full
            self.live[_storage(full)] = p
        ctx = torch.autograd.graph.saved_tensors_hooks(self.pack, self.unpack)
        ctx.__enter__()
        self.hooks.append(ctx)

    def post(self, module, _args, _out):
        if not self.enabled:
            return
        self.hooks.pop().__exit__(None, None, None)
        for owner, pname, p in self.units[id(module)]:
            self.live.pop(_storage(owner._parameters[pname]), None)
            owner._parameters[pname] = p


def _unit_modules(model: nn.Module) -> List[nn.Module]:
    """The units, outermost first: every transformer block, encoder, head
    and rectify prompter; the model itself takes the rest."""
    from ..models.layers import Encoder, TwoLayerHead
    from ..models.prompter import RectifyPrompter
    from ..models.scan_blocks import PromptedBlock
    from ..models.unify import ClsHead
    kinds = (PromptedBlock, Encoder, TwoLayerHead, ClsHead, RectifyPrompter)
    units = []

    def walk(m):
        for child in m.children():
            if isinstance(child, kinds):
                units.append(child)
            else:
                walk(child)

    walk(model)
    return units


def shard_model(model: nn.Module, group=None, min_size: int = MIN_SIZE) -> Dict[str, Optional[int]]:
    """Shard ``model``'s parameters in place over the ranks of ``group``
    (None: the world; ``dist.data_group()`` under a grid) by ``placement``
    and install the gathers. Build the optimizer over the model before or
    after: it holds the same parameters, and their moments are made at the
    first step, in blocks. Returns the placement."""
    from ..models.scan_blocks import ScannedDecoderStack, ScannedEncoderStack
    if any(getattr(m, "remat", False) for m in model.modules()
           if isinstance(m, (ScannedEncoderStack, ScannedDecoderStack))):
        raise ValueError("fsdp with remat_blocks: the recomputation would gather inside "
                         "torch.utils.checkpoint's own saved-tensor hooks; use one of them")
    rank, world = pdist.get_dist_info(group)
    plan = placement(model, world, min_size)
    metas = {}
    for name, p in model.named_parameters():
        if plan[name] is not None:
            meta = metas[name] = _Meta(plan[name], group, rank, world)
            p.data = _block(p.data, meta)
            p._upp_split = ("fsdp", group)
    state = _State(model, metas)
    sharded = {id(p) for n, p in model.named_parameters() if n in metas}
    units = _unit_modules(model)
    in_unit = {id(m) for u in units for m in u.modules()}
    owners = {id(model): [m for m in model.modules() if id(m) not in in_unit]}
    owners.update({id(u): list(u.modules()) for u in units})
    for unit in [model] + units:
        owned = [(m, pname, p) for m in owners[id(unit)]
                 for pname, p in m._parameters.items() if p is not None and id(p) in sharded]
        if owned:
            state.units[id(unit)] = owned
            unit.register_forward_pre_hook(state.pre)
            unit.register_forward_hook(state.post)
    model._upp_fsdp = state
    return plan


def is_sharded(model: nn.Module) -> bool:
    return hasattr(model, "_upp_fsdp")


def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The one-process state dict of a sharded model (every rank calls it;
    every rank gets it, in fresh tensors), the ``.pth`` layout rank 0
    writes; a copy of a model that is not sharded."""
    metas = model._upp_fsdp.metas if is_sharded(model) else {}
    return {k: (_gather(v, metas[k]) if k in metas else v.detach().clone())
            for k, v in model.state_dict().items()}


def full_tensor(model: nn.Module, name: str, t: torch.Tensor) -> torch.Tensor:
    """A tensor in the shape of parameter ``name``'s block on this rank (the
    parameter, its gradient) gathered whole (every rank calls it); ``t``
    itself for a replicated parameter."""
    meta = model._upp_fsdp.metas.get(name) if is_sharded(model) else None
    return t if meta is None else _gather(t, meta)


def _params(optimizer) -> List[nn.Parameter]:
    opt = getattr(optimizer, "optimizer", optimizer)
    return [p for g in opt.param_groups for p in g["params"]]


def _moments(model, optimizer, state: dict, fn) -> dict:
    """``state`` (an optimizer state dict) with ``fn(tensor, meta)`` in place
    of each tensor of a sharded parameter's state that has its shape, a
    copy of every other tensor."""
    param_meta = model._upp_fsdp.param_meta if is_sharded(model) else {}
    out = dict(state)
    out["state"] = {}
    params = _params(optimizer)
    for i, st in state["state"].items():
        meta = param_meta.get(id(params[i]))
        out["state"][i] = {
            k: (fn(v, meta) if meta is not None and torch.is_tensor(v) and v.dim() > 0
                else v.detach().clone() if torch.is_tensor(v) else v)
            for k, v in st.items()}
    return out


def full_optimizer_state_dict(model: nn.Module, optimizer) -> dict:
    """The optimizer's state dict with each sharded parameter's moments
    gathered whole (every rank calls it)."""
    return _moments(model, optimizer, optimizer.state_dict(), _gather)


def load_full_state(model: nn.Module, model_state: Dict[str, torch.Tensor],
                    optimizer=None, optimizer_state: Optional[dict] = None,
                    strict: bool = True, **opt_kw):
    """Load a one-process state (a checkpoint's) into a sharded model, each
    rank keeping its blocks, and the optimizer's likewise; ``opt_kw`` go to
    the optimizer's ``load_state_dict``. Returns ``load_state_dict``'s
    result."""
    metas = model._upp_fsdp.metas
    local = {k: (_block(v, metas[k]) if k in metas else v) for k, v in model_state.items()}
    result = model.load_state_dict(local, strict=strict)
    if optimizer is not None and optimizer_state is not None:
        optimizer.load_state_dict(_moments(model, optimizer, optimizer_state, _block), **opt_kw)
    return result


@contextlib.contextmanager
def gathered(model: nn.Module):
    """The whole parameters on every rank for the body (each rank may then
    run the model on its own rows with no collective: the counterpart of
    ``host_local_variables``), the blocks again after it. Every rank enters
    it at the same point. A model that is not sharded passes through."""
    if not is_sharded(model):
        yield model
        return
    state = model._upp_fsdp
    params = dict(model.named_parameters())
    blocks = {}
    for name, meta in state.metas.items():
        blocks[name] = params[name].data
        params[name].data = _gather(blocks[name], meta)
    state.enabled = False
    try:
        yield model
    finally:
        state.enabled = True
        for name, block in blocks.items():
            params[name].data = block


def persistent_bytes(model: nn.Module, optimizer=None) -> Tuple[int, int]:
    """(parameter bytes, optimizer state bytes) this rank holds between
    steps."""
    pb = sum(p.numel() * p.element_size() for p in model.parameters())
    ob = 0
    if optimizer is not None:
        opt = getattr(optimizer, "optimizer", optimizer)
        ob = sum(v.numel() * v.element_size() for st in opt.state.values()
                 for v in st.values() if torch.is_tensor(v))
    return pb, ob
