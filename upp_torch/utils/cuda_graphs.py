"""CUDA graphs of the inference passes and of the training steps: a call
site's work captured once per key and replayed from then on, so its eager
dispatch stops holding the device back. ``run(owner, site, fn, *args)``
graphs an inference pass; ``GraphedStep`` a training step's forward passes,
loss and backward, with the optimizer left eager after it. Both go through
one path:

* ``eager_reason``: a call runs ``fn`` as it is while a capture is under
  way, where the wrapper's own condition holds (``run``: grad on, or
  ``owner`` training; ``GraphedStep``: an accumulating optimizer, or the
  draws given), where a process group of more than one rank is initialized
  (the propagation's ``all_gather_rows`` and the synced normalisation's
  ``all_reduce_sum`` stay out of captured regions), and where a tensor
  argument is not a CUDA tensor.
* ``Graphs.entry``: a site's graphs are keyed by its tensor arguments'
  shapes, strides, dtypes and device, its other arguments, inference mode
  and the TF32 switches (a step's key adds which parameters of ``owner``
  require a gradient, and ``owner.training``). A key's first call runs
  eager, which sets up what is made lazily (cuBLAS handles, the kernels'
  libraries, the Chamfer launch plans); its second captures and replays;
  every later one replays. At most ``MAX_KEYS`` a site, the least recently
  used dropped first. A graph reads ``owner``'s parameters and buffers
  where they lay at capture: where one has moved since (``.to()``,
  ``load_state_dict(assign=True)``, resharding; ``_Places`` tells), every
  graph of ``owner`` is captured afresh. An update in place keeps a tensor
  where it lies, and the replay reads the new values.
* ``_capture``: ``fn`` on static copies of the arguments, on a side stream,
  with the caller's generator registered. A capture that raises (a
  synchronising call) leaves its key eager from then on.
* ``_replay``: the arguments copied into the static inputs, the graph
  replayed, each parameter given the gradient the capture assigned it, and
  clones of the static outputs returned (the next replay overwrites them,
  and callers keep outputs across calls).

Counters (``utils/profiling.count``): a call counts one of
``cuda_graph.eager``, ``cuda_graph.captures`` and ``cuda_graph.replays``,
but a call made while a capture is under way, which is part of that
capture and counts nothing. A capture runs no kernel, so the counters'
changes over it (the kernel wrappers' ``launches.*``) are taken back and
added again at each replay: ``launches.*`` counts the kernels that ran.
"""

from __future__ import annotations

import collections
import functools
import operator
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.nn.modules import module as _module
from torch.utils._pytree import tree_map_only

from ..parallel.dist import get_dist_info
from . import profiling

MAX_KEYS = 8                # graphs kept a site

_registrations = 0          # parameters, buffers and submodules registered anywhere


def _registered(module, name, value):
    global _registrations
    _registrations += 1


for _hook in (_module.register_module_parameter_registration_hook,
              _module.register_module_buffer_registration_hook,
              _module.register_module_module_registration_hook):
    _hook(_registered)


class _Places:
    """Where a module's parameters and buffers lie: their slots (the dict
    and key of each) and the data pointers found there. Read again in full
    only after a registration anywhere in the process (a slot may have come
    or gone); otherwise the pointers are read from the slots: 88 µs a check
    on the full-width cls model on an H100 machine's host, where walking
    ``parameters()`` and ``buffers()`` takes 1.6 ms."""

    def __init__(self, owner: torch.nn.Module):
        self.registrations = _registrations
        self.dicts: List[dict] = []
        self.keys: List[str] = []
        for m in owner.modules():
            for d in (m._parameters, m._buffers):
                for k, t in d.items():
                    if t is not None:
                        self.dicts.append(d)
                        self.keys.append(k)
        self.ptrs = self.read()

    def read(self) -> Optional[List[int]]:
        try:
            return list(map(torch.Tensor.data_ptr, map(operator.getitem, self.dicts, self.keys)))
        except (KeyError, TypeError):   # a slot emptied or holding no tensor
            return None


class _Graph:
    __slots__ = ("graph", "inputs", "outputs", "counts", "grads")


_FIRST = "first"            # a key's first call: it runs eager
_FAILED = "failed"          # a key whose capture raised: it runs eager from then on


class Graphs:
    """The graphs of one owner's call sites: {site: {key: a ``_Graph``, or
    None for a key to be captured at its next call}}, their side stream,
    their memory pool where they share one, and where the owner's
    parameters and buffers lay at capture. A copy or a pickle gets none of
    them."""

    def __init__(self, shared_pool: bool = True):
        self.sites: Dict[str, collections.OrderedDict] = {}
        self.shared_pool = shared_pool
        self.pool = None
        self.stream: Optional[torch.cuda.Stream] = None
        self.places: Optional[_Places] = None

    def __reduce__(self):                  # copy.deepcopy comes here too
        return (Graphs, (self.shared_pool,))

    def moved(self, owner: torch.nn.Module) -> bool:
        """Whether a parameter or buffer of ``owner`` lies elsewhere than at
        capture (False before any capture)."""
        places = self.places
        if places is None:
            return False
        if places.registrations != _registrations:
            self.places = _Places(owner)
            return self.places.ptrs != places.ptrs
        return places.read() != places.ptrs

    def forget(self) -> None:
        """Drop every graph; each key seen is captured at its next call (a
        key whose capture raised stays eager)."""
        for graphs in self.sites.values():
            for key, entry in graphs.items():
                if entry is not _FAILED:
                    graphs[key] = None
        self.places = None

    def entry(self, owner: torch.nn.Module, site: str, key: tuple) -> Any:
        """The graph of ``key`` at ``site``: ``_FIRST`` at the key's first
        call, None where it is to be captured now, ``_FAILED`` where its
        capture raised. At most ``MAX_KEYS`` a site, the least recently used
        dropped; every graph dropped first where a parameter or buffer of
        ``owner`` moved."""
        if self.moved(owner):
            self.forget()
        keys = self.sites.setdefault(site, collections.OrderedDict())
        if key not in keys:
            keys[key] = None
            if len(keys) > MAX_KEYS:
                keys.popitem(last=False)
            return _FIRST
        keys.move_to_end(key)
        return keys[key]


def graphs_of(owner: torch.nn.Module) -> Graphs:
    graphs = owner.__dict__.get("_cuda_graphs")
    if graphs is None:
        graphs = owner.__dict__["_cuda_graphs"] = Graphs()
    return graphs


def clear(owner: torch.nn.Module) -> None:
    """Drop the graphs ``owner`` holds: each site's next call runs eager."""
    owner.__dict__.pop("_cuda_graphs", None)


def eager_reason(args, own: Optional[str] = None) -> Optional[str]:
    """Why a call with these arguments runs eagerly (None: it graphs, from
    its key's second call on): a capture under way, then ``own`` (the
    calling wrapper's reason, where it has one), more than one rank, a
    tensor argument off CUDA (or none)."""
    if profiling.capturing():
        return "capturing"
    if own is not None:
        return own
    if get_dist_info()[1] > 1:
        return "ranks"
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    if not tensors or any(t.device.type != "cuda" for t in tensors):
        return "device"
    return None


def _key(args) -> tuple:
    return (tuple((tuple(a.shape), a.stride(), a.dtype, a.device)
                  if isinstance(a, torch.Tensor) else a for a in args),
            torch.is_inference_mode_enabled(), torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


def run(owner: torch.nn.Module, site: str, fn: Callable, *args) -> Any:
    """``fn(*args)``, from a replayed CUDA graph where ``eager_reason`` finds
    nothing against it. ``site`` names the call site among ``owner``'s,
    which holds the site's graphs (a copy of ``owner`` holds none)."""
    own = "grad" if torch.is_grad_enabled() else "training" if owner.training else None
    reason = eager_reason(args, own)
    if reason is not None:
        return _eager(reason, fn, args)
    return _graphed(graphs_of(owner), owner, site, _key(args), fn, args)


class GraphedStep:
    """``step(*args, generator=None, accumulate=1, draws=None)`` returns
    ``fn(*args, generator=generator, draws=draws)``, where ``fn`` is a
    training step's forward passes, loss and ``backward()`` (the optimizer
    stays outside it) and returns tensors; graphed as the module's doc says.

    The caller clears the gradients (``set_to_none``) before each call, so
    the captured backward assigns them into the graph's pool; after each
    replay every parameter that the backward reached holds the graph's
    static gradient as ``.grad`` (the others keep None), which the optimizer
    may scale in place. Every replay draws what an eager call would from the
    generator's state before it: the caller seeds it before each call and
    passes the same generator with a key (the steps' one a device). The
    graphs go with the ``GraphedStep``."""

    def __init__(self, owner: torch.nn.Module, fn: Callable):
        self.owner = owner
        self.fn = fn
        self.graphs = Graphs(shared_pool=False)
        self.params: List[torch.nn.Parameter] = []
        self.params_at = -1         # ``_registrations`` when ``params`` was read

    def key(self, args) -> tuple:
        if self.params_at != _registrations:
            self.params = list(self.owner.parameters())
            self.params_at = _registrations
        return _key(args), tuple(p.requires_grad for p in self.params), self.owner.training

    def __call__(self, *args, generator: Optional[torch.Generator] = None,
                 accumulate: int = 1, draws: Any = None) -> Any:
        fn = functools.partial(self.fn, generator=generator, draws=draws)
        own = "accumulate" if accumulate > 1 else "draws" if draws is not None else None
        reason = eager_reason(args, own)
        if reason is not None:
            return _eager(reason, fn, args)
        return _graphed(self.graphs, self.owner, "step", self.key(args), fn, args, generator)


def _eager(reason: str, fn: Callable, args) -> Any:
    if reason != "capturing":       # else the call is part of the capture
        profiling.count("cuda_graph.eager")
    return fn(*args)


def _graphed(graphs: Graphs, owner: torch.nn.Module, site: str, key: tuple, fn: Callable,
             args, generator: Optional[torch.Generator] = None) -> Any:
    """``fn(*args)`` at ``site``'s ``key``: eager at the key's first call and
    after its capture raised, captured at its second, replayed from then on."""
    entry = graphs.entry(owner, site, key)
    if entry is _FIRST or entry is _FAILED:
        return _eager(entry, fn, args)
    if entry is None:
        try:
            entry = _capture(graphs, owner, fn, args, generator)
        except RuntimeError:
            graphs.sites[site][key] = _FAILED
            return _eager(_FAILED, fn, args)
        graphs.sites[site][key] = entry
        profiling.count("cuda_graph.captures")
    else:
        profiling.count("cuda_graph.replays")
    return _replay(entry, args)


def _side_stream(graphs: Graphs, device: torch.device) -> torch.cuda.Stream:
    """``graphs``' side stream on ``device``, made at the first capture
    there (a pool made for another device is dropped with its stream)."""
    if graphs.stream is None or graphs.stream.device != device:
        graphs.pool = None
        graphs.stream = torch.cuda.Stream(device)
    return graphs.stream


def _take_back(before: Dict[str, int]) -> List[Tuple[str, int]]:
    """The counters' changes since ``before`` (a capture's), taken back."""
    changes = [(k, v - before.get(k, 0)) for k, v in profiling.counts().items()
               if v != before.get(k, 0)]
    for k, n in changes:
        profiling.count(k, -n)
    return changes


def _unstick(gens: List[torch.Generator], states: List[torch.Tensor]) -> None:
    """Put each generator of ``gens`` (the device's default one first) back
    at its state of ``states`` after a capture that raised. Such a capture
    can end before its generators' states leave capture mode, where they
    refuse every draw outside a capture; a capture of one draw from each,
    ended, takes them out of it in place, so the graphs that registered
    those states (other keys', other sites') go on reading the states that
    the generators' seeding updates."""
    graph = torch.cuda.CUDAGraph()
    for g in gens[1:]:              # every capture registers the default one
        graph.register_generator_state(g)
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for g in gens:
            torch.empty(1, device=g.device).uniform_(generator=g)
    del graph
    for g, state in zip(gens, states):
        g.set_state(state)


def _capture(graphs: Graphs, owner: torch.nn.Module, fn: Callable, args,
             generator: Optional[torch.Generator]) -> _Graph:
    """``fn`` captured on static copies of ``args`` on ``graphs``' side
    stream, ``generator`` registered where given. The gradients it assigns
    (a ``.grad`` of ``owner``'s set anew) are the graph's static ones. A
    capture that raises puts back the current stream, the generators' states
    and the gradients, and drops the side stream."""
    device = next(a.device for a in args if isinstance(a, torch.Tensor))
    main = torch.cuda.current_stream(device)
    side = _side_stream(graphs, device)
    # a step graph's static gradients outlive its replay, so each step key
    # has a pool of its own; pass graphs' outputs are cloned and they replay
    # in turn, so an owner's live pass graphs share one. A pool that no live
    # graph holds is not captured into again: what a capture made lazily
    # (the side stream's cuBLAS workspace) keeps it from being freed, and
    # the allocator refuses such a pool
    if graphs.shared_pool and (graphs.pool is None or not any(
            isinstance(e, _Graph) for keys in graphs.sites.values() for e in keys.values())):
        graphs.pool = torch.cuda.graph_pool_handle()
    gens = [torch.cuda.default_generators[device.index]]
    if generator is not None:
        gens.append(generator)
    states = [g.get_state() for g in gens]
    params = list(owner.parameters())
    grads = [p.grad for p in params]
    entry = _Graph()
    entry.inputs = [a.clone() if isinstance(a, torch.Tensor) else a for a in args]
    entry.graph = torch.cuda.CUDAGraph()
    if generator is not None:
        entry.graph.register_generator_state(generator)
    before = profiling.counts()
    side.wait_stream(main)
    try:
        with torch.cuda.graph(entry.graph, pool=graphs.pool, stream=side,
                              capture_error_mode="thread_local"):
            entry.outputs = fn(*entry.inputs)
    except RuntimeError:
        # a capture that fails can leave the side stream current, its
        # allocations routed to the failed capture's pool, the generators
        # marked as capturing and gradients in that pool
        torch.cuda.set_stream(main)
        graphs.stream = None
        _unstick(gens, states)
        for p, grad in zip(params, grads):
            if p.grad is not grad:
                p.grad = grad
        raise
    finally:
        entry.counts = _take_back(before)
        main.wait_stream(side)
    entry.grads = [(p, p.grad) for p, grad in zip(params, grads) if p.grad is not grad]
    if graphs.places is None:
        graphs.places = _Places(owner)
    return entry


def _replay(entry: _Graph, args) -> Any:
    for static, a in zip(entry.inputs, args):
        if isinstance(a, torch.Tensor):
            static.copy_(a)
    entry.graph.replay()
    for p, grad in entry.grads:
        p.grad = grad
    for k, n in entry.counts:
        profiling.count(k, n)
    return tree_map_only(torch.Tensor, torch.clone, entry.outputs)
