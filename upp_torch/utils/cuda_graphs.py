"""CUDA graphs of the inference passes: a call site's work captured once per
input shape and replayed from then on, so its eager dispatch stops holding
the device back.

``run(owner, site, fn, *args)`` returns ``fn(*args)``. Where every one of
these holds, it replays a graph instead (``eager_reason`` names the first
that fails; nothing else chooses):

* grad mode is off;
* ``owner`` (the module that holds the site's graphs) is not training;
* no process group of more than one rank is initialized (the propagation's
  ``all_gather_rows`` and the synced normalisation's ``all_reduce_sum`` stay
  out of captured regions);
* the tensor arguments are CUDA tensors;
* no capture is under way.

A site's graphs are keyed by its tensor arguments' shapes, strides, dtypes
and device, its other arguments, inference mode and the TF32 switches. The
first call with a key runs eager, which also sets up what is made lazily
(cuBLAS handles, the kernels' libraries, the Chamfer launch plans). The
second runs ``fn`` once on a side stream (that stream's own lazy state),
captures it there into the pool all of ``owner``'s graphs share, and
replays. Every later call copies the arguments into the graph's static
inputs, replays, and returns clones of its static outputs: the next replay
overwrites them, and callers keep outputs across calls.

The graphs live on ``owner``, so they go with it (``clear`` drops them
sooner), at most ``MAX_KEYS`` a site, the least recently used dropped first.
A graph reads ``owner``'s parameters and buffers where they lay at capture.
Before each replay ``run`` checks that none has moved (``.to()``,
``load_state_dict(assign=True)``, resharding); where one has, every graph
of ``owner`` is captured afresh. An update in
place keeps a tensor where it lies, and the replay reads the new values.

Counters (``utils/profiling.count``): a capture runs no kernel, so the
counters' changes over the captured call (the kernel wrappers'
``launches.*``) are taken back and added again at each replay, and
``launches.*`` counts the kernels that ran. ``cuda_graph.captures``,
``cuda_graph.replays`` and ``cuda_graph.eager`` (a call through ``run``
that ran eager, whatever the reason) count the calls.
"""

from __future__ import annotations

import collections
import operator
from typing import Any, Callable, Dict, List, Optional

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
    __slots__ = ("graph", "inputs", "outputs", "counts")


class Graphs:
    """The graphs of one module's call sites: {site: {key: a ``_Graph``, or
    None for a key seen once}}, their pool and side stream, and where the
    module's parameters and buffers lay at capture. A copy or a pickle of
    the module gets none of them."""

    def __init__(self):
        self.sites: Dict[str, collections.OrderedDict] = {}
        self.pool = None
        self.stream: Optional[torch.cuda.Stream] = None
        self.places: Optional[_Places] = None

    def __reduce__(self):                  # copy.deepcopy comes here too
        return (Graphs, ())

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
        """Drop every graph; each key seen is captured at its next call."""
        for graphs in self.sites.values():
            for key in graphs:
                graphs[key] = None
        self.places = None


def graphs_of(owner: torch.nn.Module) -> Graphs:
    graphs = owner.__dict__.get("_cuda_graphs")
    if graphs is None:
        graphs = owner.__dict__["_cuda_graphs"] = Graphs()
    return graphs


def clear(owner: torch.nn.Module) -> None:
    """Drop the graphs ``owner`` holds: each site's next call runs eager."""
    owner.__dict__.pop("_cuda_graphs", None)


def eager_reason(owner: torch.nn.Module, args) -> Optional[str]:
    """Why ``run`` would call ``fn`` eagerly with these arguments (None:
    it graphs)."""
    if torch.is_grad_enabled():
        return "grad"
    if owner.training:
        return "training"
    if get_dist_info()[1] > 1:
        return "ranks"
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    if not tensors or any(t.device.type != "cuda" for t in tensors):
        return "device"
    if torch.cuda.is_current_stream_capturing():
        return "capturing"
    return None


def _key(args) -> tuple:
    return (tuple((tuple(a.shape), a.stride(), a.dtype, a.device)
                  if isinstance(a, torch.Tensor) else a for a in args),
            torch.is_inference_mode_enabled(), torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


def run(owner: torch.nn.Module, site: str, fn: Callable, *args) -> Any:
    """``fn(*args)``, from a replayed CUDA graph where ``eager_reason`` finds
    nothing against it. ``site`` names the call site among ``owner``'s."""
    if eager_reason(owner, args) is not None:
        profiling.count("cuda_graph.eager")
        return fn(*args)
    graphs = graphs_of(owner)
    if graphs.moved(owner):
        graphs.forget()
    site_graphs = graphs.sites.setdefault(site, collections.OrderedDict())
    key = _key(args)
    if key not in site_graphs:
        site_graphs[key] = None
        if len(site_graphs) > MAX_KEYS:
            site_graphs.popitem(last=False)
        profiling.count("cuda_graph.eager")
        return fn(*args)
    site_graphs.move_to_end(key)
    entry = site_graphs[key]
    if entry is None:
        entry = site_graphs[key] = _capture(graphs, owner, fn, args)
    return _replay(entry, args)


def _capture(graphs: Graphs, owner: torch.nn.Module, fn: Callable, args) -> _Graph:
    """Capture ``fn`` on static copies of ``args`` into ``graphs``' pool, on
    its side stream after one eager call there."""
    device = next(a.device for a in args if isinstance(a, torch.Tensor))
    if graphs.stream is None or graphs.stream.device != device:
        graphs.pool = torch.cuda.graph_pool_handle()
        graphs.stream = torch.cuda.Stream(device)
    entry = _Graph()
    entry.inputs = [a.clone() if isinstance(a, torch.Tensor) else a for a in args]
    side = graphs.stream
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn(*entry.inputs)
    before = profiling.counts()
    entry.graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(entry.graph, pool=graphs.pool, stream=side,
                          capture_error_mode="thread_local"):
        entry.outputs = fn(*entry.inputs)
    after = profiling.counts()
    entry.counts = [(k, v - before.get(k, 0)) for k, v in after.items()
                    if v != before.get(k, 0)]
    for k, n in entry.counts:
        profiling.count(k, -n)
    torch.cuda.current_stream(device).wait_stream(side)
    if graphs.places is None:
        graphs.places = _Places(owner)
    profiling.count("cuda_graph.captures")
    return entry


def _replay(entry: _Graph, args) -> Any:
    for static, a in zip(entry.inputs, args):
        if isinstance(a, torch.Tensor):
            static.copy_(a)
    entry.graph.replay()
    for k, n in entry.counts:
        profiling.count(k, n)
    profiling.count("cuda_graph.replays")
    return tree_map_only(torch.Tensor, torch.clone, entry.outputs)
