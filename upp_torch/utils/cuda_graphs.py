"""CUDA graphs of the inference passes and of the training steps: a call
site's work captured once per input shape and replayed from then on, so its
eager dispatch stops holding the device back. ``run`` graphs an inference
pass (below); ``GraphedStep`` a training step's forward passes, loss and
backward, with the optimizer left eager after it (its docstring). They
share the key cache (``Graphs.entry``: eager at a key's first call, at most
``MAX_KEYS`` a site, every graph recaptured after a parameter or buffer
moved, which ``_Places`` tells), the shape part of the key, the side stream
and the counters' take-back at capture.

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
    __slots__ = ("graph", "inputs", "outputs", "counts")


_FIRST = "first"            # a key's first call: it runs eager
_FAILED = "failed"          # a key whose capture raised: it runs eager from then on


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
    key = _key(args)
    entry = graphs.entry(owner, site, key)
    if entry is _FIRST:
        profiling.count("cuda_graph.eager")
        return fn(*args)
    if entry is None:
        entry = graphs.sites[site][key] = _capture(graphs, owner, fn, args)
    return _replay(entry, args)


def _side_stream(graphs: Graphs, device: torch.device) -> torch.cuda.Stream:
    """``graphs``' side stream on ``device``, made at the first capture
    there (a pool made for another device is dropped with its stream)."""
    if graphs.stream is None or graphs.stream.device != device:
        graphs.pool = None
        graphs.stream = torch.cuda.Stream(device)
    return graphs.stream


def _static_inputs(args) -> list:
    return [a.clone() if isinstance(a, torch.Tensor) else a for a in args]


def _take_back(before: Dict[str, int]) -> List[Tuple[str, int]]:
    """The counters' changes since ``before`` (a capture's), taken back."""
    changes = [(k, v - before.get(k, 0)) for k, v in profiling.counts().items()
               if v != before.get(k, 0)]
    for k, n in changes:
        profiling.count(k, -n)
    return changes


def _capture(graphs: Graphs, owner: torch.nn.Module, fn: Callable, args) -> _Graph:
    """Capture ``fn`` on static copies of ``args`` into ``graphs``' pool, on
    its side stream after one eager call there."""
    device = next(a.device for a in args if isinstance(a, torch.Tensor))
    side = _side_stream(graphs, device)
    if graphs.pool is None:
        graphs.pool = torch.cuda.graph_pool_handle()
    entry = _Graph()
    entry.inputs = _static_inputs(args)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn(*entry.inputs)
    before = profiling.counts()
    entry.graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(entry.graph, pool=graphs.pool, stream=side,
                          capture_error_mode="thread_local"):
        entry.outputs = fn(*entry.inputs)
    entry.counts = _take_back(before)
    torch.cuda.current_stream(device).wait_stream(side)
    if graphs.places is None:
        graphs.places = _Places(owner)
    profiling.count("cuda_graph.captures")
    return entry


def _launch(entry: _Graph, args) -> None:
    """Copy ``args`` into the graph's static inputs, replay it, and add the
    counters' changes its capture took back."""
    for static, a in zip(entry.inputs, args):
        if isinstance(a, torch.Tensor):
            static.copy_(a)
    entry.graph.replay()
    for k, n in entry.counts:
        profiling.count(k, n)


def _replay(entry: _Graph, args) -> Any:
    _launch(entry, args)
    profiling.count("cuda_graph.replays")
    return tree_map_only(torch.Tensor, torch.clone, entry.outputs)


# -- the training step -----------------------------------------------------------

def step_eager_reason(args, accumulate: int = 1, draws: Any = None) -> Optional[str]:
    """Why ``GraphedStep`` would run a step eagerly with these arguments
    (None: it graphs, from the key's second call on)."""
    if profiling.capturing():
        return "capturing"
    if get_dist_info()[1] > 1:
        return "ranks"
    if accumulate > 1:
        return "accumulate"
    if draws is not None:
        return "draws"
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    if not tensors or any(t.device.type != "cuda" for t in tensors):
        return "device"
    return None


def _unstick(gens: List[torch.Generator], states: List[torch.Tensor]) -> None:
    """Put each generator of ``gens`` (the device's default one first) back
    at its state of ``states`` after a capture that raised. Such a capture
    can end before its generators' states leave capture mode, where they
    refuse every draw outside a capture; a capture of one draw from each,
    ended, takes them out of it in place, so the graphs that registered
    those states (other keys', ``run``'s) go on reading the states that the
    generators' seeding updates."""
    graph = torch.cuda.CUDAGraph()
    for g in gens[1:]:              # every capture registers the default one
        graph.register_generator_state(g)
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for g in gens:
            torch.empty(1, device=g.device).uniform_(generator=g)
    del graph
    for g, state in zip(gens, states):
        g.set_state(state)


class _StepGraph(_Graph):
    __slots__ = ("grads",)          # (parameter, static gradient) pairs


class GraphedStep:
    """``step(*args, generator=None, accumulate=1, draws=None)`` returns
    ``fn(*args, generator=generator, draws=draws)``, where ``fn`` is a
    training step's forward passes, loss and ``backward()`` (the optimizer
    stays outside it) and returns tensors. Where ``step_eager_reason`` finds
    nothing against it, the second call with a key captures ``fn`` as one
    CUDA graph and every later call replays it.

    The key: the tensor arguments' shapes, strides, dtypes and device,
    inference mode and the TF32 switches (as ``run``'s), which parameters of
    ``owner`` require a gradient (a change of the trainable set captures
    anew) and ``owner.training``. At most ``MAX_KEYS``, the least recently
    used dropped first; where a parameter or buffer of ``owner`` moved,
    every key is captured afresh.

    A key's first call runs eager on the caller's stream: that is its
    warm-up. The second expects the gradients cleared (``set_to_none``), so
    the captured backward assigns them into the graph's own pool; it
    captures ``fn`` on a side stream with the generator registered
    (``register_generator_state``) and replays, so that call too has the
    effect of one step. Every replay draws what an eager call would from the
    generator's state before it: the caller seeds it before each call, and
    passes the same generator with a key (the steps' one a device). After
    each replay every parameter that the backward reached holds the graph's
    static gradient as ``.grad`` (the others keep None), which the optimizer
    may scale in place (the next replay overwrites it), and the outputs are
    clones. Each graph has a memory pool of its own (a key's static
    gradients and outputs stay live while another key replays), and the
    graphs go with the ``GraphedStep``. A capture that raises (a
    synchronising call) leaves its key eager.

    Counters as ``run``'s, but for ``cuda_graph.*``: a replay counts
    ``cuda_graph.replays``, the call that captures ``cuda_graph.captures``,
    an eager call ``cuda_graph.eager``; the capture's own ``cuda_graph.*``
    changes (the passes' ``run`` calls, eager under grad) are not added
    again at a replay."""

    def __init__(self, owner: torch.nn.Module, fn: Callable):
        self.owner = owner
        self.fn = fn
        self.graphs = Graphs()
        self.keys = self.graphs.sites["step"] = collections.OrderedDict()
        self.params: List[torch.nn.Parameter] = []
        self.params_at = -1         # ``_registrations`` when ``params`` was read

    def key(self, args) -> tuple:
        if self.params_at != _registrations:
            self.params = list(self.owner.parameters())
            self.params_at = _registrations
        return _key(args), tuple(p.requires_grad for p in self.params), self.owner.training

    def __call__(self, *args, generator: Optional[torch.Generator] = None,
                 accumulate: int = 1, draws: Any = None) -> Any:
        if step_eager_reason(args, accumulate, draws) is not None:
            return self._eager(args, generator, draws)
        key = self.key(args)
        entry = self.graphs.entry(self.owner, "step", key)
        if entry is _FIRST or entry is _FAILED:
            return self._eager(args, generator, draws)
        if entry is None:
            try:
                entry = self._capture(args, generator)
            except RuntimeError:
                self.keys[key] = _FAILED
                return self._eager(args, generator, draws)
            self.keys[key] = entry
            profiling.count("cuda_graph.captures")
        else:
            profiling.count("cuda_graph.replays")
        return self._replay(entry, args)

    def _eager(self, args, generator, draws) -> Any:
        profiling.count("cuda_graph.eager")
        return self.fn(*args, generator=generator, draws=draws)

    def _capture(self, args, generator) -> _StepGraph:
        device = next(a.device for a in args if isinstance(a, torch.Tensor))
        main = torch.cuda.current_stream(device)
        side = _side_stream(self.graphs, device)
        entry = _StepGraph()
        entry.inputs = _static_inputs(args)
        gens = [torch.cuda.default_generators[device.index]]
        if generator is not None:
            gens.append(generator)
        states = [g.get_state() for g in gens]
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)
        before = profiling.counts()
        side.wait_stream(main)
        try:
            with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
                entry.outputs = self.fn(*entry.inputs, generator=generator, draws=None)
        except RuntimeError:
            # a capture that fails can leave the side stream current, its
            # allocations routed to the failed capture's pool, the
            # generators marked as capturing and gradients in that pool
            torch.cuda.set_stream(main)
            self.graphs.stream = None
            _unstick(gens, states)
            for p in self.params:
                p.grad = None
            raise
        finally:
            changes = _take_back(before)
            main.wait_stream(side)
        entry.graph = graph
        entry.counts = [(k, n) for k, n in changes if not k.startswith("cuda_graph.")]
        entry.grads = [(p, p.grad) for p in self.params if p.grad is not None]
        if self.graphs.places is None:
            self.graphs.places = _Places(self.owner)
        return entry

    def _replay(self, entry: _StepGraph, args) -> Any:
        _launch(entry, args)
        for p, grad in entry.grads:
            p.grad = grad
        return tree_map_only(torch.Tensor, torch.clone, entry.outputs)
