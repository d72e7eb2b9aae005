"""Tracing, profiling and FLOPs accounting (counterpart of
``upp_tpu/utils/profiling.py``).

The reference has no profiler beyond wall-clock AverageMeters and
commented-out ptflops probes (``tools/runner_module.py:77-79,95-96``).
Here:

* the recorder: ``annotate(name)`` spans, ``count(name)`` counters,
  ``tracing()`` to turn it on, ``units()`` to read what it holds (below);
* ``maybe_trace(dir)``: a ``torch.profiler`` trace of the enclosed block
  written to ``dir`` (or ``UPP_PROFILE_DIR``) as Chrome trace JSON;
* ``cost_analysis(fn, *args)``: FLOPs (``FlopCounterMode``) and bytes
  accessed (each aten op's inputs and outputs, XLA's per-op count) of one
  call, the ptflops replacement;
* ``profile_train_step``: the per-phase wall-time table of the flagship
  PEFT train step, by ablation (``python -m upp_torch.utils.profiling
  [config.yaml] [--deep]``, on the card).

**The recorder.** ``with annotate(name):`` marks a span. It is off by
default: then ``annotate`` tests two flags and returns a shared no-op, with
no profiler range, no CUDA event and no allocation. It is on inside
``tracing()`` and whenever a ``torch.profiler`` is recording. An open span
with no open span above it is a root; a root and the spans under it are a
*unit* (the runners' step closures are roots). A span on records its name,
its parent, the host clock at both ends (``time.time_ns()``, the clock
``torch.profiler`` stamps its events with), a ``record_function`` range
while a profiler records (so it stands in that profiler's trace), and, once
the process uses CUDA, a timing event on the current stream at both ends:
its *device window*, from the moment the device finished the work enqueued
before the span to the moment it finished the span's own.

``count(name, n)`` adds to a counter, always (the kernel wrappers count
their launches as ``launches.<kernel>``). A root stores the change of every
counter over its unit. While a root is open on CUDA the recorder sets
``torch.cuda.set_sync_debug_mode("warn")`` (where it was off) and counts
the synchronising calls it reports on the root's thread as ``host_syncs``;
such a report from another thread is dropped (the mode is process-wide and
on only because the recorder set it), and every other warning passes on
as it came. While the current stream captures a CUDA graph ``annotate``
returns the no-op: the captured work runs later, at each replay, so a span
of a replayed pass does not exist (``utils/cuda_graphs.py``).

``units()`` synchronises once, places every device window on the host
clock by one anchor event (recorded after the sync, so it runs at once)
and returns each unit with its spans' host ms and window ms and its
counter changes. A window is a stretch of the stream's timeline, so it
holds the device's idle time inside the span as well as its work: where
the host is slower than the device, a window follows the host. The
recorder keeps the last ``MAX_UNITS`` units; ``reset()`` clears them and
the counters. Spans change no arithmetic.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import os
import threading
import time
import warnings
from typing import Any, Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

MAX_UNITS = 4096
SYNC_WARNING = "called a synchronizing CUDA operation"

_forced = 0                                    # open ``tracing()`` blocks
_counts: Dict[str, int] = {}
_units: collections.deque = collections.deque(maxlen=MAX_UNITS)
_local = threading.local()                     # .stack: this thread's open spans


class _Off:
    """The span when the recorder is off."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _SyncWatch:
    """Counts the synchronising calls PyTorch reports on this thread while a
    root is open: sync debug mode ``warn``, its warning shown every time, and
    a ``warnings.showwarning`` in front of the one in place."""

    def __init__(self):
        self.thread = threading.get_ident()
        self.syncs = 0
        warnings.filterwarnings("always", message=SYNC_WARNING)
        self.filter = warnings.filters[0]
        self.shown = warnings.showwarning
        warnings.showwarning = self.show
        torch.cuda.set_sync_debug_mode("warn")

    def show(self, message, category, filename, lineno, file=None, line=None):
        if SYNC_WARNING not in str(message):
            self.shown(message, category, filename, lineno, file, line)
        elif threading.get_ident() == self.thread:
            self.syncs += 1

    def close(self) -> int:
        torch.cuda.set_sync_debug_mode(0)
        if warnings.showwarning == self.show:
            warnings.showwarning = self.shown
        with contextlib.suppress(ValueError):
            warnings.filters.remove(self.filter)
        return self.syncs


class _Span:
    __slots__ = ("name", "parent", "root", "spans", "start_ns", "end_ns", "events",
                 "window_ns", "counts", "_range", "_before", "_watch")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1] if stack else None
        self.root = self.parent.root if self.parent is not None else self
        self.events = self.window_ns = self.counts = self._range = None
        if self.parent is None:
            self.spans = []
            self._before = dict(_counts)
            self._watch = None
            if torch.cuda.is_initialized() and torch.cuda.get_sync_debug_mode() == 0:
                self._watch = _SyncWatch()
        else:
            self.root.spans.append(self)
        stack.append(self)
        if _autograd_profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self.start_ns = time.time_ns()
        if torch.cuda.is_initialized():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record()
        self.end_ns = time.time_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        _local.stack.pop()
        if self.parent is None:
            if self._watch is not None:
                count("host_syncs", self._watch.close())
                self._watch = None
            self.counts = {k: v - self._before.get(k, 0) for k, v in _counts.items()
                           if v != self._before.get(k, 0)}
            self._before = None
            _units.append(self)
        return False


def capturing() -> bool:
    """Whether the current CUDA stream is capturing a graph (False before
    the process uses CUDA)."""
    return torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing()


def annotate(name: str):
    """A span named ``name`` (a context manager); a shared no-op while the
    recorder is off, and while the current stream captures a CUDA graph
    (an event recorded into a capture cannot be timed)."""
    if (_forced or _autograd_profiler._is_profiler_enabled) and not capturing():
        return _Span(name)
    return _OFF


@contextlib.contextmanager
def tracing():
    """Turn the recorder on for the enclosed block."""
    global _forced
    _forced += 1
    try:
        yield
    finally:
        _forced -= 1


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name``."""
    _counts[name] = _counts.get(name, 0) + n


def counts() -> Dict[str, int]:
    """The counters as they stand."""
    return dict(_counts)


def reset() -> None:
    """Forget every unit held and zero the counters."""
    _units.clear()
    _counts.clear()


def _place(spans) -> None:
    """Each span's device window on the host clock (ns), its events freed."""
    pending = [s for s in spans if s.events is not None]
    if not pending:
        return
    torch.cuda.synchronize()
    anchor = torch.cuda.Event(enable_timing=True)
    anchor.record()
    anchor.synchronize()
    now = time.time_ns()
    for s in pending:
        a, b = s.events
        s.window_ns = (now - round(a.elapsed_time(anchor) * 1e6),
                       now - round(b.elapsed_time(anchor) * 1e6))
        s.events = None


def _row(s) -> Dict[str, Any]:
    win = s.window_ns
    return {"name": s.name, "parent": s.parent.name if s.parent is not None else None,
            "unit": s.root.name, "start_ns": s.start_ns, "end_ns": s.end_ns,
            "host_ms": (s.end_ns - s.start_ns) / 1e6,
            "window_start_ns": win[0] if win else None,
            "window_end_ns": win[1] if win else None,
            "window_ms": (win[1] - win[0]) / 1e6 if win else None}


def units() -> List[Dict[str, Any]]:
    """The units held, oldest first: the root's row (``name``, ``host_ms``,
    ``window_ms``, the ends of each on the host clock), ``spans`` (a row
    each, in the order they opened, with ``parent`` and ``unit``) and
    ``counts`` (each counter that changed over the unit, by how much).
    Windows are None without CUDA."""
    held = list(_units)
    _place([s for u in held for s in (u, *u.spans)])
    return [{**_row(u), "spans": [_row(s) for s in u.spans], "counts": dict(u.counts)}
            for u in held]


@contextlib.contextmanager
def maybe_trace(trace_dir: Optional[str] = None):
    """Profile the enclosed block when a directory is given (or through the
    ``UPP_PROFILE_DIR`` environment variable): host and, with CUDA, device
    activity, written to ``<dir>/trace-<pid>-<ns>.json`` (Chrome trace
    format, ``chrome://tracing`` or Perfetto). Yields the profiler, or None
    when not tracing."""
    trace_dir = trace_dir or os.environ.get("UPP_PROFILE_DIR")
    if not trace_dir:
        yield None
        return
    os.makedirs(trace_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        trace_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


class _BytesAccessed(TorchDispatchMode):
    """Sums the bytes of every aten op's tensor inputs and outputs (a view
    moves none), by op."""

    def __init__(self):
        super().__init__()
        self.by_op: Dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            n = sum(t.numel() * t.element_size()
                    for t in tree_leaves((args, kwargs or {}, out))
                    if isinstance(t, torch.Tensor))
            key = str(func.overloadpacket)
            self.by_op[key] = self.by_op.get(key, 0) + n
        return out


def cost_analysis(fn, *args, **kwargs) -> Dict[str, Any]:
    """FLOPs, bytes accessed and their ratio for one call of ``fn`` (the
    keys of the JAX package's ``cost_analysis``); ``raw`` holds both by aten
    op. FLOPs come from ``torch.utils.flop_counter.FlopCounterMode`` (a
    multiply-add counts 2), bytes as XLA counts them: each op's inputs read
    and outputs written once."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    bytes_mode = _BytesAccessed()
    with counter, bytes_mode:
        fn(*args, **kwargs)
    flops_by_op = {str(k): v for k, v in counter.get_flop_counts().get("Global", {}).items()}
    flops = float(counter.get_total_flops())
    bytes_accessed = float(sum(bytes_mode.by_op.values()))
    return {
        "flops": flops,
        "bytes_accessed": bytes_accessed,
        "arithmetic_intensity": flops / bytes_accessed if bytes_accessed else 0.0,
        "raw": {"flops": flops_by_op, "bytes accessed": dict(bytes_mode.by_op)},
    }


def profile_train_step(config_path: str = "cfgs/unify_modelnet_cls.yaml",
                       iters: int = 15, batch_size: Optional[int] = None,
                       deep: bool = False, device="cuda") -> Dict[str, float]:
    """Per-phase wall-time profile of the flagship PEFT train step on
    ``device`` (``upp_tpu/utils/profiling.py:61-222``): the full step, and
    the step without the crop/noise/augment pipeline, with the downstream
    pass alone and forward only; each phase is the difference of two. With
    ``deep`` also the cost of prompt propagation, the adapters and the
    prompt tokens, each from a step of a model built without it. Each
    variant runs ``iters`` steps back to back after a warm-up step, timed by
    CUDA events on the card (the host clock on the CPU). Prints the table;
    returns {row: ms per step}."""
    import numpy as np

    from .. import resolve_device
    from ..models import build_model_from_cfg
    from ..parallel import shard
    from ..train.metrics import cross_entropy_loss_acc
    from ..train.optim import build_optimizer, set_trainable
    from ..train.pipeline import corrupt_batch
    from ..train.runner_cls import PEFT_LIST
    from .config import cfg_from_yaml_file

    dev = resolve_device(device)
    config = cfg_from_yaml_file(config_path)
    B = int(batch_size or config.total_bs)
    n_pts_ds = int(config.dataset.train._base_.N_POINTS)
    npoints = int(config.npoints)

    def build(model_cfg):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model = build_model_from_cfg(model_cfg)
        model = model.to(dev)
        set_trainable(model, PEFT_LIST)
        return model, build_optimizer(config, model, steps_per_epoch=82)

    model, optimizer = build(config.model)
    rng0 = np.random.default_rng(0)
    pts = torch.from_numpy(rng0.standard_normal((B, n_pts_ds, 3)).astype(np.float32)).to(dev)
    label = torch.from_numpy(rng0.integers(0, int(config.model.cls_dim), B)).to(dev)
    gen = torch.Generator(dev).manual_seed(1)

    def make_step(model, optimizer, do_pipe=True, passes="full", do_grad=True):
        full = passes == "full"

        def train_step():
            model.train()
            with shard.global_batch(shard.Shard(), gen), torch.set_grad_enabled(do_grad):
                if do_pipe:
                    points = corrupt_batch(
                        pts, npoints=npoints, n_points_dataset=n_pts_ds, noisy_train=True,
                        incomplete_cropping=True, add_noise=True,
                        noise_types=("gaussian_noise", "lidar_noise"),
                        augmentation="scale-translate", normalize=False, generator=gen)
                else:
                    points = pts[:, :npoints + 72]
                logits = model(points, completion_prompt=full, denoise=full,
                               point_num=npoints)
                loss, _ = cross_entropy_loss_acc(logits, label)
            if do_grad:
                optimizer.zero_grad()
                loss.backward()
                optimizer.step()
            return loss.detach()
        return train_step

    def run(model=model, optimizer=optimizer, **kw):
        step = make_step(model, optimizer, **kw)
        float(step())
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                loss = step()
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / iters
        t0 = time.perf_counter()
        for _ in range(iters):
            loss = step()
        float(loss)
        return (time.perf_counter() - t0) / iters * 1000.0

    def run_variant(**model_cfg_overrides):
        """The full step of a model whose config differs by the overrides
        (a dotted key each): the cost of a feature one model cannot switch
        off."""
        mc = copy.deepcopy(config.model)
        for k, v in model_cfg_overrides.items():
            parts = k.split(".")
            tgt = mc
            for p in parts[:-1]:
                tgt = tgt[p]
            tgt[parts[-1]] = v
        return run(*build(mc))

    full = run()
    no_pipe = run(do_pipe=False)
    down_only = run(passes="downstream")
    fwd_only = run(do_grad=False)
    rows = [
        ("full train step", full),
        ("  crop/noise/augment pipeline", full - no_pipe),
        ("  rectify+completion passes (fwd)", full - down_only),
        ("  bwd + optimizer (PEFT scope)", full - fwd_only),
        ("  downstream fwd + encoder/heads", fwd_only - (full - no_pipe)
         - (full - down_only)),
    ]
    if deep:
        no_prop = run_variant(prompt_propagation_after=False)
        no_adapters = run_variant(**{"prompter_config.rectify_adapter": False,
                                     "prompter_config.pretask_adapter": False,
                                     "prompter_config.downstream_adapter": False})
        no_prompts = run_variant(**{"prompter_config.rectify_prompts": False,
                                    "prompter_config.pretask_prompts": False,
                                    "prompter_config.downstream_prompts": False})
        rows += [
            ("  [deep] prompt propagation (all blocks)", full - no_prop),
            ("  [deep] adapters (all paths)", full - no_adapters),
            ("  [deep] prompt tokens (attn width delta)", full - no_prompts),
        ]
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"{'phase':44s} ms/step  (bs={B}, x{iters} back to back, {where})")
    for name, ms in rows:
        print(f"{name:44s} {ms:7.1f}")
    return dict(rows)


if __name__ == "__main__":
    import sys
    argv = [a for a in sys.argv[1:] if a != "--deep"]
    profile_train_step(*(argv[:1] or ["cfgs/unify_modelnet_cls.yaml"]),
                       deep="--deep" in sys.argv)
