"""Tracing, profiling and FLOPs accounting (counterpart of
``upp_tpu/utils/profiling.py``).

The reference has no profiler beyond wall-clock AverageMeters and
commented-out ptflops probes (``tools/runner_module.py:77-79,95-96``).
Here:

* ``annotate(name)``: a named range in a ``torch.profiler`` trace
  (``record_function``), and an NVTX range when CUDA is present;
* ``maybe_trace(dir)``: a ``torch.profiler`` trace of the enclosed block
  written to ``dir`` (or ``UPP_PROFILE_DIR``) as Chrome trace JSON;
* ``cost_analysis(fn, *args)``: FLOPs (``FlopCounterMode``) and bytes
  accessed (each aten op's inputs and outputs, XLA's per-op count) of one
  call, the ptflops replacement;
* ``profile_train_step``: the per-phase wall-time table of the flagship
  PEFT train step, by ablation (``python -m upp_torch.utils.profiling
  [config.yaml] [--deep]``, on the card).
"""

from __future__ import annotations

import contextlib
import copy
import os
import time
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


@contextlib.contextmanager
def annotate(name: str):
    """Named trace region: a ``torch.profiler`` range, and an NVTX range
    when CUDA is present."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


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
