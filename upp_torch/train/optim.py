"""Optimizer, schedule and PEFT trainable set (counterpart of
``upp_tpu/train/optim.py``; reference ``tools/builder.py:37-89``).

* AdamW over ALL parameters, with a no-decay group for 1-D parameters,
  biases and anything with "token" in its name (``builder.py:40-55``);
  ``Adam`` (``optax.adam``: no weight decay) and ``SGD`` (Nesterov,
  ``momentum`` from the kwargs, 0.9 by default, no weight decay) as the
  JAX package builds them (``upp_tpu/train/optim.py:264-290``). Each clips
  the gradients of the trainable parameters first and steps only those.
* CosLR is timm's ``CosineLRScheduler(t_initial=epochs, lr_min=1e-6,
  warmup_lr_init=1e-6, warmup_t=initial_epochs)`` stepped per epoch, here a
  per-step schedule through ``steps_per_epoch``; LambdaLR, StepLR and a
  constant ("function") as in the JAX package.
* The PEFT freeze is ``requires_grad`` by substring match of the parameter
  names (``peft_detect``). The reference builds the optimizer before the
  freeze and flips ``requires_grad`` in place at a stage switch; torch skips
  a parameter whose ``grad`` is None but keeps its lazily created state, so
  the Adam moments of parameters that stay trainable survive the switch.
  That is torch's own behaviour, and what the JAX package's
  ``masked_adamw`` imitates, provided a frozen parameter's ``grad`` is None
  at every step: ``ScheduledOptimizer.zero_grad`` always sets it to None (a
  stale zero gradient would make AdamW decay and step a frozen parameter).
* ``step_per_update`` k > 1 accumulates as the reference does
  (``runner_module.py:199-207``, the JAX package's ``accumulate_every``):
  the micro-steps' gradients are summed, never averaged, and every k-th
  call clips and steps on the sum. The schedule and the Adam counts advance
  on real steps only, so the schedule, indexed by real steps over
  ``steps_per_epoch`` micro-batches, runs k times slower, as in JAX. A
  switch of the trainable set in the middle of an accumulation: a
  parameter it freezes drops its summed gradient and does not step (JAX
  masks it); one it unfreezes sums only the calls after the switch, where
  JAX's full-tree gradients hold every call of the accumulation. That
  difference is accepted: the reference's in-place ``requires_grad`` flip
  sums as the port does, and every shipped config sets
  ``step_per_update: 1``.
* Over several ranks each real step first averages the gradients over
  the ranks (one all-reduce of the parameters that are trainable now, so a
  joint switch needs no re-wrap, as ``DistributedDataParallel``'s fixed
  buckets would), then clips: the clip sees the global gradient, as the
  JAX step's. A parameter split over ranks (``_upp_split``: a ZeRO-3 block
  from ``parallel.fsdp``, whose gradient arrives averaged, or a
  tensor-parallel block from ``parallel.tensor``, averaged over the data
  ranks) counts its squares on the ranks that hold it: the global norm
  all-reduces each group's sum of squares and counts a replicated tensor
  once.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Optional, Sequence, Tuple

import torch
from torch import nn

from ..parallel.dist import _all_reduce, average_gradients, data_group, reduce_mean
from ..utils import cuda_graphs
from ..utils.profiling import annotate


def peft_detect(name: str, targets: Iterable[str]) -> bool:
    """Substring match (``utils/misc.py:22-26``)."""
    return any(t in name for t in targets)


def set_trainable(model: nn.Module, peft_list: Optional[Sequence[str]]) -> None:
    """``requires_grad`` of every parameter: those whose name matches
    ``peft_list`` (all of them for None, a full fine-tune)."""
    for name, p in model.named_parameters():
        p.requires_grad_(peft_list is None or peft_detect(name, peft_list))


def no_weight_decay(name: str, p: torch.Tensor) -> bool:
    """The reference's no-decay rule (``builder.py:47-50``)."""
    return p.dim() == 1 or name.endswith(".bias") or "token" in name


def build_schedule(opti_cfg, sche_cfg, steps_per_epoch: int) -> Callable[[int], float]:
    """Learning rate as a function of the step count, stepped per epoch as
    the reference steps it."""
    base_lr = float(opti_cfg.kwargs.lr)
    kind = sche_cfg.type
    per = max(int(steps_per_epoch), 1)

    if kind == "CosLR":
        epochs = int(sche_cfg.kwargs.epochs)
        warmup = int(sche_cfg.kwargs.get("initial_epochs", 0))
        lr_min = warmup_init = 1e-6

        def sched(step: int) -> float:
            epoch = step // per
            if epoch < warmup:
                return warmup_init + (base_lr - warmup_init) * epoch / max(warmup, 1)
            # timm's default warmup_prefix=False: the cosine is indexed by
            # the raw epoch over t_initial, not by (epoch - warmup)
            t = min(max(epoch / max(epochs, 1), 0.0), 1.0)
            return lr_min + 0.5 * (base_lr - lr_min) * (1.0 + math.cos(math.pi * t))
        return sched

    if kind == "LambdaLR":
        decay_step = int(sche_cfg.kwargs.decay_step)
        lr_decay = float(sche_cfg.kwargs.lr_decay)
        lowest = float(sche_cfg.kwargs.lowest_decay)
        return lambda step: base_lr * max(lr_decay ** ((step // per) / decay_step), lowest)

    if kind == "StepLR":
        size = int(sche_cfg.kwargs.get("step_size", 1))
        gamma = float(sche_cfg.kwargs.get("gamma", 0.1))
        return lambda step: base_lr * gamma ** ((step // per) // size)

    if kind == "function":
        return lambda step: base_lr

    raise NotImplementedError(f"scheduler type {kind}")


class ScheduledOptimizer:
    """A torch optimizer whose learning rate is set from the schedule before
    each step, with an optional clip of the gradient norm over the
    parameters that have a gradient (the trainable ones), as
    ``clip_grad_norm_`` sees only those in the reference; with
    ``accumulate`` k > 1 only every k-th ``step`` call steps, on the summed
    gradients of the calls since the last, averaged over ranks. ``calls``
    counts every ``step`` call, as the JAX package's ``TrainState.step``
    does."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 sched: Callable[[int], float], clip: Optional[float] = None,
                 accumulate: int = 1):
        self.optimizer = optimizer
        self.sched = sched
        self.clip = clip
        self.accumulate = accumulate
        self.num_steps = 0          # real steps; drive the schedule
        self.micro_steps = 0        # calls since the last real step

    def zero_grad(self) -> None:
        """Clear the gradients, unless an accumulation is under way."""
        if self.micro_steps == 0:
            self.optimizer.zero_grad(set_to_none=True)

    @property
    def calls(self) -> int:
        return self.num_steps * self.accumulate + self.micro_steps

    def step(self) -> None:
        """One micro-step; every ``accumulate``-th call a real step over the
        parameters that are trainable now."""
        self.micro_steps += 1
        if self.micro_steps < self.accumulate:
            return
        self.micro_steps = 0
        lr = self.sched(self.num_steps)
        params = []
        for group in self.optimizer.param_groups:
            group["lr"] = lr
            for p in group["params"]:
                if not p.requires_grad:         # frozen during the accumulation
                    p.grad = None
                elif p.grad is not None:
                    params.append(p)
        # a replicated tensor over every rank: under tensor parallelism the
        # model ranks hold its gradient equal in exact arithmetic, and the
        # mean keeps their copies equal where the card's atomic adds round
        # apart; a tensor-parallel block over its data ranks; a ZeRO-3
        # block's gradient arrives averaged
        average_gradients([p for p in params if split_of(p)[0] is None])
        average_gradients([p for p in params if split_of(p)[0] == "tp"], data_group())
        if self.clip is not None:
            if any(split_of(p)[0] for p in params):
                clip_grad_norm(params, self.clip)
            else:
                torch.nn.utils.clip_grad_norm_(params, self.clip)
        self.optimizer.step()
        self.num_steps += 1

    def state_dict(self):
        """The torch optimizer's state with the real-step count; a resumed
        run starts a fresh accumulation (the summed gradients are not
        saved)."""
        return {**self.optimizer.state_dict(), "num_steps": self.num_steps}

    def load_state_dict(self, state, num_steps: int = 0) -> None:
        """``num_steps``: the real-step count of a state saved without one
        (written before the count was saved, when k was always 1)."""
        state = dict(state)
        self.num_steps = int(state.pop("num_steps", num_steps))
        self.micro_steps = 0
        self.optimizer.load_state_dict(state)


def split_of(p: torch.Tensor):
    """(kind, group) of a parameter split over ranks: ("fsdp", data group)
    or ("tp", model group); (None, None) for a replicated one."""
    return getattr(p, "_upp_split", (None, None))


def clip_grad_norm(params: Sequence[torch.Tensor], max_norm: float) -> torch.Tensor:
    """``clip_grad_norm_`` on the global gradient of parameters of which
    some are split over ranks: each group's sum of squared norms is
    all-reduced over it, a replicated tensor counts once; the same
    coefficient, ``max_norm / (norm + 1e-6)`` at most 1, scales every
    gradient. Returns the global norm."""
    sums, groups = {}, {}
    for p in params:
        kind, group = split_of(p)
        key = id(group) if kind else None
        groups[key] = group
        sums.setdefault(key, []).append(torch.linalg.vector_norm(p.grad, 2.0) ** 2)
    total = torch.stack(sums.pop(None)).sum() if None in sums else None
    for key, sq in sums.items():
        part = _all_reduce(torch.stack(sq).sum(), "gradients", groups[key])
        total = part if total is None else total + part
    norm = total.sqrt()
    coef = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    for p in params:
        p.grad.mul_(coef)
    return norm


def step_generator(gens: dict, device: torch.device, seed: int,
                   calls: int) -> torch.Generator:
    """The generator of a train step's draws: ``gens``' one for ``device``
    (made at the first call), seeded from ``seed`` and the optimizer's count
    of calls, as the JAX package folds ``state.step`` into its key. A host
    seed; nothing waits on the device."""
    gen = gens.get(device)
    if gen is None:
        gen = gens[device] = torch.Generator(device)
    return gen.manual_seed((seed << 32) + calls)


def graphed_train_step(model: nn.Module, optimizer: ScheduledOptimizer,
                       forward_backward: Callable, seed: int) -> Callable:
    """``train_step(*batch, draws=None) -> {"loss", "acc"}``, the frame of
    the cls and seg train steps around ``forward_backward(*batch, generator,
    draws)`` (a step's forward passes, loss and ``backward()``, returning
    [loss, accuracy]), in the span ``train_step``: the step's generator
    (``step_generator`` from ``seed``), the model in train mode, the
    gradients cleared, ``forward_backward`` through a
    ``cuda_graphs.GraphedStep``, ``optimizer.step()`` in the span
    ``optimizer``, and the metrics averaged over the data ranks. ``batch``
    is the leading tensor arguments; a trailing one that is not a tensor is
    ``draws``."""
    graphed = cuda_graphs.GraphedStep(model, forward_backward)
    gens = {}                       # the device generator, made at the first step

    def train_step(*batch, draws=None):
        if batch and not isinstance(batch[-1], torch.Tensor):
            *batch, draws = batch
        with annotate("train_step"):
            gen = step_generator(gens, batch[0].device, seed, optimizer.calls)
            model.train()
            # the gradients must be cleared before the backward and read
            # after the step, so the clearing sits outside both spans
            optimizer.zero_grad()
            metrics = graphed(*batch, generator=gen, accumulate=optimizer.accumulate,
                              draws=draws)
            with annotate("optimizer"):
                optimizer.step()
            loss, acc = reduce_mean(metrics, data_group())
            return {"loss": loss, "acc": acc}

    return train_step


def build_optimizer(config, model: nn.Module, steps_per_epoch: int) -> ScheduledOptimizer:
    """The config's optimizer (``AdamW`` over every parameter of ``model``
    in the reference's two decay groups, ``Adam`` or Nesterov ``SGD``) on
    its schedule, ``grad_norm_clip`` and ``step_per_update``. Which
    parameters train is ``requires_grad`` (``set_trainable``), which may
    change later without rebuilding the optimizer."""
    opti_cfg = config.optimizer
    lr = float(opti_cfg.kwargs.lr)
    if opti_cfg.type == "AdamW":
        wd = float(opti_cfg.kwargs.get("weight_decay", 0.0))
        decay, no_decay = [], []
        for name, p in model.named_parameters():
            (no_decay if no_weight_decay(name, p) else decay).append(p)
        opt = torch.optim.AdamW([{"params": no_decay, "weight_decay": 0.0},
                                 {"params": decay, "weight_decay": wd}],
                                lr=lr, weight_decay=wd)
    elif opti_cfg.type == "Adam":
        opt = torch.optim.Adam(model.parameters(), lr=lr)
    elif opti_cfg.type == "SGD":
        opt = torch.optim.SGD(model.parameters(), lr=lr, nesterov=True,
                              momentum=float(opti_cfg.kwargs.get("momentum", 0.9)))
    else:
        raise NotImplementedError(f"optimizer type {opti_cfg.type!r}: AdamW, Adam or SGD")
    clip = config.get("grad_norm_clip")
    return ScheduledOptimizer(opt, build_schedule(opti_cfg, config.scheduler,
                                                  steps_per_epoch),
                              None if clip is None else float(clip),
                              accumulate=max(int(config.get("step_per_update", 1) or 1), 1))


def count_params(model: nn.Module) -> Tuple[int, int]:
    """(trainable, total) parameter counts (``utils/misc.py:322-346``)."""
    total = sum(p.numel() for p in model.parameters())
    trainable = sum(p.numel() for p in model.parameters() if p.requires_grad)
    return trainable, total
