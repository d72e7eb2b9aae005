"""Optimizer, schedule and PEFT trainable set (counterpart of
``upp_tpu/train/optim.py``; reference ``tools/builder.py:37-89``).

* AdamW over ALL parameters, with a no-decay group for 1-D parameters,
  biases and anything with "token" in its name (``builder.py:40-55``).
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
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Optional, Sequence, Tuple

import torch
from torch import nn


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
    ``clip_grad_norm_`` sees only those in the reference."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 sched: Callable[[int], float], clip: Optional[float] = None):
        self.optimizer = optimizer
        self.sched = sched
        self.clip = clip
        self.num_steps = 0          # drives the schedule

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def step(self) -> None:
        lr = self.sched(self.num_steps)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        if self.clip is not None:
            params = [p for g in self.optimizer.param_groups for p in g["params"]
                      if p.grad is not None]
            torch.nn.utils.clip_grad_norm_(params, self.clip)
        self.optimizer.step()
        self.num_steps += 1

    def state_dict(self):
        return self.optimizer.state_dict()

    def load_state_dict(self, state) -> None:
        self.optimizer.load_state_dict(state)


def build_optimizer(config, model: nn.Module, steps_per_epoch: int) -> ScheduledOptimizer:
    """AdamW over every parameter of ``model`` in the reference's two decay
    groups, on the config's schedule and ``grad_norm_clip``. Which
    parameters train is ``requires_grad`` (``set_trainable``), which may
    change later without rebuilding the optimizer."""
    opti_cfg = config.optimizer
    if opti_cfg.type != "AdamW":
        raise NotImplementedError(f"optimizer type {opti_cfg.type!r}: only AdamW "
                                  "is ported so far")
    if int(config.get("step_per_update", 1) or 1) != 1:
        raise NotImplementedError("step_per_update > 1 (gradient accumulation) "
                                  "is not ported yet")
    wd = float(opti_cfg.kwargs.get("weight_decay", 0.0))
    decay, no_decay = [], []
    for name, p in model.named_parameters():
        (no_decay if no_weight_decay(name, p) else decay).append(p)
    opt = torch.optim.AdamW([{"params": no_decay, "weight_decay": 0.0},
                             {"params": decay, "weight_decay": wd}],
                            lr=float(opti_cfg.kwargs.lr), weight_decay=wd)
    clip = config.get("grad_norm_clip")
    return ScheduledOptimizer(opt, build_schedule(opti_cfg, config.scheduler,
                                                  steps_per_epoch),
                              None if clip is None else float(clip))


def count_params(model: nn.Module) -> Tuple[int, int]:
    """(trainable, total) parameter counts (``utils/misc.py:322-346``)."""
    total = sum(p.numel() for p in model.parameters())
    trainable = sum(p.numel() for p in model.parameters() if p.requires_grad)
    return trainable, total
