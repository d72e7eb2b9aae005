"""A whole run of each cell on the CPU (the harness's look for a card
skipped), at 2 clouds a unit, comes out correct, and comes out not correct
with the timed path broken underneath in each way the cell can break: a
train step that leaves its state unchanged, a loss over half of the batch,
an answer altered where it is produced. One card, so no exchange between
cards can be left out."""

import contextlib
import time

import pytest
import torch

from conftest import benchmark
from harness import bench

TINY = {"batch": 2, "pool": 4, "warmup_steps": 1, "warmup_batches": 1, "profile_units": 1,
        "check_batches": 2}


def run(workload):
    line, checked = bench.run(workload, 2**31 + 4242, 0.5, False, time.time(),
                              device=torch.device("cpu"), overrides=TINY,
                              bench=benchmark())
    return line, {k: v for k, v, _ in checked}


@contextlib.contextmanager
def patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def unchanged_state():
    from upp_torch.train import optim

    def step(self):
        self.num_steps += 1            # counts, updates nothing
    return patched(optim.ScheduledOptimizer, "step", step)


def half_batch_cls():
    from upp_torch.train import runner_cls
    f = runner_cls.cross_entropy_loss_acc
    return patched(runner_cls, "cross_entropy_loss_acc",
                   lambda logits, labels: f(logits[:len(logits) // 2], labels[:len(labels) // 2]))


def altered_logits():
    from upp_torch.models import unify
    f = unify.PointMAEUnify.forward

    def forward(self, *a, **k):
        out = f(self, *a, **k)
        return torch.cat([out[:1].roll(1, dims=-1), out[1:]])
    return patched(unify.PointMAEUnify, "forward", forward)


def altered_label():
    """The label the step returns altered, the logits behind it left."""
    from upp_torch.train import runner_cls
    f = runner_cls.make_eval_step

    def make_eval_step(*a, **k):
        step = f(*a, **k)

        def altered(pts):
            labels = step(pts)
            return torch.cat([(labels[:1] + 1) % 40, labels[1:]])
        return altered
    return patched(runner_cls, "make_eval_step", make_eval_step)


def altered_distance():
    from upp_torch.train import runner_pretask
    f = runner_pretask.chamfer_l1_per_sample

    def per_sample(x, y, *a, **k):
        d = f(x, y, *a, **k)
        return torch.cat([d[:1] * 1.01, d[1:]])
    return patched(runner_pretask, "chamfer_l1_per_sample", per_sample)


CASES = {
    "cls_peft_train": {"unchanged state": unchanged_state, "half batch": half_batch_cls},
    "cls_robust_eval": {"altered answer": altered_logits, "altered label": altered_label},
    "pretask_eval": {"altered answer": altered_distance},
}


@pytest.mark.parametrize("workload", sorted(CASES))
def test_sound_run_is_correct(workload):
    line, numbers = run(workload)
    assert line["correct"], line["checked"]


@pytest.mark.parametrize("workload,fault", [(w, f) for w in sorted(CASES) for f in CASES[w]])
def test_broken_path_is_not_correct(workload, fault):
    with CASES[workload][fault]():
        line, numbers = run(workload)
    assert not line["correct"], (fault, line["checked"])
