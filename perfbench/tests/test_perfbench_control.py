"""The check's control on the card: the reference computed with TF32
products (the precision below the configurations' float32) in the
program's place fails the cell's check. Training cells at 8 clouds a step,
evaluation cells at their own batch over 2 batches; the limits were set
from ``perfbench/control.py`` at the cells' own sizes (``PERF.md``)."""

import json
import os

import pytest

from conftest import PERFBENCH, benchmark, need_card, workloads

SMALLER = {"cls_peft_train": {"batch": 8}}


@pytest.mark.card
@pytest.mark.parametrize("workload", workloads())
def test_tf32_control_fails_the_check(workload):
    need_card()
    import torch
    import control
    limits = json.load(open(os.path.join(PERFBENCH, "traffic", workload + ".json")))["limits"]
    for seed in (11, 12, 13):
        got = control.readings(workload, seed, torch.device("cuda", 0),
                               overrides={"check_batches": 2, **SMALLER.get(workload, {})},
                               b=benchmark())["control"]
        assert any(v > limits[k] for k, v in got.items() if k in limits), (seed, got, limits)
