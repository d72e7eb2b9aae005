"""Each cell's kernel-call table (the data its ``kernel_roofline`` bound
comes from) equals the selections the reference makes in one unit of the
cell's traffic (one step or batch, here at 2 clouds: the table counts calls
a unit, whatever the batch)."""

import json
import os
from collections import Counter

import pytest
import torch

from conftest import PERFBENCH, benchmark, workloads
from harness import bench, inputs
from reference import ops


def reference_calls(workload):
    entry, config, traffic = bench.find(workload, benchmark())
    traffic = {**traffic, "batch": 2, "pool": 3, "check_steps": 1, "check_batches": 1}
    ctx = bench.Context(7, 7, 0.0, False, torch.device("cpu"), config, traffic, entry)
    cell = bench.set_up(ctx, program=False)
    with ops.record_calls() as calls:
        if hasattr(cell, "reference_step"):
            cell.reference_step(cell.weights(), 0)
        else:
            cell.reference(0, cell.weights())
    return calls, traffic


@pytest.mark.parametrize("workload", workloads())
def test_call_table_is_the_reference_calls(workload):
    calls, traffic = reference_calls(workload)
    table = Counter({tuple(c): n for c, n in traffic["calls"]})
    assert calls == table


def test_every_cell_has_a_table_and_a_driver():
    for w in benchmark()["workloads"]:
        t = json.load(open(os.path.join(PERFBENCH, "traffic", w["traffic"] + ".json")))
        assert t["calls"] and os.path.exists(os.path.join(PERFBENCH, "drivers",
                                                          t["driver"] + ".py"))
        assert inputs.PROGRAM_SEED_MOD == 1 << 31
