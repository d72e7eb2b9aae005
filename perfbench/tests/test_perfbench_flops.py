"""Each driver's FLOP count of a unit (``Cell.flops``, counted from shapes
by ``reference/flops.py``) against ``torch.utils.flop_counter.FlopCounterMode``
over the reference's unit at a small batch (forward, and the backward
autograd runs for the trainable set)."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import benchmark, workloads
from harness import bench, cells

B = 2


def counted(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.mark.parametrize("workload", workloads())
def test_step_flops_equal_the_counter(workload):
    entry, config, traffic = bench.find(workload, benchmark())
    traffic = {**traffic, "batch": B, "pool": 1}
    ctx = bench.Context(5, 5, 0.0, False, torch.device("cpu"), config, traffic, entry)
    cell = bench.set_up(ctx, program=False)
    P = cell.weights()
    if isinstance(cell, cells.TrainCell):
        for n in cell.names:
            P[n].requires_grad_(True)

        def unit():
            loss, _ = cell.reference_step(P, 0)
            torch.autograd.grad(loss, [P[n] for n in cell.names], allow_unused=True)
    else:
        def unit():
            with torch.no_grad():
                cell.reference(0, P)
    assert cell.flops() == counted(unit)
