"""The reference against the program on the CPU, at 2 clouds and the
configurations' full widths, from the same seeded weights and clouds: the
program's kernels take their plain CPU versions there, so the two agree to
float32 rounding. The draws are the reference's own re-derivation of the
training recipe's (``harness.inputs``)."""

import pytest
import torch

from conftest import benchmark
from harness import bench, cells

B = 2


def run_cell(workload, overrides=None):
    """(cell with its program readings, reference readings) or, for an
    evaluation cell, the check's numbers over its first batches."""
    entry, config, traffic = bench.find(workload, benchmark())
    traffic = {**traffic, "batch": B, "pool": 4, "check_steps": 2, "warmup_steps": 0,
               "warmup_batches": 1, "check_batches": 2, **(overrides or {})}
    ctx = bench.Context(2**31 + 99, (2**31 + 99) % (1 << 31), 0.0, False, torch.device("cpu"),
                        config, traffic, entry)
    return bench.set_up(ctx)


@pytest.mark.parametrize("workload", ["cls_peft_train"])
def test_train_steps_agree(workload):
    cell = run_cell(workload)
    cell.release()
    ref = cell.reference_readings()
    got = cell.compare(cell.readings, ref)
    assert got["loss_gap"] < 1e-4 and got["grad_gap"] < 1e-4 and got["change_gap"] < 1e-2, got
    # the first step starts from the same weights and draws: equal losses
    assert cell.readings["losses"][0] == pytest.approx(ref["losses"][0], rel=1e-6)
    # every trainable leaf the reference moves has a gradient and a change
    assert set(ref["grad"]) <= set(cell.readings["grad"]), set(ref["grad"]) - set(
        cell.readings["grad"])


@pytest.mark.parametrize("workload", ["cls_robust_eval", "pretask_eval"])
def test_eval_outputs_agree(workload):
    cell = run_cell(workload)
    w = cell.window(0.0)            # one batch through the program
    assert w.units == 1
    cell.release()
    got = cell.check()
    bound = {"label_gap": 1e-5, "logit_gap": 1e-5, "cd_gap": 1e-5, "fscore_gap": 1e-6}
    assert all(v <= bound[k] for k, v in got.items()), got


def test_control_precision_switch_is_scoped():
    before = torch.backends.cuda.matmul.allow_tf32
    with cells.precision(True):
        assert torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32 == before
