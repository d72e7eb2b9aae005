"""The segmentation cell ``seg_peft_train`` (``Point_MAE_unify_seg``,
``runner_seg.make_seg_train_step``). On the CPU at 2 clouds and the
configuration's full widths: the program's steps against the reference
(loss, first gradient, change over the steps), the FLOP count against
``FlopCounterMode``, the seeded part labels and the trainable set, and
faults planted in the seg reference and in the program's seg loss read as
not correct."""

import contextlib
import json
import os
import time

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import PERFBENCH, benchmark
from drivers import seg_train
from test_perfbench_faults import patched
from harness import bench, inputs
from reference import seg

TINY = {"batch": 2, "pool": 4, "warmup_steps": 1, "profile_units": 1}


def traffic(workload):
    return json.load(open(os.path.join(PERFBENCH, "traffic", workload + ".json")))


def cell_of(workload, program=True, **overrides):
    entry, config, t = bench.find(workload, benchmark())
    t = {**t, "batch": 2, "pool": 4, "check_steps": 2, "warmup_steps": 0, **overrides}
    seed = 2**31 + 99
    ctx = bench.Context(seed, seed % inputs.PROGRAM_SEED_MOD, 0.0, False, torch.device("cpu"),
                        config, t, entry)
    return bench.set_up(ctx, program=program)


def test_program_steps_agree_with_the_reference():
    cell = cell_of("seg_peft_train")
    cell.release()
    ref = cell.reference_readings()
    got = cell.compare(cell.readings, ref)
    # within the cell's own limits (the seg step's label embedding normalises
    # over the 2 clouds alone, which lifts its grad_gap to about 1e-3 here)
    limits = traffic("seg_peft_train")["limits"]
    assert all(v <= limits[k] for k, v in got.items()), (got, limits)
    assert cell.readings["losses"][0] == pytest.approx(ref["losses"][0], rel=1e-6)
    assert set(ref["grad"]) <= set(cell.readings["grad"]), set(ref["grad"]) - set(
        cell.readings["grad"])


def test_flop_count_equals_the_counter_at_three_clouds():
    cell = cell_of("seg_peft_train", program=False, batch=3)
    P = cell.weights()
    for n in cell.names:
        P[n].requires_grad_(True)
    with FlopCounterMode(display=False) as fc:
        loss, _ = cell.reference_step(P, 0)
        torch.autograd.grad(loss, [P[n] for n in cell.names], allow_unused=True)
    assert cell.flops() == fc.get_total_flops()


def test_part_labels_follow_the_height_rule():
    from upp_torch.data.partnormal import SEG_CLASSES
    per_category = traffic("seg_peft_train")["parts_per_category"]
    assert per_category == [len(SEG_CLASSES[c]) for c in sorted(SEG_CLASSES)]
    ranges = [SEG_CLASSES[c] for c in sorted(SEG_CLASSES)]
    clouds, cats = inputs.make_clouds(2, 8, 64, 16, 5)
    parts = seg_train.part_labels(clouds, cats, per_category)
    for c, p, z in zip(cats.reshape(-1), parts.reshape(-1, 64), clouds[..., 2].reshape(-1, 64)):
        assert set(p) == set(ranges[c])                      # every part of the category
        assert (np.diff(p[np.argsort(z, kind="stable")]) >= 0).all()   # bands rise with z


def test_trainable_set_is_the_runners():
    from upp_torch.train import runner_seg
    _, config, _ = bench.find("seg_peft_train", benchmark())
    assert config["trainable"] == runner_seg.SEG_PEFT_LIST


def half_points(nll):
    return lambda log_probs, parts: nll(log_probs[:, ::2], parts[:, ::2])


REFERENCE_FAULTS = {
    "label embedding left out": lambda: patched(
        seg.SegNet, "label_embedding", lambda self, one_hot: torch.zeros(
            one_hot.shape[0], seg.LABEL_DIM, dtype=one_hot.dtype)),
    "half the query points": lambda: patched(seg, "nll", half_points(seg.nll)),
}


@pytest.mark.parametrize("fault", sorted(REFERENCE_FAULTS))
def test_a_fault_in_the_seg_reference_exceeds_a_limit(fault):
    cell = cell_of("seg_peft_train", program=False, check_steps=1)
    sound = cell.reference_readings()
    with REFERENCE_FAULTS[fault]():
        broken = cell.reference_readings()
    got = cell.compare(broken, sound)
    limits = traffic("seg_peft_train")["limits"]
    assert any(v > limits[k] for k, v in got.items()), (fault, got, limits)


def test_a_seg_run_is_correct_and_not_with_the_loss_over_half_the_points():
    from upp_torch.train import runner_seg
    lines = []
    for fault in (contextlib.nullcontext(),
                  patched(runner_seg, "nll_seg_loss", half_points(runner_seg.nll_seg_loss))):
        with fault:
            line, _ = bench.run("seg_peft_train", 2**31 + 4242, 0.5, False, time.time(),
                                device=torch.device("cpu"), overrides=TINY, bench=benchmark())
        lines.append(line)
    assert lines[0]["correct"], lines[0]["checked"]
    assert not lines[1]["correct"], lines[1]["checked"]

