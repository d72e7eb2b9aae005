"""A traced CPU run of ``cls_peft_train`` at 2 clouds a step reads every
host metric of the program's spans and counters (the windows and the
launches in the device trace need a card: they stay out), and a program
without the recorder leaves them all out without raising."""

import time

import torch

from conftest import benchmark
from harness import bench

TINY = {"batch": 2, "pool": 4, "warmup_steps": 1, "check_steps": 1, "profile_units": 1,
        "gap_units": 1}
HOST = ["step_host_ms.train", "backward_host_ms.train", "optimizer_host_ms.train",
        "host_syncs.train"]
CARD = ["rectify_window_ms.train", "completion_window_ms.train", "downstream_window_ms.train",
        "point_launches.train"]


def traced_run():
    line, _ = bench.run("cls_peft_train", 2**31 + 77, 0.5, True, time.time(),
                        device=torch.device("cpu"), overrides=TINY, bench=benchmark())
    return line["metrics"]


def test_traced_run_reads_the_span_metrics():
    from upp_torch.utils import profiling
    profiling.reset()
    metrics = traced_run()
    profiling.reset()
    for name in HOST:
        assert name in metrics, (name, sorted(metrics))
        assert metrics[name]["value"] >= 0
    assert metrics["step_host_ms.train"]["value"] >= (
        metrics["backward_host_ms.train"]["value"] + metrics["optimizer_host_ms.train"]["value"])
    assert metrics["host_syncs.train"]["value"] == 0            # no CUDA to sync with
    assert not set(CARD) & set(metrics)


def test_a_program_without_the_recorder_leaves_them_out(monkeypatch):
    from upp_torch.utils import profiling
    monkeypatch.delattr(profiling, "units")
    metrics = traced_run()
    assert not (set(HOST) | set(CARD)) & set(metrics)
    assert "step_mfu.train" in metrics
