"""The port's recorder (``upp_torch/utils/profiling.py``): spans, counters
and units on the CPU, and on a card (the ``card`` tests, which skip without
one; this file imports no JAX, so on the card's machine it runs alone:
``python -m pytest --noconftest -m card tests/test_torch_port_tracing.py``).

Off, a span records nothing and opens no profiler range; on (inside
``tracing()`` or while ``torch.profiler`` records), spans nest into units,
agree with the profiler's ranges of the same names, and the runners' steps
yield the spans their metrics read, in order, with outputs bit-equal to a
step run with the recorder off."""

import contextlib
import copy
import threading
import types
import warnings

import numpy as np
import pytest
import torch

from upp_torch.models import build_model_from_cfg
from upp_torch.train import optim, runner_cls, runner_pretask
from upp_torch.utils import profiling
from upp_torch.utils.config import ConfigDict

BLOCKS = {"mask_ratio": 0.5, "mask_type": "rand", "trans_dim": 48, "encoder_dims": 48,
          "depth": 3, "drop_path_rate": 0.1, "num_heads": 4, "decoder_depth": 2,
          "decoder_num_heads": 4}
PROMPTS = {"rectify_adapter": True, "rectify_prompts": True, "rectify_prompts_num": 2,
           "rectify_prompts_depth": 2, "rectify_depth": 2,
           "pretask_adapter": True, "pretask_prompts": True, "pretask_prompts_num": 2,
           "pretask_prompts_depth": 3, "pretask_depth": 3}
CLS_MODEL = {"NAME": "Point_MAE_unify", "transformer_config": BLOCKS, "cls_dim": 5,
             "group_size": 16, "num_group": 32, "gather_idx": False,
             "prompt_propagation_after": True,
             "prompter_config": {**PROMPTS, "downstream_adapter": True,
                                 "downstream_prompts": True, "downstream_prompts_num": 3,
                                 "downstream_prompts_depth": 2, "downstream_depth": 3}}
PRETASK_MODEL = {"NAME": "Point_MAE_pretask_dev", "transformer_config": BLOCKS,
                 "group_size": 8, "num_group": 32, "gather_idx": True,
                 "prompt_propagation_after": True, "prompter_config": PROMPTS}
N_DATASET = 512
CONFIG = {
    "optimizer": {"type": "AdamW", "kwargs": {"lr": 5e-4, "weight_decay": 0.05}},
    "scheduler": {"type": "CosLR", "kwargs": {"epochs": 4, "initial_epochs": 1}},
    "dataset": {split: {"_base_": {"NAME": "Synthetic", "N_POINTS": N_DATASET,
                                   "NUM_CATEGORY": 5, "SIZE": 4},
                        "others": {"subset": "train"}} for split in ("train", "val", "test")},
    "npoints": 128, "noisy_train": True, "noisy_validate": True,
    "data_augmentation": "scale-translate", "grad_norm_clip": 10,
}
ARGS = types.SimpleNamespace(noise=True, noise_type=["gaussian_noise", "lidar_noise"],
                             incomplete_cropping=True, normalize=False, seed=0)
TRAIN_SPANS = ["rectify", "completion", "downstream", "backward", "optimizer"]


@pytest.fixture(autouse=True)
def fresh_recorder():
    profiling.reset()
    yield
    profiling.reset()


def model_of(cfg, seed=0, device="cpu"):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build_model_from_cfg(copy.deepcopy(cfg)).to(device)


def clouds(b, n, seed=0, device="cpu"):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((b, n, 3)).astype(np.float32)).to(device)


def train_step(device="cpu"):
    config = ConfigDict.from_nested(CONFIG)
    model = model_of(CLS_MODEL, device=device)
    optim.set_trainable(model, runner_cls.PEFT_LIST)
    opt = optim.build_optimizer(config, model, steps_per_epoch=1)
    return model, runner_cls.make_train_step(model, opt, config, ARGS)


def names(unit):
    return [s["name"] for s in unit["spans"]]


def test_a_span_records_nothing_when_off(monkeypatch):
    made = []

    class Watched(torch.profiler.record_function):
        def __init__(self, *a, **k):
            made.append(a)
            super().__init__(*a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", Watched)
    assert profiling.annotate("a") is profiling.annotate("b")      # the shared no-op
    with profiling.annotate("outer"):
        with profiling.annotate("inner"):
            torch.ones(4) + 1
    assert profiling.units() == [] and made == []
    with profiling.tracing():
        with profiling.annotate("outer"):
            pass
    assert made == []                       # on, but no profiler records: no range
    assert [u["name"] for u in profiling.units()] == ["outer"]


def test_nested_spans_carry_their_parent_and_unit():
    with profiling.tracing():
        for root in ("first", "second"):
            with profiling.annotate(root):
                with profiling.annotate("a"):
                    with profiling.annotate("b"):
                        pass
                with profiling.annotate("c"):
                    pass
        with profiling.annotate("lone"):
            pass
    units = profiling.units()
    assert [u["name"] for u in units] == ["first", "second", "lone"]
    for u in units[:2]:
        assert [(s["name"], s["parent"], s["unit"]) for s in u["spans"]] == [
            ("a", u["name"], u["name"]), ("b", "a", u["name"]), ("c", u["name"], u["name"])]
        a, b, c = u["spans"]
        assert u["start_ns"] <= a["start_ns"] <= b["start_ns"] <= b["end_ns"] <= a["end_ns"]
        assert a["end_ns"] <= c["start_ns"] <= c["end_ns"] <= u["end_ns"]
        assert u["window_ms"] is None and a["window_ms"] is None     # no CUDA here
    assert units[2]["spans"] == [] and units[2]["parent"] is None


def test_spans_agree_with_the_profiler_ranges():
    """Under a CPU ``torch.profiler`` alone, spans record, and their ends
    lie within 50 µs of the profiler's ranges of the same names on its clock
    (its trace start plus an event's time range), the first unit left out."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(6):
            with profiling.annotate("unit"):
                with profiling.annotate("work"):
                    torch.ones(32, 32) @ torch.ones(32, 32)
    units = profiling.units()
    assert len(units) == 6 and all(names(u) == ["work"] for u in units)
    t0 = prof.profiler.kineto_results.trace_start_ns()
    ranges = {name: sorted((t0 + round(e.time_range.start * 1e3),
                            t0 + round(e.time_range.end * 1e3))
                           for e in prof.events() if e.name == name)
              for name in ("unit", "work")}
    assert len(ranges["unit"]) == len(ranges["work"]) == 6
    for i, u in enumerate(units[1:], 1):
        for row in (u, u["spans"][0]):
            start, end = ranges[row["name"]][i]
            assert abs(start - row["start_ns"]) < 50_000, (row, start)
            assert abs(end - row["end_ns"]) < 50_000, (row, end)


def test_counter_changes_are_stored_per_unit():
    profiling.count("x", 5)                     # before any unit: in no unit
    with profiling.tracing():
        with profiling.annotate("u1"):
            profiling.count("x")
            with profiling.annotate("child"):
                profiling.count("y", 3)
        with profiling.annotate("u2"):
            profiling.count("x", 2)
        with profiling.annotate("u3"):
            pass
    assert [u["counts"] for u in profiling.units()] == [{"x": 1, "y": 3}, {"x": 2}, {}]
    assert profiling.counts() == {"x": 8, "y": 3}


def test_the_sync_watch_counts_its_own_thread_alone(monkeypatch):
    """A root's sync watch counts each sync report on its own thread, drops
    one from another thread (the mode is on only for the root) and passes
    every other warning on as it came; closed, it leaves no trace."""
    modes = []
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    sync = profiling.SYNC_WARNING + " (Triggered internally)"

    def elsewhere():
        warnings.warn(sync)
        warnings.warn("another thread's")

    with warnings.catch_warnings(record=True) as shown:
        warnings.simplefilter("default")
        before = (list(warnings.filters), warnings.showwarning)
        watch = profiling._SyncWatch()
        for _ in range(2):
            warnings.warn(sync)                 # one place twice: counted twice
        t = threading.Thread(target=elsewhere)
        t.start()
        t.join()
        warnings.warn("the step's own")
        syncs = watch.close()
        after = (list(warnings.filters), warnings.showwarning)
        warnings.warn(sync)                     # closed: shown as any warning
    assert syncs == 2 and modes == ["warn", 0] and after == before
    assert [str(w.message) for w in shown] == ["another thread's", "the step's own", sync]


def test_cls_train_step_yields_its_spans():
    _, step = train_step()
    pts, label = clouds(2, N_DATASET), torch.tensor([1, 3])
    with profiling.tracing():
        step(pts, label)
        step(pts, label)
    units = profiling.units()
    assert [u["name"] for u in units] == ["train_step", "train_step"]
    for u in units:
        assert names(u) == TRAIN_SPANS
        assert all(s["parent"] == "train_step" for s in u["spans"])
        assert sum(s["host_ms"] for s in u["spans"]) <= u["host_ms"]
        # the CPU runs no kernel wrapper; the three passes run eager (grad
        # on), and so does the step's graph (a CPU tensor)
        assert u["counts"] == {"cuda_graph.eager": 4}


@pytest.mark.parametrize("kind", ["eval", "pretask_eval"])
def test_eval_steps_yield_their_spans(kind):
    config = ConfigDict.from_nested(CONFIG)
    if kind == "eval":
        step = runner_cls.make_eval_step(model_of(CLS_MODEL), config, ARGS)
        args, root, want = (clouds(2, 256),), "eval_step", ["rectify", "completion",
                                                           "downstream"]
    else:
        step = runner_pretask.make_pretask_eval_step(model_of(PRETASK_MODEL), config, "easy")
        args = (clouds(2, N_DATASET), torch.tensor([1.0, 1.0, 1.0]))
        root, want = "pretask_eval_step", ["completion", "chamfer"]
    with profiling.tracing():
        step(*args)
    (unit,) = profiling.units()
    assert unit["name"] == root and names(unit) == want
    assert all(s["parent"] == root for s in unit["spans"])
    assert sum(s["host_ms"] for s in unit["spans"]) <= unit["host_ms"]


def test_outputs_are_bit_equal_with_the_recorder_on_and_off():
    pts, label = clouds(2, N_DATASET, seed=1), torch.tensor([0, 4])
    runs = []
    for on in (False, True):
        model, step = train_step()
        with profiling.tracing() if on else contextlib.nullcontext():
            outs = [step(pts, label) for _ in range(2)]
            model.eval()
            logits = model(pts[:, :128], completion_prompt=True, denoise=True, point_num=128)
        runs.append(([float(o["loss"]) for o in outs], logits,
                     [p.detach().clone() for p in model.parameters()]))
    # two steps, then each pass of the lone forward a unit of its own
    assert [u["name"] for u in profiling.units()] == ["train_step", "train_step", "rectify",
                                                      "completion", "downstream"]
    (l0, z0, p0), (l1, z1, p1) = runs
    assert l0 == l1 and torch.equal(z0, z1)
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))


# -- on a card ---------------------------------------------------------------

def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.card
def test_a_host_sync_in_a_root_span_counts_once():
    need_card()
    x = torch.ones(64, device="cuda")
    with profiling.tracing():
        with profiling.annotate("synced"):
            (x * 2).sum().item()
        with profiling.annotate("syncless"):
            x * 2
    assert [u["counts"].get("host_syncs", 0) for u in profiling.units()] == [1, 0]
    assert torch.cuda.get_sync_debug_mode() == 0


@pytest.mark.card
def test_spans_record_under_a_device_only_profiler():
    need_card()
    x = torch.ones(256, 256, device="cuda")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
        with profiling.annotate("unit"):
            with profiling.annotate("mm"):
                x @ x
    (unit,) = profiling.units()
    assert unit["name"] == "unit" and names(unit) == ["mm"]
    assert unit["window_ms"] > 0 and unit["spans"][0]["window_ms"] > 0


@pytest.mark.card
def test_device_windows_lie_on_the_host_clock():
    """Device windows are positive, follow each other in order, start no
    earlier than their span's host start, and the cls train step's spans
    and launches read as on the CPU."""
    need_card()
    x = torch.randn(1024, 1024, device="cuda")
    with profiling.tracing():
        for _ in range(3):
            with profiling.annotate("unit"):
                for name in ("a", "b", "c"):
                    with profiling.annotate(name):
                        for _ in range(20):
                            x = torch.tanh(x @ x)
    for u in profiling.units():
        rows = u["spans"]
        for r in [u] + rows:
            assert r["window_ms"] > 0
            assert r["window_start_ns"] >= r["start_ns"], r
        for p, q in zip(rows, rows[1:]):
            assert p["window_end_ns"] <= q["window_start_ns"] + 10_000
    profiling.reset()
    _, step = train_step("cuda")
    pts, label = clouds(2, N_DATASET, device="cuda"), torch.tensor([1, 3], device="cuda")
    with profiling.tracing():
        step(pts, label)
    (u,) = profiling.units()
    assert names(u) == TRAIN_SPANS and u["counts"]["launches.fps"] > 0
    assert all(s["window_ms"] > 0 for s in u["spans"])
