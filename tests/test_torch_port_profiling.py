"""The port's profiling tools (``upp_torch/utils/profiling.py``) on the CPU:
``cost_analysis`` against the JAX package's (XLA's FLOPs and bytes of a
lone matmul), ``annotate`` spans nesting in a ``torch.profiler`` trace
and in the recorder (``test_torch_port_tracing.py`` tests the recorder),
``maybe_trace`` writing one, and ``profile_train_step`` giving the rows of
the JAX package's table on a tiny config (the JAX side with its jitted
step replaced by one that does nothing: only its row names are compared;
the times are measured on the card)."""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from test_torch_port_model import SMALL
from upp_tpu.utils import profiling as j_profiling
from upp_torch.utils import profiling


def test_cost_analysis_of_a_matmul_matches_jax():
    a = np.random.default_rng(0).standard_normal((64, 32)).astype(np.float32)
    b = np.random.default_rng(1).standard_normal((32, 16)).astype(np.float32)
    want = j_profiling.cost_analysis(lambda x, y: x @ y, jnp.asarray(a), jnp.asarray(b))
    got = profiling.cost_analysis(lambda x, y: x @ y, torch.from_numpy(a), torch.from_numpy(b))
    assert got["flops"] == want["flops"] == 2 * 64 * 32 * 16
    assert got["bytes_accessed"] == want["bytes_accessed"] == 4 * (64 * 32 + 32 * 16 + 64 * 16)
    assert got["arithmetic_intensity"] == pytest.approx(want["arithmetic_intensity"])


def test_cost_analysis_counts_no_bytes_for_views():
    x = torch.ones(8, 4)
    got = profiling.cost_analysis(lambda t: t.t() @ t, x)
    assert got["bytes_accessed"] == 4 * (32 + 32 + 16)
    assert got["flops"] == 2 * 4 * 8 * 4


def test_annotate_ranges_nest_in_a_profiler_trace():
    """While a profiler records, spans stand in its trace as nested ranges
    and the recorder holds them as one unit; with none, they are neither."""
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.annotate("outer"):
            with profiling.annotate("inner"):
                torch.ones(16, 16) @ torch.ones(16, 16)
    events = {e.name: e for e in prof.events() if e.name in ("outer", "inner")}
    outer, inner = events["outer"], events["inner"]
    assert inner.cpu_parent is not None and inner.cpu_parent.name == "outer"
    assert outer.time_range.start <= inner.time_range.start
    assert inner.time_range.end <= outer.time_range.end
    (unit,) = profiling.units()
    assert unit["name"] == "outer" and [(s["name"], s["parent"]) for s in unit["spans"]] == [
        ("inner", "outer")]
    with profiling.annotate("unrecorded"):
        pass
    assert len(profiling.units()) == 1
    profiling.reset()


def test_maybe_trace_writes_a_trace_with_the_ranges(tmp_path, monkeypatch):
    monkeypatch.delenv("UPP_PROFILE_DIR", raising=False)
    with profiling.maybe_trace() as prof:
        assert prof is None
    profiling.reset()
    with profiling.maybe_trace(str(tmp_path / "a")):
        with profiling.annotate("phase"):
            torch.ones(8) + 1
    assert [u["name"] for u in profiling.units()] == ["phase"]
    profiling.reset()
    monkeypatch.setenv("UPP_PROFILE_DIR", str(tmp_path / "b"))
    with profiling.maybe_trace():
        torch.ones(8) + 1
    for d in ("a", "b"):
        files = glob.glob(str(tmp_path / d / "trace-*.json"))
        assert len(files) == 1
    names = {e.get("name") for e in json.load(open(glob.glob(str(tmp_path / "a" / "*"))[0]))
             ["traceEvents"]}
    assert "phase" in names


def _tiny_config(tmp_path):
    synth = {"NAME": "Synthetic", "N_POINTS": 1024, "NUM_CATEGORY": 5, "SIZE": 4}
    cfg = {"optimizer": {"type": "AdamW", "kwargs": {"lr": 5e-4, "weight_decay": 0.05}},
           "scheduler": {"type": "CosLR", "kwargs": {"epochs": 4, "initial_epochs": 1}},
           "dataset": {s: {"_base_": synth, "others": {"subset": "train"}}
                       for s in ("train", "val", "test")},
           "model": SMALL, "npoints": 256, "total_bs": 4}
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


class _JaxWithoutSteps:
    """``jax`` for ``upp_tpu.utils.profiling``, whose ``jit`` gives a train
    step that does nothing: the model is still built and initialised."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def jit(fn, **kw):
        return lambda state, pts, label, rng: (state, jnp.zeros(()))


def test_profile_train_step_gives_the_jax_rows(tmp_path, monkeypatch):
    path = _tiny_config(tmp_path)
    monkeypatch.setattr(j_profiling, "jax", _JaxWithoutSteps())
    want = j_profiling.profile_train_step(path, iters=1, deep=True)
    got = profiling.profile_train_step(path, iters=1, deep=True, device="cpu")
    assert list(got) == list(want) and len(got) == 8
    assert got["full train step"] > 0 and all(np.isfinite(v) for v in got.values())
    assert os.path.exists(path)
