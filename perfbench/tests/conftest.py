"""Shared set-up of the benchmark's own tests (``python -m pytest
perfbench/tests``): the harness on the import path, the ``card`` marker
for tests that need a CUDA card (they skip, deciding inside the test,
where there is none)."""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
PERFBENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(PERFBENCH)
for p in (ROOT, PERFBENCH):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


def benchmark():
    """BENCHMARK.json."""
    import json
    return json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


def workloads():
    """The names of BENCHMARK.json's cells."""
    return [w["name"] for w in benchmark()["workloads"]]


def need_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
