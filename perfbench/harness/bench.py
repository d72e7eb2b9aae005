"""One run of one cell: find the cell, its configuration, its traffic and its
metrics by name, set up, measure, trace, check against the reference, print
the result line.

Everything that belongs to one cell lives in files named after it:
``configs/<config>.json``, ``traffic/<traffic>.json`` (the mix's
parameters, its driver, its kernel-call table and the limits of its
check), ``drivers/<driver>.py`` and ``metrics/<metric>.py``.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from typing import Dict, Optional

import torch

from . import inputs, trace

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))   # perfbench/
ROOT = os.path.dirname(HERE)
FORBIDDEN = {"jax", "jaxlib", "flax", "upp_tpu"}


@dataclasses.dataclass
class Context:
    seed: int
    program_seed: int
    seconds: float
    trace: bool
    device: torch.device
    config: Dict
    traffic: Dict
    workload: Dict


@dataclasses.dataclass
class Run:
    """What the readers of ``metrics/`` see."""
    setup_s: float
    window: object
    profile: Optional[Dict]
    profile_units: int
    calls: list
    batch: int
    flops_per_unit: Optional[int]


def load_json(*parts) -> Dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def find(workload: str, bench: Dict):
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    config = load_json(HERE, "configs", cell["config"] + ".json")
    traffic = load_json(HERE, "traffic", cell["traffic"] + ".json")
    return cell, config, traffic


def metrics_of(bench: Dict, cell: Dict, trace_on: bool):
    """The cell's end-to-end metrics (trace off) or per-layer ones (trace on)."""
    group = bench["per_layer"] if trace_on else bench["end_to_end"]
    return [m for m in group if cell["name"] in m.get("workloads", [cell["name"]])]


def reader(name: str):
    spec = importlib.util.spec_from_file_location(f"metric_{name}",
                                                  os.path.join(HERE, "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout
        return out.strip().splitlines()[0] if out.strip() else "nvidia-smi: no output"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def set_up(ctx: Context, program: bool = True):
    """The cell's driver set up; without ``program`` the reference's side
    alone (the control)."""
    driver = importlib.import_module("drivers." + ctx.traffic["driver"])
    return driver.Cell(ctx, program=program)


def run(workload: str, seed: int, seconds: float, trace_on: bool, t0: float,
        device: Optional[torch.device] = None, overrides: Optional[Dict] = None,
        bench: Optional[Dict] = None):
    """Set up, measure, trace and check one cell. Returns (result line,
    [(name, value, limit)] of the check). ``device`` and ``overrides``
    (traffic keys) serve the CPU tests."""
    bench = bench or load_json(ROOT, "BENCHMARK.json")
    cell_entry, config, traffic = find(workload, bench)
    traffic = {**traffic, **(overrides or {})}
    device = device or torch.device("cuda", 0)
    ctx = Context(seed, seed % inputs.PROGRAM_SEED_MOD, seconds, trace_on, device, config,
                  traffic, cell_entry)
    if device.type == "cuda":
        from upp_torch import resolve_device
        resolve_device(device)              # the program's own settings (TF32 off)
    cell = set_up(ctx)
    setup_s = time.time() - t0
    window = cell.window(seconds)
    profile, units = None, 0
    if trace_on:
        t_trace = time.time()
        units, gap_units = int(traffic["profile_units"]), int(traffic["gap_units"])
        profile = trace.profile(lambda: cell.profiled(units), cell.sync)
        t_gaps = time.time()
        profile["gaps"] = trace.profile(lambda: cell.profiled(gap_units), cell.sync,
                                        host=True)["gaps"]
        print(f"perfbench: traced {units} units in {t_gaps - t_trace:.3f} s, idle "
              f"{1.0 - profile['busy_s'] / max(profile['wall_s'], 1e-9):.4f}; {gap_units} "
              f"units with host ops in {time.time() - t_gaps:.3f} s", file=sys.stderr)
    cell.sync()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    cell.release()
    t_check = time.time()
    numbers = cell.check()
    d = sorted(window.dispatch)
    q = [round(1e3 * d[int(f * (len(d) - 1))], 2) for f in (0.1, 0.5, 0.9)] if d else []
    print(f"perfbench: set-up {setup_s:.3f} s ({cell.phases}), window {window.seconds:.3f} s, "
          f"{window.units} units, dispatch ms p10/p50/p90 {q}, units/s by fifths "
          f"{window.slices()}, check {time.time() - t_check:.3f} s", file=sys.stderr)
    limits = traffic.get("limits", {})
    checked = [(k, v, limits.get(k)) for k, v in sorted(numbers.items())]
    correct = all(lim is not None and v <= lim for _, v, lim in checked)

    r = Run(setup_s, window, profile, units, traffic["calls"], cell.B, cell.flops())
    metrics = {}
    for m in metrics_of(bench, cell_entry, trace_on):
        v = reader(m["name"])(r)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": int(cell_entry["chips"]), "memory_peak_bytes": int(peak)}
    line = {"correct": bool(correct), "attempted": int(window.units),
            "failed": cell.failed, "metrics": metrics, "device": dev}
    if trace_on and profile:
        dev["busy_s"] = profile["busy_s"]
        dev["window_s"] = profile["wall_s"]
        line["breakdown"] = {"device_ops": trace.top_kernels(profile["kernels"]),
                             "idle_gaps": [[k, s] for k, s in profile["gaps"]]}
    line["checked"] = {k: {"value": v, "limit": lim} for k, v, lim in checked}
    return line, checked


def main(args, t0: float) -> int:
    bench = load_json(ROOT, "BENCHMARK.json")
    cell_entry = find(args.workload, bench)[0]
    chips = int(cell_entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    line, checked = run(args.workload, args.seed, float(args.seconds), bool(args.trace), t0,
                        bench=bench)
    print(f"perfbench: {card_line()}", file=sys.stderr)
    found = sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)
    if found:
        print(f"perfbench: the run loaded {found}; the benchmark measures the port alone",
              file=sys.stderr)
        return 3
    for k, v, lim in checked:
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0
