"""Readers of the program's own spans and counters (``upp_torch.utils.
profiling``, the recorder), and of the point kernels' launches in the
trace. A traced run's profiled slices record the spans: the recorder is on
while ``torch.profiler`` records. A reader takes the first
``run.profile_units`` units the recorder holds after the run, the
device-only slice on a card, and returns the mean a unit, or None where
there is nothing to read: no units, a span absent from every unit, windows
on the CPU, or a program without the recorder.

Host times come from that slice, whose host runs slower than an untraced
run's (CUPTI's work at each launch), and a window is a stretch of the
stream's timeline, the device's idle time in it included, not the device
time of the span's kernels."""

from __future__ import annotations

import statistics
from typing import List, Optional

from .readers import POINT_KERNELS


def _units(run) -> List[dict]:
    try:
        from upp_torch.utils.profiling import units
    except ImportError:                      # a program without the recorder
        return []
    return units()[:run.profile_units] if run.profile_units else []


def _span_ms(run, name: str, clock: str) -> Optional[float]:
    """Mean a unit of span ``name``'s ``host_ms`` or ``window_ms``, summed
    over its spans of that name in the unit."""
    units = _units(run)
    found, per_unit = False, []
    for u in units:
        ms = [s[clock] for s in u["spans"] if s["name"] == name]
        if any(m is None for m in ms):
            return None
        found = found or bool(ms)
        per_unit.append(sum(ms))
    return statistics.fmean(per_unit) if found else None


def _counter(run, name: str) -> Optional[float]:
    units = _units(run)
    return statistics.fmean(u["counts"].get(name, 0) for u in units) if units else None


def step_host_ms(run):
    units = _units(run)
    return statistics.fmean(u["host_ms"] for u in units) if units else None


def backward_host_ms(run):
    return _span_ms(run, "backward", "host_ms")


def optimizer_host_ms(run):
    return _span_ms(run, "optimizer", "host_ms")


def rectify_window_ms(run):
    return _span_ms(run, "rectify", "window_ms")


def completion_window_ms(run):
    return _span_ms(run, "completion", "window_ms")


def downstream_window_ms(run):
    return _span_ms(run, "downstream", "window_ms")


def chamfer_window_ms(run):
    return _span_ms(run, "chamfer", "window_ms")


def host_syncs(run):
    return _counter(run, "host_syncs")


def point_launches(run):
    """FPS, kNN and Chamfer kernel launches a unit in the device-only
    profile, by the kernels' names (a replayed graph's launches count too)."""
    p = run.profile
    if not p or p["busy_s"] <= 0 or not run.profile_units:
        return None
    n = sum(c for name, (_, c) in p["kernels"].items() if any(k in name for k in POINT_KERNELS))
    return n / run.profile_units
