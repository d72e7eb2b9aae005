"""The readers that metric files (``metrics/<name>.py``) bind to. Each takes
the finished run (``bench.Run``) and returns a number, or None when the run
holds nothing to read (a metric then stays out of the result line)."""

from __future__ import annotations

import statistics

import numpy as np

from . import yardstick

# the program's point kernels, by the names its CUDA sources give them
POINT_KERNELS = ("fps_kernel", "fps_cluster_kernel", "knn_kernel", "knn_select_kernel",
                 "nn_fused_kernel", "unpack_kernel")


def setup_s(run):
    return run.setup_s


def clouds_per_s(run):
    w = run.window
    return w.clouds / w.seconds if w.units else None


def batch_p95_ms(run):
    lat = run.window.latency
    return float(np.percentile(lat, 95)) * 1e3 if len(lat) >= 20 else None


def dispatch_ms(run):
    d = run.window.dispatch
    return statistics.fmean(d) * 1e3 if d else None


def gemm_ms(run):
    p = run.profile
    if not p:
        return None
    s = sum(t for name, (t, _) in p["kernels"].items() if yardstick.gemm_kind(name))
    return s * 1e3 / run.profile_units if s > 0 else None


def kernel_roofline(run):
    """Σ bound ÷ Σ device time over the profiled units' point-kernel
    launches, in %."""
    p = run.profile
    if not p:
        return None
    dev = sum(t for name, (t, _) in p["kernels"].items()
              if any(k in name for k in POINT_KERNELS))
    if dev <= 0:
        return None
    bound = yardstick.bound_s(run.calls, run.batch) * run.profile_units
    return 100.0 * bound / dev


def device_idle(run):
    p = run.profile
    if not p or p["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["wall_s"])


def step_mfu(run):
    """Model FLOPs of the window's steps over its seconds, against the
    float32 peak, in %."""
    w = run.window
    if not w.units or not run.flops_per_unit:
        return None
    return 100.0 * run.flops_per_unit * w.units / w.seconds / yardstick.PEAKS["f32_flop_per_s"]
