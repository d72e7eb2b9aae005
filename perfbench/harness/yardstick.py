"""The benchmark's yardstick: the card's peaks, the least time a point
kernel's call needs, and GEMM kernels told apart by name. (A step's model
FLOPs are its driver's, counted by the reference, ``reference/flops.py``.)

``bound_parts`` counts, for one call, its inputs read once and its outputs
written once, and 10 float32 operations per (point, round) of FPS, per
(query, point) pair of kNN and per (x, y) pair of Chamfer (3 sub, 3 mul, 2
add, a compare and a select or minimum). FPS is counted as the plain
algorithm: a kernel that skips work by a spatial structure could read over
100% against it.
"""

from __future__ import annotations

import json
import os
from typing import Tuple

PEAKS = json.load(open(os.path.join(os.path.dirname(__file__), "peaks.json")))

# GEMM kernels by name: float32 on the SIMT cores, or on the tensor cores
# (cuBLAS's Hopper "nvjet" kernels, CUTLASS/xmma ones)
SIMT_GEMM = ("sgemm", "ffma", "simt")
TC_GEMM = ("bf16", "nvjet", "gmma", "tensorop", "16816", "hmma")
GEMM = ("gemm", "nvjet", "xmma", "cutlass")


def gemm_kind(name: str):
    """"simt", "tensor core", "other" or None (not a GEMM) for a kernel's name."""
    k = name.lower()
    if not any(g in k for g in GEMM):
        return None
    if any(g in k for g in SIMT_GEMM):
        return "simt"
    return "tensor core" if any(g in k for g in TC_GEMM) else "other"


def bound_parts(call, batch: int) -> Tuple[int, int]:
    """(bytes, float32 operations) one call must move and do: ``call`` is
    ("fps", N, samples, masked), ("knn", S, N, k, gather) or ("chamfer",
    N, M, masked)."""
    if call[0] == "fps":
        _, n, s, masked = call
        nbytes = batch * n * 12 + batch * s * 4 + (batch * n + batch * 4 if masked else 0)
        return nbytes, 10 * batch * s * n
    if call[0] == "chamfer":
        _, n, m, masked = call
        return batch * (n + m) * (12 + 8 + (1 if masked else 0)), 10 * batch * n * m
    _, s, n, k, gather = call
    nbytes = batch * (s * 12 + n * 12 + s * k * 8 + (s * k * 12 if gather else 0))
    return nbytes, 10 * batch * s * n


def bound_s(calls, batch: int) -> float:
    """Least seconds of a step's calls [(call, count)] at the peaks: each call
    bound by bytes or by operations, whichever takes longer."""
    total = 0.0
    for call, count in calls:
        nbytes, ops = bound_parts(tuple(call), batch)
        total += count * max(nbytes / PEAKS["hbm_bytes_per_s"], ops / PEAKS["f32_flop_per_s"])
    return total
