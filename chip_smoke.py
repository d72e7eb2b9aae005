#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (``upp_torch``) once on a CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build the CUDA kernels from ``upp_torch/csrc`` (one nvcc per source,
     in parallel) and print the build time and each kernel's registers and
     spills (``ptxas -v``);
  2. hold each kernel against its plain PyTorch version on the card at
     every shape the paths give it (classification shapes at batch 120,
     pretask shapes at batch 64): FPS indices equal, kNN indices equal and
     distances within 1e-6 (gathered xyz equal), Chamfer indices equal and
     distances within 1e-6 with and without validity masks; time kernel and
     plain. Then FPS and kNN again on grid-quantized clouds full of repeated
     points (real ties) at the big path shapes, and at the edge shapes of
     their limits on random and tie clouds, with every FPS variant run; and
     the host time per wrapper call at two small shapes;
  3. kNN backward: gradients to query and points through the kernel's
     autograd Function against autograd through ``knn_plain`` (rtol 1e-5,
     atol 1e-6) at the pretask's gradient shapes; time both backwards;
  4. clean eval: ``make_eval_step`` (FPS 8192→1024, downstream pass, argmax)
     at full width on 120 synthetic 8192-point clouds, seeded weights;
  5. robust inference: ``corrupt_batch`` (viewpoint crop 8192→1024, +48
     lidar, +24 shell points) then the 3-pass ``PointMAEUnify`` at full
     width, batch 120: finite logits, launch counts of one step, time; then
     ``torch.profiler`` over 3 steps: device-busy ms per step, idle share,
     the FPS and kNN kernels' device time;
  6. card vs CPU: the same weights and corrupted input at batch 8 through
     the kernels on the card and the plain versions on the CPU: logits
     within rtol 1e-3 / atol 2e-3, equal argmax;
  7. pretask train: 3 steps of ``make_pretask_train_step`` on
     ``cfgs/pretask_synthetic.yaml`` at full width, batch 64 (``total_bs``
     of ``cfgs/pretask.yaml``): finite loss terms, trainable parameters
     changed and frozen ones bit-unchanged, launch counts of one step, time
     per step, peak memory;
  8. pretask eval: ``make_pretask_eval_step`` (easy crop, viewpoint
     (1,1,1)) at batch 64: finite CDs and F-score, launch counts, time;
  9. pretask card vs CPU: one train step at batch 4 from the same weights
     and draws, dropout and drop-path off: the four loss terms within
     rtol 1e-3 / atol 2e-3, the trainable gradients' global norm within
     rtol 1e-2.
Launch counts are reset right before each path run (4, 5, 7, 8) and read
right after; the kernel-vs-plain comparisons do not count. Before the last
line it prints the ``kernels`` JSON line and the card's name and power
limit; the last line is the ``{"ok": true, "device": ...}`` JSON object.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import types
from collections import Counter

import numpy as np
import torch

CFG = "cfgs/unify_synthetic_cls.yaml"
PRETASK_CFG = "cfgs/pretask_synthetic.yaml"
B = 120                 # the flagship's batch
B_CPU = 8               # card-vs-CPU comparison batch
B_PRETASK = 64          # total_bs of the published cfgs/pretask.yaml
B_PRETASK_CPU = 4       # pretask card-vs-CPU comparison batch
N_POINTS = 8192
NPOINTS = 1024
SEED = 0
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
F32_FLOP_PER_S = 67e12        # H100 SXM data sheet, float32 outside tensor cores

# every kernel call of one step, with its count per step:
# ("fps", N, n_samples, masked) / ("knn", S, N, k, gather) /
# ("chamfer", N, M, masked)
CLEAN_CALLS = Counter({
    ("fps", 8192, 1024, False): 1,            # make_eval_step's FPS
    ("fps", 1024, 64, False): 1, ("knn", 64, 1024, 32, True): 1,    # group
    ("fps", 64, 32, False): 1, ("knn", 32, 64, 8, True): 1,         # lvl2 group
    ("knn", 64, 32, 8, False): 6,             # propagation in 6 prompted blocks
})
ROBUST_CALLS = Counter({
    ("fps", 8192, 1024, True): 1,             # viewpoint crop (partial half)
    # rectify pass
    ("fps", 1096, 32, False): 1, ("knn", 32, 1096, 16, True): 1,
    ("fps", 32, 32, False): 1, ("knn", 32, 32, 16, True): 1,        # SA group
    ("knn", 32, 32, 16, False): 1,            # propagation2 interp
    ("knn", 1096, 32, 16, False): 1,          # propagation1 interp
    # completion pass
    ("fps", 972, 32, False): 1, ("knn", 32, 972, 16, True): 1,
    ("knn", 32, 32, 6, False): 1,             # mask-token propagate
    ("fps", 1024, 256, False): 1, ("fps", 1228, 1024, False): 1,
    # downstream pass
    ("fps", 1024, 64, False): 1, ("knn", 64, 1024, 32, True): 1,
    ("fps", 64, 32, False): 1, ("knn", 32, 64, 8, True): 1,
    ("knn", 64, 32, 8, False): 6,
})
PRETASK_TRAIN_CALLS = Counter({
    ("fps", 8192, 1024, True): 2,             # viewpoint crop, both halves
    # rectify pass over 1024 + 20 shell + 32 lidar points
    ("fps", 1076, 32, False): 1, ("knn", 32, 1076, 16, True): 1,
    ("fps", 32, 32, False): 1, ("knn", 32, 32, 16, True): 1,        # SA group
    ("knn", 32, 32, 16, False): 1,            # propagation2 interp
    ("knn", 1076, 32, 16, False): 1,          # propagation1 interp
    ("knn", 52, 1024, 4, True): 1,            # noise supervision (K=4)
    # completion pass after dropping the 52 noisiest points
    ("fps", 1024, 32, False): 1, ("knn", 32, 1024, 16, True): 1,
    ("knn", 32, 32, 6, False): 1,             # mask-token propagate, with gradient
    # losses: coarse vs crop, rebuild vs crop, partial+rebuild vs gt
    ("chamfer", 32, 1024, False): 1, ("chamfer", 1024, 1024, False): 1,
    ("chamfer", 2048, 8192, False): 1,
})   # a Chamfer call is two launches, one per direction
PRETASK_EVAL_CALLS = Counter({
    ("fps", 8192, 1024, True): 1,             # easy crop, partial half
    ("fps", 1024, 128, False): 1,             # partial centers
    ("fps", 1024, 32, False): 1, ("knn", 32, 1024, 16, True): 1,
    ("knn", 32, 32, 6, False): 1,
    ("chamfer", 160, 8192, False): 2,         # sparse L1, L2
    ("chamfer", 2048, 8192, False): 5,        # dense L1, L2, F-score, CDL1, CDL2
})
KNN_GRAD_CALLS = (("knn", 32, 32, 6, False), ("knn", 32, 1024, 16, True))
# path shapes held to the plain versions again on grid-quantized clouds full
# of repeated points (every squared distance exact: real ties), at batch B
TIE_CALLS = (("knn", 64, 1024, 32, True), ("knn", 32, 1096, 16, True),
             ("fps", 8192, 1024, True), ("fps", 1228, 1024, False))
# the kernels' limits and, with the path shapes, every FPS variant (csrc/fps.cu
# chooses one by N), on random clouds and on tie clouds, at batch B_EDGE
B_EDGE = 8
EDGE_CALLS = (("knn", 64, 16384, 32, True), ("knn", 37, 16, 16, True),
              ("knn", 1, 1024, 32, True), ("knn", 100, 1096, 16, False),
              ("fps", 16384, 1024, True), ("fps", 16384, 256, False),
              ("fps", 3000, 512, False), ("fps", 100, 64, False), ("fps", 20, 20, True))
HOST_CALLS = (("knn", 64, 32, 8, False), ("fps", 64, 32, False))   # host cost per call
KERNEL_SOURCES = {
    "fps": ("upp_torch/csrc/fps.cu", "upp_tpu/ops/fps_pallas.py:38"),
    "knn": ("upp_torch/csrc/knn.cu", "upp_tpu/ops/knn_pallas.py:48"),
    "chamfer": ("upp_torch/csrc/chamfer.cu", "upp_tpu/ops/chamfer_pallas.py:44"),
}


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def synthetic_clouds(n: int) -> np.ndarray:
    from upp_torch.data.synthetic import SyntheticDataset
    from upp_torch.utils.config import ConfigDict
    ds = SyntheticDataset(ConfigDict(N_POINTS=N_POINTS, NUM_CATEGORY=6,
                                     SIZE=n, subset="test"))
    return np.stack([ds[i][2][0] for i in range(n)]).astype(np.float32)


def _wrappers():
    """(name, module, attribute, key of a call) of each kernel wrapper."""
    from upp_torch.ops import chamfer_cuda, fps_cuda, knn_cuda
    return (
        ("fps", fps_cuda, "fps_idx",
         lambda xyz, n_samples, valid=None, start_idx=None:
             ("fps", xyz.shape[1], n_samples, valid is not None)),
        ("knn", knn_cuda, "knn",
         lambda query, points, k, gather:
             ("knn", query.shape[1], points.shape[1], k, gather)),
        ("chamfer", chamfer_cuda, "nn_both",
         lambda x, y, valid_x=None, valid_y=None:
             ("chamfer", x.shape[1], y.shape[1],
              valid_x is not None or valid_y is not None)),
    )


class Recorder:
    """Counts the kernel calls of a path run by shape, around the wrappers.
    The wrappers' own launch counters are what the run reports: a wrapper
    increments its counter through its module-level name, which points at
    the recording stand-in here, so the stand-in carries the counter and
    hands it back on exit."""

    def __init__(self):
        self.wrappers = _wrappers()
        self.calls = Counter()

    def __enter__(self):
        self.orig = []
        for _, mod, attr, key in self.wrappers:
            f0 = getattr(mod, attr)

            def rec(*a, _f0=f0, _key=key, **kw):
                self.calls[_key(*a, **kw)] += 1
                return _f0(*a, **kw)

            rec.launches = f0.launches
            setattr(mod, attr, rec)
            self.orig.append(f0)
        return self

    def __exit__(self, *exc):
        for (_, mod, attr, _), f0 in zip(self.wrappers, self.orig):
            f0.launches = getattr(mod, attr).launches
            setattr(mod, attr, f0)


def reset_counts():
    for _, mod, attr, _ in _wrappers():
        getattr(mod, attr).launches = 0


def read_counts():
    return {name: getattr(mod, attr).launches for name, mod, attr, _ in _wrappers()}


def bound_parts(call, bsz):
    """(bytes, operations) the call must move and do: inputs read once,
    outputs written once; 10 float32 operations per (point, round) of FPS
    (3 sub, 3 mul, 2 add, min, compare), per (query, point) pair of kNN
    (3 sub, 3 mul, 2 add, compare against the k-th, plus the select) and per
    (x, y) pair of Chamfer (3 sub, 3 mul, 2 add, one compare and select in
    each direction; a pair is evaluated once in the least work)."""
    if call[0] == "fps":
        _, n, s, masked = call
        nbytes = bsz * n * 12 + bsz * s * 4 + (bsz * n + bsz * 4 if masked else 0)
        return nbytes, 10 * bsz * s * n
    if call[0] == "chamfer":
        _, n, m, masked = call
        nbytes = bsz * (n + m) * (12 + 8 + (1 if masked else 0))
        return nbytes, 10 * bsz * n * m
    _, s, n, k, gather = call
    nbytes = bsz * (s * 12 + n * 12 + s * k * 8 + (s * k * 12 if gather else 0))
    return nbytes, 10 * bsz * s * n


def kernel_shapes():
    """(call, batch) of every kernel shape the paths run: the classification
    shapes at batch 120, the pretask ones it does not share at batch 64."""
    cls = set(CLEAN_CALLS) | set(ROBUST_CALLS)
    pretask = (set(PRETASK_TRAIN_CALLS) | set(PRETASK_EVAL_CALLS)) - cls
    return [(c, B) for c in sorted(cls)] + [(c, B_PRETASK) for c in sorted(pretask)]


def _check_fps(call, clouds, gen):
    from upp_torch.ops import fps_cuda
    from upp_torch.ops.corrupt import _crop_masks
    from upp_torch.ops.fps import fps_plain_idx
    from upp_torch.ops.geometry import index_points
    _, n, s, masked = call
    xyz = clouds[:, :n].contiguous()
    valid = start = None
    if masked:
        d, crop = _crop_masks(xyz, n // 4, None, gen)
        valid = ~crop
        start = torch.where(valid, d, torch.inf).argmin(1)
    k_idx = fps_cuda.fps_idx(xyz, s, valid, start)
    p_idx = fps_plain_idx(xyz, s, valid, start)
    torch.cuda.synchronize()
    if not torch.equal(k_idx.long(), p_idx):
        bad = (k_idx.long() != p_idx).sum().item()
        raise AssertionError(f"FPS {call}: {bad} indices differ from the plain version")
    err = (index_points(xyz, k_idx.long()) - index_points(xyz, p_idx)).abs().max().item()
    ms = cuda_ms(lambda: fps_cuda.fps_idx(xyz, s, valid, start), reps=10)
    plain_ms = cuda_ms(lambda: fps_plain_idx(xyz, s, valid, start), reps=2, warmup=1)
    return err, ms, plain_ms


def _check_knn(call, clouds):
    from upp_torch.ops import knn_cuda
    from upp_torch.ops.geometry import index_points
    from upp_torch.ops.knn import knn_plain
    _, s, n, k, gather = call
    points = clouds[:, :n].contiguous()
    query = clouds[:, :s].contiguous()
    kd, ki, kn = knn_cuda.knn(query, points, k, gather)
    pd, pi = knn_plain(query, points, k)
    torch.cuda.synchronize()
    if not torch.equal(ki.long(), pi):
        bad = (ki.long() != pi).sum().item()
        raise AssertionError(f"kNN {call}: {bad} indices differ from the plain version")
    err = (kd - pd).abs().max().item()
    if err > 1e-6:
        raise AssertionError(f"kNN {call}: distances differ by {err} > 1e-6")
    if gather:
        nerr = (kn - index_points(points, pi)).abs().max().item()
        if nerr != 0.0:
            raise AssertionError(f"kNN {call}: gathered xyz differ by {nerr}")
    ms = cuda_ms(lambda: knn_cuda.knn(query, points, k, gather), reps=20)
    plain_ms = cuda_ms(lambda: knn_plain(query, points, k), reps=5)
    return err, ms, plain_ms


def _check_chamfer(call, clouds, gen):
    """x: the next cloud's first N points (another shape), y: the cloud's
    first M points; unmasked and with random validity masks."""
    from upp_torch.ops import chamfer_cuda
    from upp_torch.ops.chamfer import nn_both_plain
    _, n, m, _ = call
    x = torch.roll(clouds, 1, 0)[:, :n].contiguous()
    y = clouds[:, :m].contiguous()
    bsz = clouds.shape[0]
    vx = torch.rand((bsz, n), generator=gen, device=x.device) > 0.2
    vy = torch.rand((bsz, m), generator=gen, device=x.device) > 0.2
    err = 0.0
    for masks in ((None, None), (vx, vy)):
        got = chamfer_cuda.nn_both(x, y, *masks)
        want = nn_both_plain(x, y, *masks)
        torch.cuda.synchronize()
        for name, g, w in zip(("i1", "i2"), got[1::2], want[1::2]):
            if not torch.equal(g.long(), w):
                bad = (g.long() != w).sum().item()
                raise AssertionError(f"Chamfer {call} masked={masks[0] is not None}: "
                                     f"{bad} {name} differ from the plain version")
        e = max((g - w).abs().max().item() for g, w in zip(got[0::2], want[0::2]))
        if e > 1e-6:
            raise AssertionError(f"Chamfer {call}: distances differ by {e} > 1e-6")
        err = max(err, e)
    ms = cuda_ms(lambda: chamfer_cuda.nn_both(x, y), reps=10)
    plain_ms = cuda_ms(lambda: nn_both_plain(x, y), reps=2, warmup=1)
    return err, ms, plain_ms


def tie_clouds(bsz, n, gen):
    """[bsz, n, 3] on the card: n // 2 points of the grid of multiples of 1/8
    in [-1, 1] and n - n // 2 repeats of them, in a random order."""
    base = torch.randint(-8, 9, (bsz, n // 2, 3), generator=gen, device=gen.device) / 8.0
    pick = torch.randint(0, n // 2, (bsz, n - n // 2), generator=gen, device=gen.device)
    cloud = torch.cat([base, torch.gather(base, 1, pick[..., None].expand(-1, -1, 3))], 1)
    order = torch.argsort(torch.rand((bsz, n), generator=gen, device=gen.device), 1)
    return torch.gather(cloud, 1, order[..., None].expand(-1, -1, 3)).contiguous()


def _check(call, clouds, gen):
    if call[0] == "fps":
        return _check_fps(call, clouds, gen)
    if call[0] == "knn":
        return _check_knn(call, clouds)
    return _check_chamfer(call, clouds, gen)


def phase_kernels(clouds, card):
    """Kernel vs plain on the card at every path shape. Returns per-shape
    rows."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for call, bsz in kernel_shapes():
        err, ms, plain_ms = _check(call, clouds[:bsz], gen)
        nbytes, ops = bound_parts(call, bsz)
        rows.append({"call": list(call), "batch": bsz, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "bytes": nbytes, "ops": ops})
        print(f"[kernel] {call}: max_abs_err {err:.3g}, kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {bound_ms(nbytes, ops):.4f} ms "
              f"(B={bsz}; {card})", flush=True)
    return rows


def phase_kernel_ties_and_edges(card):
    """FPS and kNN vs plain on tie clouds at the big path shapes (batch B),
    and at the edge shapes (batch B_EDGE) on random and on tie clouds; every
    FPS variant must have run."""
    from upp_torch.ops import fps_cuda
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    cases = [("ties", call, tie_clouds(B, 8192, gen)) for call in TIE_CALLS]
    for call in EDGE_CALLS:
        n = max(call[1:3]) if call[0] == "knn" else call[1]
        cases.append(("edge", call, torch.randn((B_EDGE, n, 3), generator=gen,
                                                device=gen.device)))
        cases.append(("edge ties", call, tie_clouds(B_EDGE, n, gen)))
    for kind, call, clouds in cases:
        err, ms, plain_ms = _check(call, clouds, gen)
        print(f"[kernel {kind}] {call}: identical to plain, max_abs_err {err:.3g}, kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms (B={clouds.shape[0]}; {card})", flush=True)
    fps_n = {c[1] for c, _ in kernel_shapes() if c[0] == "fps"}
    fps_n |= {c[1] for c in EDGE_CALLS if c[0] == "fps"}
    variants = {n: fps_cuda.variant(n) for n in sorted(fps_n)}
    print(f"[kernel variants] FPS variant by N: {variants}", flush=True)
    if set(variants.values()) != set(range(fps_cuda.num_variants())):
        raise AssertionError(f"FPS variants run {set(variants.values())}, of "
                             f"{fps_cuda.num_variants()}")


def phase_host_cost(clouds, card, reps=200):
    """Host time per wrapper call at small shapes: the enqueue of ``reps``
    calls on the host clock, the device time by CUDA events beside it."""
    from upp_torch.ops import fps_cuda, knn_cuda
    for call in HOST_CALLS:
        if call[0] == "knn":
            _, s, n, k, gather = call
            points, query = clouds[:, :n].contiguous(), clouds[:, :s].contiguous()

            def fn():
                return knn_cuda.knn(query, points, k, gather)
        else:
            _, n, s, _ = call
            xyz = clouds[:, :n].contiguous()

            def fn():
                return fps_cuda.fps_idx(xyz, s)
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_us = (time.perf_counter() - t0) / reps * 1e6
        torch.cuda.synchronize()
        dev_us = cuda_ms(fn, reps) * 1e3
        print(f"[host] {call}: {host_us:.1f} us of host time per call ({reps} calls "
              f"enqueued), {dev_us:.1f} us per call by CUDA events (B={clouds.shape[0]}; "
              f"{card})", flush=True)


def bound_ms(nbytes, ops):
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOP_PER_S) * 1e3


def phase_knn_backward(clouds, card):
    """Gradients through the kernel's autograd Function vs autograd through
    ``knn_plain`` at the pretask's gradient-carrying kNN shapes."""
    from upp_torch.ops.geometry import index_points
    from upp_torch.ops.knn import knn, knn_plain, knn_points
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    for call in KNN_GRAD_CALLS:
        _, s, n, k, gather = call
        points = clouds[:B_PRETASK, :n].contiguous()
        query = (clouds[:B_PRETASK, n:n + s] * 0.9).contiguous()
        g_d = torch.randn((B_PRETASK, s, k), generator=gen, device=points.device)
        g_nb = torch.randn((B_PRETASK, s, k, 3), generator=gen, device=points.device)

        def loss(q, p, kernel):
            if kernel:
                out = knn_points(q, p, k) if gather else knn(q, p, k)
            else:
                d, idx = knn_plain(q, p, k)
                out = (d, idx, index_points(p, idx))
            total = (out[0] * g_d).sum()
            return total + (out[2] * g_nb).sum() if gather else total

        grads, times = [], []
        for kernel in (True, False):
            q = query.clone().requires_grad_(True)
            p = points.clone().requires_grad_(True)
            value = loss(q, p, kernel)
            grads.append(torch.autograd.grad(value, (q, p), retain_graph=True))
            times.append(cuda_ms(lambda: torch.autograd.grad(value, (q, p), retain_graph=True),
                                 reps=10))
        for name, g, w in zip(("query", "points"), *grads):
            if not torch.allclose(g, w, rtol=1e-5, atol=1e-6):
                raise AssertionError(f"kNN backward {call}: {name} gradients differ by "
                                     f"{(g - w).abs().max().item()}")
        err = max((g - w).abs().max().item() for g, w in zip(*grads))
        print(f"[knn backward] {call}: max |grad diff| {err:.3g} (rtol 1e-5, atol 1e-6); "
              f"backward through the kernel's Function {times[0]:.4f} ms, through "
              f"knn_plain {times[1]:.4f} ms (B={B_PRETASK}; {card})", flush=True)


def profile_steps(step, name, step_ms, card, steps=3, rows=10):
    """``torch.profiler`` over ``steps`` steps: the device's busy time per
    step (the self device time of its own events: kernels, copies, memsets),
    the wall time per step, the idle share against both the profiled and the
    unprofiled (``step_ms``) step, the FPS and kNN kernels' share, and the
    largest rows."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    events = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                     and not getattr(e, "is_user_annotation", False)), key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in events) / 1e3 / steps
    if busy <= 0.0:
        print(f"[{name} profile] the profiler saw no device time: busy time and idle "
              "share not measured", flush=True)
        return
    fps_ms, knn_ms = (sum(dev_us(e) for e in events if kernel in e.key) / 1e3 / steps
                      for kernel in ("fps_kernel", "knn_kernel"))
    print(f"[{name} profile] {steps} steps: device busy {busy:.3f} ms/step (FPS kernels "
          f"{fps_ms:.3f}, kNN kernels {knn_ms:.3f}); wall {wall_ms:.2f} ms/step profiled "
          f"(idle share {1 - busy / wall_ms:.3f}), {step_ms:.2f} unprofiled (idle share "
          f"{1 - busy / step_ms:.3f}) (B={B}; {card})", flush=True)
    for e in events[:rows]:
        print(f"[{name} profile]   {dev_us(e) / 1e3 / steps:8.3f} ms/step  "
              f"{e.count // steps:5d} calls/step  {e.key[:90]}", flush=True)


def check_calls(name, rec, want):
    """The path run's calls by shape equal ``want``, and every kernel of the
    path launched at least once (by its wrapper's own counter)."""
    got = Counter({k: v for k, v in rec.calls.items()})
    if got != want:
        raise AssertionError(f"{name}: kernel calls {dict(got)} != expected {dict(want)}")
    counts = read_counts()
    idle = sorted({c[0] for c in want if counts[c[0]] < 1})
    if idle:
        raise AssertionError(f"{name} launched no {idle} kernel: {counts}")
    return counts


def kernel_entry(name, rows, table, launches):
    """The ``kernels`` JSON entry of one kernel: ms, plain and bound summed
    over one step's calls (``table``) from the per-shape rows."""
    src, replaces = KERNEL_SOURCES[name]
    bsz = B if table is ROBUST_CALLS else B_PRETASK
    mine = [(r, table[tuple(r["call"])]) for r in rows
            if r["call"][0] == name and r["batch"] == bsz and tuple(r["call"]) in table]
    t_bytes = sum(r["bytes"] * c for r, c in mine) / HBM_BYTES_PER_S * 1e3
    t_ops = sum(r["ops"] * c for r, c in mine) / F32_FLOP_PER_S * 1e3
    return {"name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows if r["call"][0] == name),
            "ms": sum(r["ms"] * c for r, c in mine),
            "plain_ms": sum(r["plain_ms"] * c for r, c in mine),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


def no_dropout(model):
    """Dropout and drop-path off (their draws differ between devices)."""
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
        if hasattr(m, "drop_path_rate"):
            m.drop_path_rate = 0.0
    return model


def pretask_setup(config, device):
    """(model, optimizer, train step, eval step) of the pretask path from
    the seeded weights, with the stage-1 trainable set."""
    from upp_torch.train.optim import build_optimizer, set_trainable
    from upp_torch.train.runner_cls import init_model
    from upp_torch.train.runner_pretask import (PRETASK_PEFT_LIST, make_pretask_eval_step,
                                                make_pretask_train_step)
    args = types.SimpleNamespace(seed=SEED, noise=True,
                                 noise_type=["gaussian_noise", "lidar_noise"])
    model = init_model(args, config, device)
    set_trainable(model, PRETASK_PEFT_LIST)
    optimizer = build_optimizer(config, model, steps_per_epoch=1)
    return (model, optimizer, make_pretask_train_step(model, optimizer, config, args),
            make_pretask_eval_step(model, config, "easy"))


def phase_pretask(clouds, config, card, device):
    """Pretask train (3 steps) and eval at full width, batch 64. Returns the
    launch counts of one train step."""
    from upp_torch.train.runner_pretask import LOSS_NAMES
    model, _, train_step, eval_step = pretask_setup(config, device)
    gt = clouds[:B_PRETASK]
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with Recorder() as rec:
        terms = train_step(gt)
        torch.cuda.synchronize()
    counts = check_calls("pretask train", rec, PRETASK_TRAIN_CALLS)
    history = [terms] + [train_step(gt) for _ in range(2)]
    for i, t in enumerate(history):
        vals = {k: float(v) for k, v in t.items()}
        if not all(np.isfinite(v) for v in vals.values()):
            raise AssertionError(f"pretask train step {i}: loss terms not finite: {vals}")
        print(f"[pretask train] step {i}: " + ", ".join(f"{k} {v:.4f}" for k, v in vals.items()),
              flush=True)
    trainable = [n for n, p in model.named_parameters() if p.requires_grad]
    frozen = [n for n, p in model.named_parameters() if not p.requires_grad]
    params = dict(model.named_parameters())
    stale = [n for n in trainable if torch.equal(params[n].detach(), before[n])]
    moved = [n for n in frozen if not torch.equal(params[n].detach(), before[n])]
    if stale or moved or not trainable:
        raise AssertionError(f"pretask train: trainable unchanged {stale[:5]}, "
                             f"frozen changed {moved[:5]}, {len(trainable)} trainable")
    # eager steps wait on the host, whose cores the machine shares: average 10
    step_ms = cuda_ms(lambda: train_step(gt), reps=10, warmup=1)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[pretask train] launches of one step {counts}; {len(trainable)} trainable "
          f"tensors changed, {len(frozen)} frozen bit-unchanged; {step_ms:.2f} ms/step, "
          f"{B_PRETASK / step_ms * 1e3:.1f} clouds/s, peak {peak_gib:.2f} GiB "
          f"(B={B_PRETASK}; {card})", flush=True)
    assert set(LOSS_NAMES) == set(terms)

    vp = torch.tensor((1.0, 1.0, 1.0))
    reset_counts()
    with Recorder() as rec:
        out = eval_step(gt, vp)
        torch.cuda.synchronize()
    eval_counts = check_calls("pretask eval", rec, PRETASK_EVAL_CALLS)
    vals = {k: v.float().mean().item() for k, v in out.items()}
    if not all(np.isfinite(v) for v in vals.values()) or not 0.0 <= vals["F-Score"] <= 1.0:
        raise AssertionError(f"pretask eval: bad metrics {vals}")
    eval_ms = cuda_ms(lambda: eval_step(gt, vp), reps=10, warmup=1)
    print(f"[pretask eval] launches {eval_counts}; "
          + ", ".join(f"{k} {v:.4f}" for k, v in vals.items())
          + f"; {eval_ms:.2f} ms/batch (B={B_PRETASK}; {card})", flush=True)
    return counts


def phase_pretask_card_vs_cpu(clouds, config, card, device):
    """One train step at batch 4 on the card and on the CPU from the same
    weights and draws (drawn on the CPU), dropout and drop-path off."""
    from upp_torch.train.runner_pretask import (GAUSSIAN_NUM, LIDAR_NUM, PRETASK_PEFT_LIST,
                                                PretaskDraws)
    bsz = B_PRETASK_CPU
    gen = torch.Generator().manual_seed(SEED + 3)
    v = torch.randn((bsz, 3), generator=gen)
    n_in = int(config.npoints) + GAUSSIAN_NUM
    draws = PretaskDraws(
        num_crop=int(torch.randint(int(N_POINTS * 0.15), int(N_POINTS * 0.5) + 1, (),
                                   generator=gen)),
        viewpoints=v / torch.linalg.norm(v, dim=-1, keepdim=True),
        shell_u=float(torch.rand((), generator=gen)),
        shell_normal=torch.randn((bsz, GAUSSIAN_NUM, 3), generator=gen),
        lidar_idx=torch.randint(0, n_in, (LIDAR_NUM,), generator=gen),
        lidar_factor=1.2 + 0.3 * torch.rand((LIDAR_NUM,), generator=gen),
        aug_scale=2 / 3 + (3 / 2 - 2 / 3) * torch.rand((bsz, 1, 3), generator=gen),
        aug_shift=0.2 * (2 * torch.rand((bsz, 1, 3), generator=gen) - 1))
    results = []
    for dev in (device, torch.device("cpu")):
        model, _, train_step, _ = pretask_setup(config, dev)
        no_dropout(model)
        on_dev = PretaskDraws(**{k: (x.to(dev) if torch.is_tensor(x) else x)
                                 for k, x in vars(draws).items()})
        terms = train_step(clouds[:bsz].to(dev), on_dev)
        gnorm = torch.sqrt(sum((p.grad.double() ** 2).sum() for n, p in model.named_parameters()
                               if p.grad is not None and any(t in n for t in PRETASK_PEFT_LIST)))
        results.append(({k: float(x) for k, x in terms.items()}, float(gnorm)))
    (card_t, card_g), (cpu_t, cpu_g) = results
    print(f"[pretask card vs cpu] recall card {card_t['recall']:.4f}, cpu {cpu_t['recall']:.4f} "
          "(a flipped near-tie in the hard drop shows here)", flush=True)
    for k in ("cropping_coarse", "cropping_dense", "dense", "noise_loss"):
        if not np.isclose(card_t[k], cpu_t[k], rtol=1e-3, atol=2e-3):
            raise AssertionError(f"pretask card vs CPU: {k} {card_t[k]} vs {cpu_t[k]}")
    if not np.isclose(card_g, cpu_g, rtol=1e-2, atol=0.0):
        raise AssertionError(f"pretask card vs CPU: grad norm {card_g} vs {cpu_g}")
    diff = max(abs(card_t[k] - cpu_t[k]) / max(abs(cpu_t[k]), 1e-12)
               for k in ("cropping_coarse", "cropping_dense", "dense", "noise_loss"))
    print(f"[pretask card vs cpu] B={bsz}: loss terms within rel {diff:.3g} (rtol 1e-3, "
          f"atol 2e-3); trainable grad norm card {card_g:.6g}, cpu {cpu_g:.6g} "
          f"(rtol 1e-2) ({card})", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    from upp_torch import resolve_device
    from upp_torch.ops import cuda_build
    from upp_torch.train.pipeline import corrupt_batch
    from upp_torch.train.runner_cls import init_model, make_eval_step
    from upp_torch.utils.config import cfg_from_yaml_file

    device = resolve_device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[card] {kind}; nvidia-smi: {card}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)

    # 1. build
    t0 = time.time()
    usage = cuda_build.build(["fps", "knn", "chamfer"])
    print(f"[build] fps.cu + knn.cu + chamfer.cu built in {time.time() - t0:.1f} s "
          f"({card})", flush=True)
    for name, lines in usage.items():
        for kernel in lines.split("; "):
            print(f"[ptxas] {name}.cu {kernel}", flush=True)

    clouds_np = synthetic_clouds(B)
    clouds = torch.from_numpy(clouds_np).to(device)

    # 2. kernels vs plain, ties and edges, host cost; 3. kNN backward
    with torch.inference_mode():
        rows = phase_kernels(clouds, card)
        phase_kernel_ties_and_edges(card)
        phase_host_cost(clouds, card)
    phase_knn_backward(clouds, card)

    config = cfg_from_yaml_file(CFG)
    args = type("Args", (), {"seed": SEED, "normalize": False})()
    model = init_model(args, config, device)

    # 4. clean eval
    eval_step = make_eval_step(model, config, args)
    reset_counts()
    with Recorder() as rec:
        preds = eval_step(clouds)
        torch.cuda.synchronize()
    clean_counts = check_calls("clean eval", rec, CLEAN_CALLS)
    if preds.shape != (B,) or not ((preds >= 0) & (preds < config.model.cls_dim)).all():
        raise AssertionError(f"clean eval: bad predictions {preds}")
    clean_ms = cuda_ms(lambda: eval_step(clouds), reps=3, warmup=1)
    print(f"[clean eval] launches {clean_counts}; {clean_ms:.2f} ms/batch, "
          f"{B / clean_ms * 1e3:.1f} clouds/s (B={B}; {card})", flush=True)

    # 5. robust inference
    gen = torch.Generator(device=device).manual_seed(SEED)

    def robust_step(pts, bsz_gen):
        with torch.inference_mode():
            points = corrupt_batch(
                pts, npoints=NPOINTS, n_points_dataset=N_POINTS, noisy_train=True,
                incomplete_cropping=True, augmentation=None, generator=bsz_gen)
            return points, model(points, denoise=True, completion_prompt=True,
                                 point_num=NPOINTS)

    reset_counts()
    with Recorder() as rec:
        points, logits = robust_step(clouds, gen)
        torch.cuda.synchronize()
    robust_counts = check_calls("robust inference", rec, ROBUST_CALLS)
    if points.shape != (B, NPOINTS + 72, 3):
        raise AssertionError(f"corrupt_batch: shape {tuple(points.shape)}")
    if logits.shape != (B, config.model.cls_dim) or not torch.isfinite(logits).all():
        raise AssertionError("robust inference: logits not finite / wrong shape")
    torch.cuda.reset_peak_memory_stats()
    robust_ms = cuda_ms(lambda: robust_step(clouds, gen), reps=3, warmup=1)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[robust] launches of one step {robust_counts}; {robust_ms:.2f} ms/batch, "
          f"{B / robust_ms * 1e3:.1f} clouds/s, peak {peak_gib:.2f} GiB "
          f"(B={B}; {card})", flush=True)
    profile_steps(lambda: robust_step(clouds, gen), "robust", robust_ms, card)

    # 6. card vs CPU
    small = clouds[:B_CPU]
    points_c, logits_c = robust_step(small, torch.Generator(device=device).manual_seed(SEED + 1))
    cpu_model = init_model(args, config, torch.device("cpu"))
    with torch.inference_mode():
        logits_h = cpu_model(points_c.cpu(), denoise=True, completion_prompt=True,
                             point_num=NPOINTS)
    diff = (logits_c.cpu() - logits_h).abs().max().item()
    if not torch.allclose(logits_c.cpu(), logits_h, rtol=1e-3, atol=2e-3):
        raise AssertionError(f"card vs CPU: logits differ by {diff}")
    if not torch.equal(logits_c.argmax(-1).cpu(), logits_h.argmax(-1)):
        raise AssertionError("card vs CPU: argmax differs")
    print(f"[card vs cpu] B={B_CPU}: max |logit diff| {diff:.3g} "
          f"(rtol 1e-3, atol 2e-3), argmax equal", flush=True)

    # 7-8. pretask train and eval, 9. pretask card vs CPU
    pretask_config = cfg_from_yaml_file(PRETASK_CFG)
    pretask_counts = phase_pretask(clouds, pretask_config, card, device)
    phase_pretask_card_vs_cpu(clouds, pretask_config, card, device)

    kernels = [kernel_entry("fps", rows, ROBUST_CALLS, robust_counts["fps"]),
               kernel_entry("knn", rows, ROBUST_CALLS, robust_counts["knn"]),
               kernel_entry("chamfer", rows, PRETASK_TRAIN_CALLS, pretask_counts["chamfer"])]
    print("[kernels] ms/plain_ms/bound_ms/launches: fps and knn summed over one robust "
          f"inference step (B={B}), chamfer over one pretask train step (B={B_PRETASK}); "
          f"{card}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
