#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (``upp_torch``) once on a CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build the CUDA kernels from ``upp_torch/csrc`` (one nvcc per source,
     in parallel) and print the build time;
  2. hold each kernel against its plain PyTorch version on the card at
     every shape the main path gives it (batch 120): FPS indices equal, kNN
     indices equal and distances within 1e-6; time kernel and plain;
  3. clean eval: ``make_eval_step`` (FPS 8192→1024, downstream pass, argmax)
     at full width on 120 synthetic 8192-point clouds, seeded weights;
  4. robust inference: ``corrupt_batch`` (viewpoint crop 8192→1024, +48
     lidar, +24 shell points) then the 3-pass ``PointMAEUnify`` at full
     width, batch 120: finite logits, launch counts of one step, time;
  5. card vs CPU: the same weights and corrupted input at batch 8 through
     the kernels on the card and the plain versions on the CPU: logits
     within rtol 1e-3 / atol 2e-3, equal argmax.
Launch counts are reset right before each path run (3, 4) and read right
after; the kernel-vs-plain comparisons do not count. Before the last line it
prints the ``kernels`` JSON line and the card's name and power limit; the
last line is the ``{"ok": true, "device": ...}`` JSON object.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from collections import Counter

import numpy as np
import torch

CFG = "cfgs/unify_synthetic_cls.yaml"
B = 120                 # the flagship's batch
B_CPU = 8               # card-vs-CPU comparison batch
N_POINTS = 8192
NPOINTS = 1024
SEED = 0
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
F32_FLOP_PER_S = 67e12        # H100 SXM data sheet, float32 outside tensor cores

# every kernel call of one step at batch 120, with its count per step:
# ("fps", N, n_samples, masked) / ("knn", S, N, k, gather)
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


class Recorder:
    """Counts the kernel calls of a path run by shape, around the wrappers.
    The wrappers' own launch counters are what the run reports: a wrapper
    increments its counter through its module-level name, which points at
    the recording stand-in here, so the stand-in carries the counter and
    hands it back on exit."""

    def __init__(self):
        from upp_torch.ops import fps_cuda, knn_cuda
        self.mods = (fps_cuda, knn_cuda)
        self.orig = (fps_cuda.fps_idx, knn_cuda.knn)
        self.calls = Counter()

    def __enter__(self):
        fps_cuda, knn_cuda = self.mods
        f0, k0 = self.orig

        def fps_rec(xyz, n_samples, valid=None, start_idx=None):
            self.calls[("fps", xyz.shape[1], n_samples, valid is not None)] += 1
            return f0(xyz, n_samples, valid, start_idx)

        def knn_rec(query, points, k, gather):
            self.calls[("knn", query.shape[1], points.shape[1], k, gather)] += 1
            return k0(query, points, k, gather)

        fps_rec.launches, knn_rec.launches = f0.launches, k0.launches
        fps_cuda.fps_idx, knn_cuda.knn = fps_rec, knn_rec
        return self

    def __exit__(self, *exc):
        (f0, k0), (fps_cuda, knn_cuda) = self.orig, self.mods
        f0.launches, k0.launches = fps_cuda.fps_idx.launches, knn_cuda.knn.launches
        fps_cuda.fps_idx, knn_cuda.knn = f0, k0


def reset_counts():
    from upp_torch.ops import fps_cuda, knn_cuda
    fps_cuda.fps_idx.launches = 0
    knn_cuda.knn.launches = 0


def read_counts():
    from upp_torch.ops import fps_cuda, knn_cuda
    return {"fps": fps_cuda.fps_idx.launches, "knn": knn_cuda.knn.launches}


def bound_parts(call, bsz):
    """(bytes, operations) the call must move and do: inputs read once,
    outputs written once; 10 float32 operations per (point, round) of FPS
    (3 sub, 3 mul, 2 add, min, compare) and per (query, point) pair of kNN
    (3 sub, 3 mul, 2 add, compare against the k-th, plus the select)."""
    if call[0] == "fps":
        _, n, s, masked = call
        nbytes = bsz * n * 12 + bsz * s * 4 + (bsz * n + bsz * 4 if masked else 0)
        return nbytes, 10 * bsz * s * n
    _, s, n, k, gather = call
    nbytes = bsz * (s * 12 + n * 12 + s * k * 8 + (s * k * 12 if gather else 0))
    return nbytes, 10 * bsz * s * n


def phase_kernels(clouds, card):
    """Kernel vs plain on the card at every path shape. Returns per-shape
    rows."""
    from upp_torch.ops import fps_cuda, knn_cuda
    from upp_torch.ops.corrupt import _crop_masks
    from upp_torch.ops.fps import fps_plain_idx
    from upp_torch.ops.geometry import index_points
    from upp_torch.ops.knn import knn_plain

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for call in sorted(set(CLEAN_CALLS) | set(ROBUST_CALLS)):
        if call[0] == "fps":
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
        else:
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
        nbytes, ops = bound_parts(call, B)
        rows.append({"call": list(call), "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "bytes": nbytes, "ops": ops})
        print(f"[kernel] {call}: max_abs_err {err:.3g}, kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms (B={B}; {card})", flush=True)
    return rows


def check_calls(name, rec, want):
    got = Counter({k: v for k, v in rec.calls.items()})
    if got != want:
        raise AssertionError(f"{name}: kernel calls {dict(got)} != expected {dict(want)}")


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
    cuda_build.build(["fps", "knn"])
    print(f"[build] fps.cu + knn.cu built in {time.time() - t0:.1f} s ({card})",
          flush=True)

    clouds_np = synthetic_clouds(B)
    clouds = torch.from_numpy(clouds_np).to(device)

    # 2. kernels vs plain
    with torch.inference_mode():
        rows = phase_kernels(clouds, card)

    config = cfg_from_yaml_file(CFG)
    args = type("Args", (), {"seed": SEED, "normalize": False})()
    model = init_model(args, config, device)

    # 3. clean eval
    eval_step = make_eval_step(model, config, args)
    reset_counts()
    with Recorder() as rec:
        preds = eval_step(clouds)
        torch.cuda.synchronize()
    clean_counts = read_counts()
    check_calls("clean eval", rec, CLEAN_CALLS)
    if preds.shape != (B,) or not ((preds >= 0) & (preds < config.model.cls_dim)).all():
        raise AssertionError(f"clean eval: bad predictions {preds}")
    if min(clean_counts.values()) < 1:
        raise AssertionError(f"clean eval launched no kernel: {clean_counts}")
    clean_ms = cuda_ms(lambda: eval_step(clouds), reps=3, warmup=1)
    print(f"[clean eval] launches {clean_counts}; {clean_ms:.2f} ms/batch, "
          f"{B / clean_ms * 1e3:.1f} clouds/s (B={B}; {card})", flush=True)

    # 4. robust inference
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
    robust_counts = read_counts()
    check_calls("robust inference", rec, ROBUST_CALLS)
    if points.shape != (B, NPOINTS + 72, 3):
        raise AssertionError(f"corrupt_batch: shape {tuple(points.shape)}")
    if logits.shape != (B, config.model.cls_dim) or not torch.isfinite(logits).all():
        raise AssertionError("robust inference: logits not finite / wrong shape")
    if min(robust_counts.values()) < 1:
        raise AssertionError(f"robust inference launched no kernel: {robust_counts}")
    torch.cuda.reset_peak_memory_stats()
    robust_ms = cuda_ms(lambda: robust_step(clouds, gen), reps=3, warmup=1)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[robust] launches of one step {robust_counts}; {robust_ms:.2f} ms/batch, "
          f"{B / robust_ms * 1e3:.1f} clouds/s, peak {peak_gib:.2f} GiB "
          f"(B={B}; {card})", flush=True)

    # 5. card vs CPU
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

    kernels = []
    for name, src, replaces in (
            ("fps", "upp_torch/csrc/fps.cu", "upp_tpu/ops/fps_pallas.py:38"),
            ("knn", "upp_torch/csrc/knn.cu", "upp_tpu/ops/knn_pallas.py:48")):
        mine = [(r, ROBUST_CALLS[tuple(r["call"])]) for r in rows
                if r["call"][0] == name and tuple(r["call"]) in ROBUST_CALLS]
        nbytes = sum(r["bytes"] * c for r, c in mine)
        ops = sum(r["ops"] * c for r, c in mine)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / F32_FLOP_PER_S * 1e3
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": robust_counts[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows if r["call"][0] == name),
            "ms": sum(r["ms"] * c for r, c in mine),
            "plain_ms": sum(r["plain_ms"] * c for r, c in mine),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None})
    print("[kernels] ms/plain_ms/bound_ms: sum over one robust step's calls "
          f"(B={B}; {card})")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
