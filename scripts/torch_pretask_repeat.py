"""Does the port's pretask train step repeat bit for bit on a CUDA card, which
op does not, and where does the step's time go? Run from the repo root:

    python3 scripts/torch_pretask_repeat.py

1. repeat: two fresh seeded set-ups of the pretask path (``chip_smoke.py``'s
   ``pretask_setup``, full width, batch 64, the same clouds and draws) take
   3 steps each; their loss terms are compared bit for bit, first with the
   default algorithms, then under
   ``torch.use_deterministic_algorithms(True, warn_only=True)``.
2. ops: each scatter-add of the step's backward, run twice on the same
   inputs at the step's shapes: ``knn_backward`` (its ``index_add_``) and
   the backward of ``index_points`` (a gather's backward accumulates).
3. time: three windows of 10 steps (CUDA events), then ``torch.profiler``
   over 5 steps: the device's busy time per step (the kernels' self device
   time) against the wall time per step.
"""

from __future__ import annotations

import os
import sys
import time
import warnings

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

sys.path.insert(0, ".")

STEPS = 3


def repeat_steps(clouds, config, device):
    """Loss terms of ``STEPS`` steps from a fresh seeded set-up."""
    from chip_smoke import B_PRETASK, pretask_setup
    _, _, train_step, _ = pretask_setup(config, device)
    gt = clouds[:B_PRETASK]
    return [{k: float(v) for k, v in train_step(gt).items()} for _ in range(STEPS)]


def phase_repeat(clouds, config, device):
    for deterministic in (False, True):
        torch.use_deterministic_algorithms(deterministic, warn_only=True)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            runs = [repeat_steps(clouds, config, device) for _ in range(2)]
        torch.use_deterministic_algorithms(False)
        for i, (a, b) in enumerate(zip(*runs)):
            diff = {k: a[k] - b[k] for k in a if a[k] != b[k]}
            print(f"[repeat] deterministic={deterministic} step {i}: "
                  + ("bit-equal" if not diff else f"differs {diff}"), flush=True)
        ops = sorted({str(w.message).split(" does not have")[0] for w in caught
                      if "deterministic" in str(w.message)})
        print(f"[repeat] deterministic={deterministic}: ops without a deterministic "
              f"version: {ops or 'none'}", flush=True)


def _twice(name, fn):
    a, b = fn(), fn()
    same = all(torch.equal(x, y) for x, y in zip(a, b))
    err = max((x - y).abs().max().item() for x, y in zip(a, b))
    print(f"[ops] {name}: " + ("bit-equal" if same else f"differs by up to {err:.3g}"),
          flush=True)


def phase_ops(clouds):
    from chip_smoke import B_PRETASK
    from upp_torch.ops import knn_cuda
    from upp_torch.ops.chamfer import nn_both
    from upp_torch.ops.geometry import index_points
    from upp_torch.ops.knn import knn_backward
    gen = torch.Generator(device=clouds.device).manual_seed(5)
    for s, n, k in ((32, 32, 6), (32, 1024, 16), (52, 1024, 4)):
        points = clouds[:B_PRETASK, :n].contiguous()
        query = (clouds[:B_PRETASK, n:n + s] * 0.9).contiguous()
        _, idx, nbr = knn_cuda.knn(query, points, k, True)
        g_d = torch.randn(idx.shape, generator=gen, device=points.device)
        g_nb = torch.randn(nbr.shape, generator=gen, device=points.device)
        _twice(f"knn_backward {s}x{n} k{k}",
               lambda: knn_backward(query, points, idx.long(), nbr, g_d, g_nb))
    for n, m in ((32, 1024), (1024, 1024), (2048, 8192)):
        x = torch.roll(clouds[:B_PRETASK], 1, 0)[:, :n].contiguous()
        y = clouds[:B_PRETASK, :m].contiguous()
        _, i1, _, i2 = nn_both(x, y)
        for name, src, idx in (("y[i1]", y, i1), ("x[i2]", x, i2)):
            g = torch.randn(idx.shape + (3,), generator=gen, device=x.device)

            def grad(src=src, idx=idx, g=g):
                p = src.clone().requires_grad_(True)
                return torch.autograd.grad(index_points(p, idx.long()), p, g)
            _twice(f"index_points backward {name} at Chamfer {n}x{m}", grad)


def phase_time(clouds, config, device, card):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import B_PRETASK, cuda_ms, pretask_setup
    _, _, train_step, _ = pretask_setup(config, device)
    gt = clouds[:B_PRETASK]
    windows = [cuda_ms(lambda: train_step(gt), reps=10, warmup=1) for _ in range(3)]
    print("[time] ms/step over three windows of 10 steps: "
          + ", ".join(f"{w:.2f}" for w in windows) + f" (B={B_PRETASK}; {card})", flush=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            train_step(gt)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / 5

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
    # the device's own events (kernels, copies); a CPU op's device time and a
    # user annotation's range on the device (Optimizer.step) repeat them
    events = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                     and not getattr(e, "is_user_annotation", False)
                     and not e.key.startswith("Optimizer.")), key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in events) / 1e3 / 5
    plain_ms = sum(windows) / len(windows)
    print(f"[profile] 5 steps: device busy {busy_ms:.2f} ms/step; wall {wall_ms:.2f} ms/step "
          f"profiled (idle share {1 - busy_ms / wall_ms:.3f}), {plain_ms:.2f} unprofiled "
          f"(idle share {1 - busy_ms / plain_ms:.3f}) (B={B_PRETASK}; {card})", flush=True)
    for e in events[:12]:
        print(f"[profile]   {dev_us(e) / 1e3 / 5:8.3f} ms/step  {e.count // 5:5d} calls/step  "
              f"{e.key[:90]}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_pretask_repeat: needs a CUDA card", file=sys.stderr)
        return 1
    from chip_smoke import B, PRETASK_CFG, card_line, synthetic_clouds
    from upp_torch import resolve_device
    from upp_torch.utils.config import cfg_from_yaml_file
    device = resolve_device("cuda")
    card = card_line()
    print(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    clouds = torch.from_numpy(synthetic_clouds(B)).to(device)
    config = cfg_from_yaml_file(PRETASK_CFG)
    phase_repeat(clouds, config, device)
    phase_ops(clouds)
    phase_time(clouds, config, device, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
