#!/usr/bin/env python3
"""Time the port's single-card train steps on the card, for this tree and,
with ``--parent DIR``, an unpacked checkout of an earlier commit, in turns
(parent, this, this, parent) in one call:

    git archive <commit> | tar -x -C archive/parent
    python3 scripts/torch_step_times.py --parent archive/parent

Each turn is a fresh process whose working directory is the tree's root,
so ``import upp_torch`` is that tree's package (its kernels built into its
own ``build/``). It takes the steps from the tree's ``chip_smoke.py``
(seeded weights, synthetic clouds): the pretrain step at batch 128, the
fine-tune cls step at 40, the cls PEFT step at 120 and the pretask step at
64, then the pretrain and fine-tune steps again after the process has run
``chip_smoke.py``'s cls CLI phase (13) in process, as ``chip_smoke.py``
times them after its earlier phases. For each: ms per step (CUDA events
around 10 steps after a warm-up) and the device's busy ms per step
(``torch.profiler`` over 3 steps, the self device time of its events).
Prints one line per turn and step, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

WORKER = r"""
import json
import torch
import chip_smoke as cs
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from upp_torch import resolve_device
from upp_torch.ops import cuda_build
from upp_torch.utils.config import ConfigDict, cfg_from_yaml_file
from upp_torch.train.runner_cls import PEFT_LIST

device = resolve_device("cuda")
cuda_build.build(["fps", "knn", "chamfer"])
clouds_np, labels_np = cs.synthetic_clouds(cs.B_PRETRAIN)
clouds = torch.from_numpy(clouds_np).to(device)
labels = torch.from_numpy(labels_np).to(device)


def busy_ms(step, steps=3):
    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    return sum(dev_us(e) for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)) / 1e3 / steps


def timed(name, step):
    ms = cs.cuda_ms(step, reps=10, warmup=1)
    print(json.dumps({"step": name, "ms": ms, "busy_ms": busy_ms(step)}), flush=True)


model, step = cs.pretrain_setup(cfg_from_yaml_file(cs.PRETRAIN_CFG), device)
timed("pretrain B=128", lambda: step(clouds))
del model, step
ft = ConfigDict.from_nested(cs.finetune_config())
model, _, step = cs.cls_train_setup(ft, device, None)
timed("finetune cls B=40", lambda: step(clouds[:cs.B_FT], labels[:cs.B_FT]))
del model, step
model, _, step = cs.cls_train_setup(cfg_from_yaml_file(cs.CFG), device, PEFT_LIST)
timed("cls PEFT B=120", lambda: step(clouds[:cs.B], labels[:cs.B]))
del model, step
_, _, step, _ = cs.pretask_setup(cfg_from_yaml_file(cs.PRETASK_CFG), device)
timed("pretask B=64", lambda: step(clouds[:cs.B_PRETASK]))
del step
cs.phase_cls_cli(cs.card_line())
model, step = cs.pretrain_setup(cfg_from_yaml_file(cs.PRETRAIN_CFG), device)
timed("pretrain B=128 after the cls CLI", lambda: step(clouds))
del model, step
model, _, step = cs.cls_train_setup(ft, device, None)
timed("finetune cls B=40 after the cls CLI", lambda: step(clouds[:cs.B_FT], labels[:cs.B_FT]))
"""


def run(tree: Path, label: str):
    out = subprocess.run([sys.executable, "-c", WORKER], cwd=tree, capture_output=True,
                         text=True, timeout=900)
    if out.returncode != 0:
        raise RuntimeError(f"{label} ({tree}): exit {out.returncode}\n{out.stderr[-3000:]}")
    return [json.loads(ln) for ln in out.stdout.splitlines() if ln.startswith('{"step"')]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="an unpacked checkout of the commit to compare with")
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    turns = ([("parent", Path(args.parent)), ("this", REPO), ("this", REPO),
              ("parent", Path(args.parent))] if args.parent else [("this", REPO)])
    for i, (label, tree) in enumerate(turns):
        for r in run(tree.resolve(), label):
            print(f"[step times] turn {i} {label}: {r['step']}: {r['ms']:.2f} ms/step, device "
                  f"busy {r['busy_ms']:.2f} ms/step ({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
