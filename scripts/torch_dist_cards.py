#!/usr/bin/env python3
"""Data parallelism over NCCL with a rank on each card of one host:

    python3 scripts/torch_dist_cards.py        # needs two cards or more

1. the checks of ``chip_smoke.py`` phases 26-27 with a rank on each card
   (``chip_smoke.dist_ranks``): the cls PEFT step at batch 120 without and
   with the noisy passes, the joint step and the pretrain step at batch 128,
   each held to one process's step on card 0 at ``chip_smoke.DIST_TOL``,
   the ranks equal bit for bit; collectives and ms per step;
2. ``chip_smoke.py``'s phase 13 (the cls CLI on 48 synthetic clouds a
   split, batch 24, epochs 0-2 with the joint switch after epoch 1, then
   ``--test --vote --ckpts``) in this process on card 0, then the same
   training under ``python -m torch.distributed.run --standalone
   --nproc_per_node N -m upp_torch.main --launcher pytorch`` and a
   one-process ``--test --vote --ckpts`` of its ``ckpt-best.pth``: one run
   directory, a rank's batch of ``24 // N``, epoch times, validation, test
   and vote accuracy.

Prints each result with the card's name and power limit; exits non-zero
with fewer than two cards or when a check fails.
"""

from __future__ import annotations

import glob
import os
import re
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402


def cli_over_cards(card, n):
    from upp_torch.main import main as upp_main
    exp = f"chip_smoke_{n}cards"
    t0 = time.time()
    cs._run_children([(f"cli_{n}cards",
                       [sys.executable, "-m", "torch.distributed.run", "--standalone",
                        "--nproc_per_node", str(n), "-m", "upp_torch.main", "--launcher",
                        "pytorch", "--peft_model", "--config",
                        os.path.join(cs.CLI_DIR, "cls_cli_train.yaml"),
                        "--joint_optimization", "1", "--exp_name", exp], cs._child_env())],
                     timeout=600)
    train_s = time.time() - t0
    runs = glob.glob(f"experiments/cls_cli_train/plain-network/peft-{exp}/*")
    if len(runs) != 1:
        raise AssertionError(f"{n} cards: run directories {runs}")
    log = open(os.path.join(runs[0], "cls_cli_train.log")).read()
    epochs = re.findall(r"EPOCH: (\d+) EpochTime = ([\d.]+)", log)
    val = re.findall(r"\[Validation\] EPOCH: (\d+)\s+acc = ([\d.]+)", log)
    bs = re.findall(r"config\.dataset\.train\.others\.bs : (\d+)", log)
    if (len(epochs) != 3 or bs != [str(cs.CLI_BS // n)] or "[joint optimization] switching"
            not in log or not os.path.exists(os.path.join(runs[0], "ckpt-best.pth"))):
        raise AssertionError(f"{n} cards: epochs {epochs}, batch {bs}, log tail {log[-2000:]}")
    t0 = time.time()
    acc = upp_main(["--test", "--vote", "--peft_model", "--config",
                    os.path.join(cs.CLI_DIR, "cls_cli_test.yaml"), "--ckpts",
                    os.path.join(runs[0], "ckpt-best.pth"), "--exp_name", exp])
    test_s = time.time() - t0
    print(f"[cli over {n} cards] torchrun --nproc_per_node {n} --launcher pytorch (NCCL): a "
          f"rank's batch {bs[0]}; epoch times (s) {', '.join(f'{e}: {t}' for e, t in epochs)}; "
          f"validation acc {', '.join(f'{e}: {a}' for e, a in val)}; {train_s:.1f} s of wall "
          f"time with the start; one process --test --vote --ckpts ckpt-best.pth: acc "
          f"{acc:.4f}, {test_s:.1f} s ({card})", flush=True)


def main() -> int:
    n = torch.cuda.device_count()
    if n < 2:
        print(f"torch_dist_cards: {n} card(s); NCCL data parallelism needs two or more",
              file=sys.stderr)
        return 1
    from upp_torch import resolve_device
    from upp_torch.ops import cuda_build
    device = resolve_device("cuda")
    cuda_build.build(["fps", "knn", "chamfer"])
    card = cs.card_line()
    print(f"[cards] {n} x {torch.cuda.get_device_name(0)}; nvidia-smi: {card}", flush=True)
    cs.dist_ranks(f"dist nccl {n} cards", "nccl", list(range(n)), cs.dist_steps(device), card)
    cs.phase_cls_cli(card)
    cli_over_cards(card, n)
    return 0


if __name__ == "__main__":
    sys.exit(main())
