"""Hyperparameter sweep driver of the port (counterpart of the root
``hyperparam_probing.py``; the reference's passed a nonexistent ``--peft``
flag, SURVEY.md §2.7, fixed there and here to ``--peft_model``). Runs short
PEFT trainings of ``python -m upp_torch.main`` across a grid of learning
rates and downstream prompt counts, each from a trial config written to a
temporary file and removed after it:

    python -m upp_torch.hyperparam_probing [--config ...] [--ckpts ...] \
        [--lrs ...] [--prompt_nums ...] [--max_epoch N] [--dry_run]"""

from __future__ import annotations

import argparse
import itertools
import os
import subprocess
import sys
import tempfile

import yaml


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="cfgs/unify_modelnet_cls.yaml")
    ap.add_argument("--ckpts", default=None)
    ap.add_argument("--lrs", nargs="+", type=float, default=[5e-4, 2e-4, 1e-3])
    ap.add_argument("--prompt_nums", nargs="+", type=int, default=[5, 10, 20])
    ap.add_argument("--max_epoch", type=int, default=30)
    ap.add_argument("--dry_run", action="store_true", help="print the commands, run none")
    args = ap.parse_args(argv)

    base = yaml.load(open(args.config), Loader=yaml.FullLoader)
    for lr, pnum in itertools.product(args.lrs, args.prompt_nums):
        cfg = dict(base)
        cfg["optimizer"]["kwargs"]["lr"] = lr
        cfg["model"]["prompter_config"]["downstream_prompts_num"] = pnum
        cfg["max_epoch"] = args.max_epoch
        # the shipped configs' dataset paths are relative to the working
        # directory, so the trial file may live anywhere; a crashed sweep
        # leaves nothing under cfgs/
        with tempfile.NamedTemporaryFile("w", suffix=".yaml", delete=False) as f:
            yaml.dump(cfg, f)
            path = f.name
        try:
            cmd = [sys.executable, "-m", "upp_torch.main", "--peft_model", "--config", path,
                   "--exp_name", f"probe-lr{lr}-p{pnum}"]
            if args.ckpts:
                cmd += ["--ckpts", args.ckpts]
            print("->", " ".join(cmd), flush=True)
            if not args.dry_run:
                subprocess.run(cmd, check=True)
        finally:
            os.unlink(path)


if __name__ == "__main__":
    main()
