"""CLI argument surface — flag-compatible with the reference
(``utils/parser.py:5-127``). ``--launcher pytorch`` runs one rank of a
data-parallel run that ``torchrun`` started (``parallel.dist.init_dist``);
``--sync_bn`` is accepted and changes nothing, since BatchNorm always takes
the global batch's statistics, as in the JAX package. ``--device`` names the
device (CUDA unless told otherwise), and ``--test`` without ``--ckpts``
evaluates a model from a seeded init. ``get_args`` names the run's
directories; ``make_run_dirs`` creates them."""

from __future__ import annotations

import argparse
import os
import time
from pathlib import Path


def get_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str,
                        default="cfgs/unify_modelnet_cls.yaml",
                        help="yaml config file")
    parser.add_argument("--launcher", choices=["none", "pytorch"],
                        default="none",
                        help="'pytorch': one rank of a data-parallel run started by "
                             "torchrun (python -m torch.distributed.run); each rank "
                             "takes total_bs // world_size clouds of every batch")
    parser.add_argument("--local_rank", type=int,
                        default=int(os.environ.get("LOCAL_RANK", 0)),
                        help="this rank's card; torchrun's LOCAL_RANK by default")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cpu' runs the plain versions "
                             "of the kernels")
    parser.add_argument("--num_workers", type=int, default=4)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--deterministic", action="store_true", default=False,
                        help="repeatable runs on the card: torch's deterministic "
                             "algorithms (an op without one warns)")
    parser.add_argument("--sync_bn", action="store_true", default=False,
                        help="accepted and unneeded: BatchNorm always normalises "
                             "with the global batch's statistics")
    parser.add_argument("--exp_name", type=str, default="retrain")
    parser.add_argument("--loss", type=str, default="cd2")
    parser.add_argument("--start_ckpts", type=str, default=None)
    parser.add_argument("--ckpts", type=str, default=None,
                        help="reference-format torch .pth to load")
    parser.add_argument("--val_freq", type=int, default=1)
    parser.add_argument("--incomplete_cropping", action="store_true", default=True)
    parser.add_argument("--incomplete_shape", action="store_true", default=True)
    parser.add_argument("--shape_generate", action="store_true", default=True)
    parser.add_argument("--cropping_rate", type=float, default=0.1)
    parser.add_argument("--noise", action="store_true", default=True)
    parser.add_argument("--rectify", action="store_true", default=False)
    parser.add_argument("--noise_radius", type=float, default=0.8)
    parser.add_argument("--deviation", type=float, default=0.1)
    parser.add_argument("--noise_type", nargs="+",
                        choices=["gaussian_noise", "lidar_noise"],
                        default=["gaussian_noise", "lidar_noise"])
    parser.add_argument("--finetune_model", action="store_true", default=False)
    parser.add_argument("--peft_model", action="store_true", default=True)
    parser.add_argument("--joint_optimization", type=int, default=250)
    parser.add_argument("--normalize", action="store_true", default=False)
    parser.add_argument("--vote", action="store_true", default=False)
    parser.add_argument("--resume", action="store_true", default=False)
    parser.add_argument("--test", action="store_true", default=False)
    parser.add_argument("--mode", choices=["easy", "median", "hard", None],
                        default=None)
    parser.add_argument("--way", type=int, default=5)
    parser.add_argument("--shot", type=int, default=10)
    parser.add_argument("--fold", type=int, default=9)

    args = parser.parse_args(argv)

    if args.test and args.resume:
        raise ValueError("--test and --resume cannot be both activate")
    if args.resume and args.start_ckpts is not None:
        raise ValueError("--resume and --start_ckpts cannot be both activate")

    if args.finetune_model:
        args.exp_name = "finetune-" + args.exp_name
    if args.peft_model and not args.finetune_model:
        args.exp_name = "peft-" + args.exp_name
    if args.test:
        args.exp_name = "test-" + args.exp_name
    if args.mode is not None:
        args.exp_name = args.exp_name + "-" + args.mode

    # experiment dir layout: experiments/<cfg>/<ckpt>/<exp>/<timestamp>
    # (utils/parser.py:107-117)
    ckpt_stem = (os.path.splitext(os.path.basename(args.ckpts))[0]
                 if args.ckpts else "plain-network")
    base = os.path.join("./experiments", Path(args.config).stem, ckpt_stem,
                        args.exp_name)
    timestamp = time.strftime("%Y%m%d_%H%M%S", time.localtime())
    args.experiment_path = os.path.join(base, timestamp)
    args.tfboard_path = os.path.join("./experiments", "TFBoard",
                                     Path(args.config).stem, ckpt_stem,
                                     args.exp_name)
    args.log_name = Path(args.config).stem
    return args


def make_run_dirs(args) -> None:
    """Create the run's experiment and TensorBoard directories."""
    os.makedirs(args.experiment_path, exist_ok=True)
    os.makedirs(args.tfboard_path, exist_ok=True)
