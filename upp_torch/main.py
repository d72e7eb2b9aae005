"""upp_torch launcher, CLI-compatible with the JAX package's ``main.py``:

    python -m upp_torch.main --test --peft_model --config cfgs/unify_synthetic_cls.yaml

Runs on CUDA unless ``--device cpu``. Only ``--test`` (classification) is
ported so far; training arrives with the next slice."""

from __future__ import annotations

import os


def main(argv=None):
    from .utils.config import get_config, log_args_to_file, log_config_to_file
    from .utils.logger import get_root_logger
    from .utils.parser import get_args

    args = get_args(argv)
    logger = get_root_logger(
        log_file=os.path.join(args.experiment_path, f"{args.log_name}.log"),
        name=args.log_name)
    config = get_config(args, logger=logger)
    # per-split batch sizes from total_bs (reference main.py:46-60)
    for split in ("train", "val", "test"):
        if split in config.dataset:
            config.dataset[split].others.bs = int(config.total_bs)
    log_args_to_file(args, "args", logger=logger)
    log_config_to_file(config, "config", logger=logger)

    if not args.test or config.get("task", "classification") != "classification":
        raise NotImplementedError("upp_torch runs --test of classification "
                                  "configs; training arrives with the next slice")
    from .train import runner_cls
    return runner_cls.test_net(args, config)


if __name__ == "__main__":
    main()
