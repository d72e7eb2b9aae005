"""upp_torch launcher, CLI-compatible with the JAX package's ``main.py``:

    python -m upp_torch.main --test --peft_model --config cfgs/unify_synthetic_cls.yaml
    python -m upp_torch.main --config cfgs/pretask_synthetic.yaml          (prompter pretraining)
    python -m upp_torch.main --test --config cfgs/pretask_synthetic.yaml   (its 8-viewpoint eval)

Runs on CUDA unless ``--device cpu``. Ported so far: ``--test`` of
classification configs, and training and ``--test`` of pretask configs;
classification training is the next slice."""

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
    task = config.get("task", "classification")
    # per-split batch sizes from total_bs (reference main.py:46-60); the
    # pretask test sweeps one sample at a time for its per-taxonomy table
    for split in ("train", "val", "test"):
        if split in config.dataset:
            config.dataset[split].others.bs = (
                1 if task == "pretask" and split == "test" else int(config.total_bs))
    log_args_to_file(args, "args", logger=logger)
    log_config_to_file(config, "config", logger=logger)

    from .train import runner_cls, runner_pretask
    if task == "pretask":
        return (runner_pretask.test_net if args.test else runner_pretask.run_net)(args, config)
    if task == "classification" and args.test:
        return runner_cls.test_net(args, config)
    raise NotImplementedError(f"upp_torch does not run {'--test of ' if args.test else ''}"
                              f"task {task!r} yet (classification training is the next slice)")


if __name__ == "__main__":
    main()
