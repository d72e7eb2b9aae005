"""upp_torch launcher, CLI-compatible with the JAX package's ``main.py``:

    python -m upp_torch.main --config cfgs/pretask_synthetic.yaml          (prompter pretraining)
    python -m upp_torch.main --test --config cfgs/pretask_synthetic.yaml   (its 8-viewpoint eval)
    python -m upp_torch.main --peft_model --config cfgs/unify_synthetic_cls.yaml \
        [--ckpts <pretask ckpt-best.pth>] [--joint_optimization 250]      (PEFT training)
    python -m upp_torch.main --test --vote --peft_model --config cfgs/unify_synthetic_cls.yaml \
        --ckpts <ckpt-best.pth>                                          (test, 10-vote test)
    python -m upp_torch.main --peft_model --config cfgs/unify_shapenetpart_seg.yaml \
        [--ckpts <ckpt.pth>]                                             (UPP part segmentation)
    python -m upp_torch.main --finetune_model --config cfgs/finetune_shapenetpart_seg.yaml
                                                                         (full fine-tune seg)
    python -m upp_torch.main --test --peft_model --config cfgs/unify_shapenetpart_seg.yaml \
        --ckpts <ckpt-best.pth>                                          (seg test: mIoU)
    python -m upp_torch.main --config cfgs/pretrain_synthetic.yaml      (MAE pretraining)
    python -m upp_torch.main --finetune_model --config cfgs/finetune_modelnet_cls.yaml \
        --ckpts <pretrain ckpt-last.pth>                                 (full fine-tune)
    python -m upp_torch.main --test --finetune_model --config cfgs/finetune_modelnet_cls.yaml \
        --ckpts <ckpt-best.pth>                                          (its test)

Data-parallel over N cards (one process each):

    python -m torch.distributed.run --standalone --nproc_per_node N \
        -m upp_torch.main --launcher pytorch --peft_model --config ...

Each rank takes ``total_bs // N`` clouds of every batch (``extra_train``:
twice that), draws for the global batch and keeps its rows, normalises with
the global batch's BatchNorm statistics and averages the gradients, so N
ranks take the step one process takes on the ``total_bs`` clouds; rank 0
writes the run's directory, logs, metrics and checkpoints.

Runs on CUDA unless ``--device cpu``; ``--deterministic`` makes a run on the
card repeat bit for bit (torch's deterministic algorithms in place of the
atomic scatter-adds of the backwards; an op without one warns). Ported: training and ``--test`` of
classification configs (``--peft_model`` and ``--finetune_model``, for the
models the port has, ``PointTransformer`` among them), of pretask configs
and of segmentation configs (``Point_MAE_unify_seg``,
``PointTransformer_seg``), and MAE pretraining (``task: pretrain``,
``Point_MAE``, with the SVM probe when the config has an ``extra_train``
split); dispatch as the reference's ``main.py:75-103``. Training runs get
the JSONL (and, where tensorboardX imports, TensorBoard) writers under
``args.tfboard_path``."""

from __future__ import annotations

import os


def main(argv=None):
    from .parallel.dist import broadcast_object, init_dist
    from .utils.parser import get_args

    args = get_args(argv)
    if args.deterministic:
        # read when cuBLAS starts, so before the first CUDA call
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        import torch
        torch.use_deterministic_algorithms(True, warn_only=True)
    if args.launcher != "pytorch":
        return _run(args, rank=0, world=1)
    import torch.distributed as dist
    args.device = str(init_dist(args.launcher, args.device))
    try:
        # ranks started a second apart stamp different times: take rank 0's
        args.experiment_path, args.tfboard_path = broadcast_object(
            (args.experiment_path, args.tfboard_path))
        return _run(args, rank=dist.get_rank(), world=dist.get_world_size())
    finally:
        dist.destroy_process_group()


def _run(args, rank: int, world: int):
    from .utils.config import get_config, log_args_to_file, log_config_to_file
    from .utils.logger import get_root_logger
    from .utils.parser import make_run_dirs
    from .utils.writer import make_writers

    if rank == 0:
        make_run_dirs(args)
    logger = get_root_logger(
        log_file=os.path.join(args.experiment_path, f"{args.log_name}.log"),
        name=args.log_name)
    config = get_config(args, logger=logger)
    task = config.get("task", "classification")
    # per-split batch sizes from total_bs (reference main.py:46-60), per
    # rank total_bs // world (the JAX main.py:50): the pretask test sweeps
    # one sample at a time for its per-taxonomy table; extra_train, the SVM
    # probe's feature split, runs inference only and takes twice the batch
    per_rank = max(int(config.total_bs) // world, 1)
    for split in ("train", "val", "test", "extra_train"):
        if split in config.dataset:
            config.dataset[split].others.bs = (
                1 if task == "pretask" and split == "test"
                else 2 * per_rank if split == "extra_train"
                else per_rank)
            # the few-shot split comes from --way/--shot/--fold (the JAX
            # main.py:65-73; the reference parses them and drops them)
            if config.dataset[split]._base_.get("NAME") == "ModelNetFewShot":
                for k in ("way", "shot", "fold"):
                    v = getattr(args, k, None)
                    if v is not None and v >= 0:
                        config.dataset[split].others[k] = v
    log_args_to_file(args, "args", logger=logger)
    log_config_to_file(config, "config", logger=logger)

    from .train import runner_cls, runner_pretask, runner_pretrain, runner_seg
    if args.test:
        if task == "segmentation":
            return runner_seg.test_net(args, config, unify=args.peft_model)
        if task == "pretask":
            return runner_pretask.test_net(args, config)
        if task == "classification":
            return runner_cls.test_net(args, config)
    else:
        writers = make_writers(args)
        if task == "classification":
            run = runner_cls.finetune_run_net if args.finetune_model else runner_cls.run_net
            return run(args, config, *writers)
        if task == "segmentation":
            run = runner_seg.finetune_run_net if args.finetune_model else runner_seg.run_net
            return run(args, config, *writers)
        if task == "pretask":
            return runner_pretask.run_net(args, config, *writers)
        if task == "pretrain":
            return runner_pretrain.run_net(args, config, *writers)
    raise NotImplementedError(f"upp_torch does not run {'--test of ' * args.test}task "
                              f"{task!r} (ported: classification, pretask, segmentation; "
                              "pretrain training)")


if __name__ == "__main__":
    main()
