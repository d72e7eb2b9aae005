"""One rank of the two-rank CPU runs of ``tests/test_torch_port_dist.py``
(imports no JAX):

    python tests/torch_dist_worker.py RANK WORLD PORT JOB OUT

``JOB`` is a ``torch.save``'d dict ``{"cases": [...], <case>: {...}}``
written by the test; the rank joins a gloo group on ``127.0.0.1:PORT``
through ``upp_torch.parallel.dist.init_dist``, runs each case and saves its
results to ``OUT.<rank>``. The test runs the same case functions in its own
process as the one-process reference (a world of one: no collective)."""

from __future__ import annotations

import contextlib
import logging
import os
import sys
import types

import numpy as np
import torch

from upp_torch.data import build_dataset_from_cfg
from upp_torch.models import build_model_from_cfg
from upp_torch.models.layers import BatchNorm1d
from upp_torch.parallel import shard
from upp_torch.parallel.dist import COUNTS, all_reduce_sum, gather_samples, get_dist_info
from upp_torch.train import checkpoint, optim, runner_cls, runner_pretask, runner_pretrain
from upp_torch.train import runner_seg
from upp_torch.train.ckpt_io import load_weights
from upp_torch.train.pipeline import AugmentDraws
from upp_torch.utils.config import ConfigDict

CPU = torch.device("cpu")


def my_rows(n: int) -> slice:
    """This rank's block of a global batch of ``n``."""
    rank, world = get_dist_info()
    b = n // world
    return slice(rank * b, (rank + 1) * b)


@contextlib.contextmanager
def default_dtype(dtype):
    old = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        yield
    finally:
        torch.set_default_dtype(old)


def _state(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def case_bn(job):
    """Train-mode ``BatchNorm1d`` on this rank's rows of ``x`` [B, n, C]
    inside the global batch: output, the gradients of ``sum(y * w_out)``
    (the weight's and bias's summed over ranks) and the running statistics."""
    rows = my_rows(job["x"].shape[0])
    bn = BatchNorm1d(job["x"].shape[-1])
    bn.load_state_dict({k: torch.tensor(v) for k, v in job["state"].items()}, strict=False)
    bn.train()
    x = torch.tensor(job["x"][rows]).requires_grad_(True)
    COUNTS.clear()
    with shard.global_batch(shard.this_rank()):
        y = bn(x)
    (y * torch.tensor(job["w_out"][rows])).sum().backward()
    counts = dict(COUNTS)
    return {"y": y.detach().numpy(), "x_grad": x.grad.numpy(),
            "weight_grad": all_reduce_sum(bn.weight.grad).numpy(),
            "bias_grad": all_reduce_sum(bn.bias.grad).numpy(),
            "running_mean": bn.running_mean.numpy(), "running_var": bn.running_var.numpy(),
            "counts": counts}


def _switch(model, stage):
    """The trainable set of a stage: the PEFT list (already set), the joint
    list, or every parameter (``full``)."""
    if stage == "joint":
        optim.set_trainable(model, runner_cls.JOINT_PEFT_LIST)
    elif stage == "full":
        optim.set_trainable(model, None)


def case_cls(job):
    """The cls train step in float64 on this rank's rows of the clouds: one
    PEFT step, then ``set_trainable(JOINT_PEFT_LIST)`` and one joint step
    (``job["stages"]`` may add ``full``, every parameter trainable);
    after each the loss and accuracy, the step's gradients and the whole
    state (parameters and running statistics), and the collectives."""
    config = ConfigDict.from_nested(job["config"])
    args = types.SimpleNamespace(**job["args"])
    rows = my_rows(job["clouds"].shape[0])
    out = {}
    with default_dtype(torch.float64):
        model = runner_cls.init_model(args, config, CPU)
        optim.set_trainable(model, runner_cls.PEFT_LIST)
        opt = optim.build_optimizer(config, model, steps_per_epoch=1)
        step = runner_cls.make_train_step(model, opt, config, args)
        pts = torch.tensor(job["clouds"][rows], dtype=torch.float64)
        labels = torch.tensor(job["labels"][rows])
        for stage in job.get("stages", ("peft", "joint")):
            _switch(model, stage)
            COUNTS.clear()
            m = step(pts, labels)
            out[stage] = {"loss": float(m["loss"]), "acc": float(m["acc"]),
                          "counts": dict(COUNTS), "state": _state(model),
                          "grads": {n: p.grad.clone() for n, p in model.named_parameters()
                                    if p.grad is not None}}
    return out


def case_pretrain(job):
    """The pretrain step on this rank's rows of the clouds, group split and
    augmentation draws, in float32 and float64: loss, gradients, running
    statistics."""
    rows = my_rows(job["clouds"].shape[0])
    config = ConfigDict.from_nested(job["config"])
    out = {}
    for dtype in (torch.float32, torch.float64):
        model = build_model_from_cfg(job["model"])
        model.load_state_dict(job["state"])
        model.to(dtype)
        opt = optim.build_optimizer(config, model, steps_per_epoch=1)
        step = runner_pretrain.make_pretrain_step(model, opt, config,
                                                  types.SimpleNamespace(seed=0))
        draws = AugmentDraws(**{k: torch.tensor(v[rows], dtype=dtype)
                                for k, v in job["draws"].items()})
        masks = tuple(torch.tensor(m[rows]).long() for m in job["masks"])
        m = step(torch.tensor(job["clouds"][rows], dtype=dtype), draws, masks)
        out[str(dtype)] = {
            "loss": float(m["loss"]),
            "grads": {n: p.grad.double() for n, p in model.named_parameters()
                      if p.grad is not None},
            "running": {k: v.clone() for k, v in model.state_dict().items() if "running_" in k}}
    return out


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _logger(name):
    log = logging.getLogger(name)
    log.handlers[:] = [_Lines()]
    log.setLevel(logging.INFO)
    log.propagate = False
    return log, log.handlers[0].lines


def case_eval(job):
    """Each runner's evaluation over this rank's shard of a ``SIZE`` 9 set
    (padded to 10 over two ranks) at batch ``bs`` a rank: cls ``validate``
    and ``test_vote``, seg ``validate``, pretask ``validate`` and
    ``validate_detailed`` (its table's lines), the probe's features; and
    ``gather_samples`` of each rank's (index, index * 10) rows."""
    bs, out = job["bs"], {}
    torch.manual_seed(0)

    def model_of(cfg):
        args = types.SimpleNamespace(seed=job["seed"])
        return runner_cls.init_model(args, ConfigDict.from_nested({"model": cfg}), CPU)

    def loader(split, **kw):
        return runner_cls.sharded_loader(build_dataset_from_cfg(job[split], {"subset": "test"}),
                                         bs, **kw)

    cls_cfg = ConfigDict.from_nested(job["cls_config"])
    args = types.SimpleNamespace(seed=job["seed"], normalize=False)
    model = model_of(job["cls_config"]["model"])
    out["cls_acc"] = runner_cls.validate(runner_cls.make_eval_step(model, cls_cfg, args),
                                         loader("cls_data", prefetch=0), CPU, 0,
                                         logger="silent").acc
    out["vote_acc"] = runner_cls.test_vote(model, loader("cls_data"), cls_cfg, args, CPU,
                                           times=2)

    seg = model_of(job["seg_model"])
    m = runner_seg.validate(runner_seg.make_seg_eval_step(seg, ConfigDict(), True),
                            loader("seg_data"), CPU, 0, logger="silent")
    out["seg"] = {k: m[k] for k in ("accuracy", "class_avg_iou", "instance_avg_iou")}

    pre_cfg = ConfigDict.from_nested(job["pretask_config"])
    step = runner_pretask.make_pretask_eval_step(model_of(job["pretask_config"]["model"]),
                                                 pre_cfg, "easy")
    out["pretask_cd"] = runner_pretask.validate(step, loader("pretask_data"), CPU, 0,
                                                logger="silent").cd
    log, lines = _logger(f"dist_worker_table_{get_dist_info()[0]}")
    runner_pretask.validate_detailed(
        step, build_dataset_from_cfg(job["pretask_data"], {"subset": "test"}), CPU, 0,
        logger=log)
    out["pretask_table"] = lines

    mae = model_of(job["mae_model"])
    out["probe"] = runner_pretrain.probe_features(mae, loader("probe_data"), job["npoints"],
                                                  CPU)
    rank = get_dist_info()[0]
    mine = np.arange(rank, 9, 2) if get_dist_info()[1] > 1 else np.arange(9)
    mine = np.concatenate([mine, [0]]) if rank == 1 else mine      # a padding duplicate
    out["gathered"] = gather_samples(mine, mine * 10)
    return out


def case_ckpt(job):
    """Rank 0 alone writes a checkpoint (each rank names its own directory:
    only rank 0's may exist); every rank loads a one-process checkpoint with
    ``--ckpts`` and with a resume."""
    rank = get_dist_info()[0]
    model = build_model_from_cfg(job["model"])
    opt = optim.build_optimizer(ConfigDict.from_nested(job["config"]), model, 1)
    path = checkpoint.save_checkpoint(model, opt, 3, "ckpt-x",
                                      os.path.join(job["dir"], f"rank{rank}"))
    checkpoint.wait_for_pending_saves()     # the write is asynchronous
    written = os.path.exists(path)
    load_weights(model, job["one_process_ckpt"], logger="silent")
    loaded = _state(model)
    start, _ = checkpoint.resume_checkpoint(model, opt, os.path.dirname(job["one_process_ckpt"]),
                                            prefix="ckpt-last", logger="silent")
    return {"written": written, "loaded": loaded, "resumed": _state(model),
            "start_epoch": start}


def _counts(model, opt):
    """(parameter elements, moment elements) this rank holds."""
    n_opt = sum(v.numel() for st in opt.optimizer.state.values() for v in st.values()
                if torch.is_tensor(v) and v.dim() > 0)
    return sum(p.numel() for p in model.parameters()), n_opt


def case_fsdp(job):
    """The pretrain step in float64 with ``fsdp`` (ZeRO-3 at ``min_size``)
    and replicated, from the same seeded weights, ``len(job["steps"])``
    steps on this rank's rows of each step's clouds (the clip on): each
    step's loss, the whole state after it (parameters, running statistics,
    AdamW moments, gathered), this rank's element counts; then a blocking
    checkpoint of the sharded run, a resume of it into a fresh sharded
    model and one more step of both; the probe's features on gathered
    parameters of the seeded weights, in float32."""
    from upp_torch.parallel import fsdp
    rows = my_rows(job["steps"][0].shape[0])
    config = ConfigDict.from_nested(job["config"])
    args = types.SimpleNamespace(seed=0)
    out = {}
    with default_dtype(torch.float64):
        def build(shard):
            torch.manual_seed(job["seed"])
            model = build_model_from_cfg(job["model"])
            opt = optim.build_optimizer(config, model, steps_per_epoch=1)
            plan = fsdp.shard_model(model, min_size=job["min_size"]) if shard else None
            return model, opt, runner_pretrain.make_pretrain_step(model, opt, config, args), plan

        def whole(model, opt):
            return fsdp.full_state_dict(model), fsdp.full_optimizer_state_dict(model, opt)

        for mode in ("replicated", "fsdp"):
            model, opt, step, plan = build(mode == "fsdp")
            res = out[mode] = {"loss": [], "state": [], "opt": [], "plan": plan}
            for clouds in job["steps"]:
                COUNTS.clear()
                res["loss"].append(float(step(torch.tensor(clouds[rows]))["loss"]))
                state, opt_state = whole(model, opt)
                res["state"].append(state)
                res["opt"].append(opt_state)
                res["counts"] = _counts(model, opt)
                res["collectives"] = dict(COUNTS)
            if mode == "fsdp":
                checkpoint.save_checkpoint(model, opt, 0, "ckpt-last", job["dir"], block=True)
                resumed, r_opt, r_step, _ = build(True)
                res["start_epoch"], _ = checkpoint.resume_checkpoint(
                    resumed, r_opt, job["dir"], logger="silent", steps_per_epoch=len(job["steps"]))
                res["resumed_state"] = whole(resumed, r_opt)
                last = torch.tensor(job["steps"][-1][rows])
                res["next"] = (float(step(last)["loss"]), *whole(model, opt))
                res["resumed_next"] = (float(r_step(last)["loss"]), *whole(resumed, r_opt))
    loader = runner_cls.sharded_loader(
        build_dataset_from_cfg(job["probe_data"], {"subset": "test"}), 2)
    for mode in ("replicated", "fsdp"):
        model = build(mode == "fsdp")[0]
        with fsdp.gathered(model):
            out[mode]["blocks_gathered"] = sum(p.numel() for p in model.parameters())
            out[mode]["probe"] = runner_pretrain.probe_features(model, loader, job["npoints"],
                                                                CPU)
        out[mode]["blocks_after"] = sum(p.numel() for p in model.parameters())
    return out


def case_tp(job):
    """The cls steps of ``case_cls`` with the block products
    split over the world (a grid of one data rank and ``world`` model
    ranks, ``parallel.tensor``), each rank on every cloud; the gradients and
    the state gathered whole; this rank's block shapes."""
    from upp_torch.parallel import tensor
    from upp_torch.parallel.dist import clear_grid, make_grid, model_group
    config = ConfigDict.from_nested(job["config"])
    args = types.SimpleNamespace(**job["args"])
    out = {}
    make_grid(get_dist_info()[1])
    try:
        with default_dtype(torch.float64):
            model = runner_cls.init_model(args, config, CPU)
            optim.set_trainable(model, runner_cls.PEFT_LIST)
            tensor.shard_model(model, model_group())
            out["shapes"] = {n: tuple(p.shape) for n, p in model.named_parameters()}
            opt = optim.build_optimizer(config, model, steps_per_epoch=1)
            step = runner_cls.make_train_step(model, opt, config, args)
            pts = torch.tensor(job["clouds"], dtype=torch.float64)
            labels = torch.tensor(job["labels"])
            for stage in job.get("stages", ("peft", "joint")):
                _switch(model, stage)
                COUNTS.clear()
                m = step(pts, labels)
                out[stage] = {"loss": float(m["loss"]), "acc": float(m["acc"]),
                              "counts": dict(COUNTS), "state": tensor.full_state_dict(model),
                              "grads": {n: tensor.full_tensor(model, n, p.grad).clone()
                                        for n, p in model.named_parameters()
                                        if p.grad is not None}}
    finally:
        clear_grid()
    return out


def case_fsdp_runner(job):
    """``runner_pretrain.run_net`` with ``fsdp: true``: epoch 0 (its probe
    and ``ckpt-last``), then ``--resume`` through epoch 1; the start epoch
    of the resume read from the log, the probe accuracies."""
    config = ConfigDict.from_nested(job["config"])
    log, lines = _logger(f"fsdp_runner_{get_dist_info()[0]}")
    accs = []
    for max_epoch, resume in ((0, False), (1, True)):
        config.max_epoch = max_epoch
        args = types.SimpleNamespace(seed=0, device="cpu", resume=resume,
                                     experiment_path=job["dir"], log_name=log.name, val_freq=1)
        accs.append(runner_pretrain.run_net(args, config).acc)
    return {"lines": lines, "accs": accs}


CASES = {"bn": case_bn, "cls": case_cls, "pretrain": case_pretrain, "eval": case_eval,
         "ckpt": case_ckpt, "fsdp": case_fsdp, "tp": case_tp, "tp_full": case_tp,
         "fsdp_runner": case_fsdp_runner}


def main(argv):
    rank, world, port, job_path, out = argv
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=port, RANK=rank,
                      WORLD_SIZE=world, LOCAL_RANK="0")
    torch.set_num_threads(1)        # small ops; the test's other workers hold the cores
    from upp_torch.parallel.dist import init_dist
    init_dist("pytorch", "cpu")
    job = torch.load(job_path, weights_only=False)     # written by the test
    results = {name: CASES[name](job[name]) for name in job["cases"]}
    torch.save(results, f"{out}.{rank}")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
