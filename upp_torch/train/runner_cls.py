"""Classification runners (counterpart of ``upp_tpu/train/runner_cls.py``;
reference ``tools/runner_module.py`` and ``tools/runner_finetune.py``): PEFT
training with the joint-optimization switch (``run_net``), full fine-tuning
(``finetune_run_net``), evaluation (``make_eval_step``, ``validate``,
``test_net``) and the 10-vote test (``test_vote``); and the set-up the
runners share (``init_model`` with ``--ckpts``, ``build_loaders``).
Over several ranks (``--launcher pytorch``) each rank trains on its shard of
every batch (``parallel.shard``) and evaluates its shard of the set; the
per-sample results are gathered and the loader's padding duplicates dropped
(``parallel.dist.gather_samples``), so every rank holds the one-process
metrics; rank 0 alone writes checkpoints and metrics.

One train step: crop 8192→1024 (+48 lidar, +24 shell points), the config's
augmentation, ``PointMAEUnify`` in train mode through its three passes,
cross-entropy, AdamW over the trainable set. The training runners log to
the logger and to the writers they are given.
"""

from __future__ import annotations

import time
from typing import Iterable, Optional

import numpy as np
import torch

from .. import resolve_device
from ..data import BatchLoader, build_dataset_from_cfg
from ..models import MODELS, build_model_from_cfg
from ..ops.corrupt import normalize_unit_sphere, scale_translate
from ..ops.fps import fps
from ..parallel import shard
from ..parallel.dist import gather_samples, get_dist_info
from ..utils.logger import get_logger, print_log
from ..utils.profiling import annotate
from . import checkpoint as ckpt
from .ckpt_io import load_weights
from .metrics import AccMetric, AverageMeter, cross_entropy_loss_acc
from .optim import build_optimizer, count_params, graphed_train_step, set_trainable
from .pipeline import CorruptDraws, corrupt_batch, resolve_augmentation, subsample_fps_random

# PEFT trainable-name lists (tools/runner_module.py:62-66, 230-244); the
# joint set leaves out the head, bnorm and the cls tokens, as the reference
PEFT_LIST = ["downstream_adapter", "downstream_adapter1", "downstream_prompts",
             "bnorm", "cls_pos", "cls_token", "cls_head_finetune"]
JOINT_PEFT_LIST = ["downstream_adapter", "downstream_adapter1",
                   "downstream_prompts", "dense_pred", "mask_token",
                   "rectify_prompter", "shape_pred", "coarse_pred",
                   "predict_token_generator", "mask_prompter",
                   "mask_token_generator"]


def sharded_loader(dataset, batch_size: int, **kw) -> BatchLoader:
    """A ``BatchLoader`` over this rank's shard of ``dataset``
    (``upp_tpu/train/runner_cls.py:51-57``); the whole set in one process."""
    rank, world = get_dist_info()
    return BatchLoader(dataset, int(batch_size), num_shards=world, shard_index=rank, **kw)


def build_loaders(args, config):
    """(train loader: shuffled per epoch from ``args.seed``, full batches
    only; val loader: in order, every sample), each over this rank's
    shard."""
    train_ds = build_dataset_from_cfg(config.dataset.train._base_,
                                      config.dataset.train.others)
    val_ds = build_dataset_from_cfg(config.dataset.val._base_,
                                    config.dataset.val.others)
    train_loader = sharded_loader(train_ds, config.dataset.train.others.bs,
                                  shuffle=True, drop_last=True,
                                  seed=int(getattr(args, "seed", 0)))
    val_loader = sharded_loader(val_ds, config.dataset.val.others.bs)
    return train_loader, val_loader


def init_model(args, config, device: torch.device, logger=None):
    """Build the model from the config with weights from ``args.seed``,
    created on the CPU first so every device gets the same weights, then
    load ``args.ckpts`` over them when given."""
    name = config.model.NAME
    if MODELS.get(name) is None:
        raise NotImplementedError(f"model {name!r} is not ported yet; the port has "
                                  f"{sorted(MODELS.module_dict)}")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(int(getattr(args, "seed", 0)))
        model = build_model_from_cfg(config.model)
    print_log(f"Model from a seeded init (seed {getattr(args, 'seed', 0)})",
              logger=logger)
    if getattr(args, "ckpts", None):
        load_weights(model, args.ckpts, logger=logger)
    return model.to(device).eval()


def make_train_step(model, optimizer, config, args):
    """``train_step(pts [B, N, 3], label [B], draws=None) -> {"loss",
    "acc"}`` as 0-d tensors on pts' device, unsynced: ``corrupt_batch``
    (the config's noise and augmentation), the model in train mode
    (through the rectify and completion passes when ``noisy_train``),
    cross-entropy, one optimizer step. Follows
    ``upp_tpu/train/runner_cls.py:86-126``; the draws come, unless given,
    from a device generator seeded from ``args.seed + 777`` and the
    optimizer's count of calls, as JAX folds ``state.step`` into its key,
    so a resumed run draws what the uninterrupted run would have; dropout
    and drop-path too. Over several ranks ``pts`` is this rank's shard of
    the global batch (``parallel.shard.global_batch``) and the returned
    loss and accuracy are the global batch's. On a card the forward passes,
    the loss and the backward replay as one CUDA graph from a key's second
    step on, the optimizer eager after it (``optim.graphed_train_step``;
    eager over several ranks, with ``draws``, or when the optimizer
    accumulates)."""
    noisy_train = bool(config.get("noisy_train", False))
    npoints = int(config.npoints)
    augmentation = config.get("data_augmentation", None)
    resolve_augmentation(augmentation)          # an unknown name fails here
    corrupt_kw = dict(
        npoints=npoints, n_points_dataset=int(config.dataset.train._base_.N_POINTS),
        noisy_train=noisy_train,
        incomplete_cropping=bool(getattr(args, "incomplete_cropping", True)),
        add_noise=bool(getattr(args, "noise", True)),
        noise_types=tuple(getattr(args, "noise_type", ("gaussian_noise", "lidar_noise"))),
        augmentation=augmentation, normalize=bool(getattr(args, "normalize", False)))

    def forward_backward(pts: torch.Tensor, label: torch.Tensor,
                         generator: torch.Generator, draws: Optional[CorruptDraws]):
        with shard.global_batch(shard.this_rank(), generator):
            points = corrupt_batch(pts, **corrupt_kw, generator=generator, draws=draws)
            logits = model(points, completion_prompt=noisy_train, denoise=noisy_train,
                           point_num=npoints)
        loss, acc = cross_entropy_loss_acc(logits, label)
        with annotate("backward"):
            loss.backward()
        return torch.stack([loss.detach(), acc.detach()])

    return graphed_train_step(model, optimizer, forward_backward,
                              int(getattr(args, "seed", 0)) + 777)


def make_eval_step(model, config, args):
    """``eval_step(pts [B, N, 3]) -> predicted class [B]``: FPS to
    ``npoints``, then the model in eval mode, through the rectify and
    completion passes when the config sets ``noisy_validate``."""
    npoints = int(config.npoints)
    noisy_validate = bool(config.get("noisy_validate", False))
    normalize = bool(getattr(args, "normalize", False))

    @torch.inference_mode()
    def eval_step(pts: torch.Tensor) -> torch.Tensor:
        with annotate("eval_step"):
            model.eval()
            points, _ = fps(pts, npoints)
            if normalize:
                points = normalize_unit_sphere(points)
            logits = model(points, completion_prompt=noisy_validate,
                           denoise=noisy_validate, point_num=npoints)
            return logits.argmax(-1)

    return eval_step


def _accuracy(preds, labels, idxs) -> float:
    """Accuracy (%) over every rank's samples, each once."""
    hit = (torch.cat(preds).cpu().numpy() == np.concatenate(labels)) if preds \
        else np.zeros((0,), bool)
    _, (hit,) = gather_samples(np.concatenate(idxs) if idxs else [], hit)
    return float(hit.mean() * 100.0) if hit.size else 0.0


def validate(eval_step, loader, device: torch.device, epoch: int,
             logger=None) -> AccMetric:
    """Accuracy (%) of ``eval_step`` over ``loader``, over every rank's
    shard; the predictions are fetched once, after the sweep."""
    preds, labels, idxs = [], [], []
    for idx, (pts, label) in loader.iter_indexed():
        preds.append(eval_step(torch.from_numpy(pts).to(device)))
        labels.append(np.asarray(label))
        idxs.append(idx)
    acc = _accuracy(preds, labels, idxs)
    print_log(f"[Validation] EPOCH: {epoch}  acc = {acc:.4f}", logger=logger)
    return AccMetric(acc)


FETCH_LAG = 16    # steps between a train step's dispatch and its metrics' fetch


def run_net(args, config, train_writer=None, val_writer=None) -> AccMetric:
    """PEFT classification training on ``args.device`` (CUDA unless the
    caller names another), ``runner_module.run_net``: validation before the
    first epoch, then every ``val_freq`` epochs; ``ckpt-best`` when the
    accuracy improves and ``ckpt-last`` every epoch; ``--resume``; after
    epoch ``--joint_optimization`` (and on a resume past it) the trainable
    set becomes ``JOINT_PEFT_LIST`` on the live optimizer, whose AdamW
    moments of parameters that stay trainable carry over. A step's metrics
    are fetched ``FETCH_LAG`` steps after its dispatch, as the JAX runner
    does: the queue stays full and a non-finite loss is logged
    (``[DIVERGED]``) within that many steps. The writers
    (``utils.writer.MetricsWriter``) get the per-batch loss, accuracy and
    learning rate and the validation accuracy. Returns the best validation
    accuracy."""
    device = resolve_device(getattr(args, "device", None))
    logger = get_logger(getattr(args, "log_name", "upp_torch"))
    train_loader, val_loader = build_loaders(args, config)
    model = init_model(args, config, device, logger=logger)
    steps_per_epoch = max(len(train_loader), 1)
    set_trainable(model, PEFT_LIST if getattr(args, "peft_model", True) else None)
    optimizer = build_optimizer(config, model, steps_per_epoch)
    trainable, total = count_params(model)
    print_log(f"# TrainableParams: {trainable / 1e6:.2f} M / {total / 1e6:.2f} M "
              f"({trainable / total * 100:.2f} %)", logger=logger)

    start_epoch, best = 0, AccMetric(0.0)
    if getattr(args, "resume", False):
        start_epoch, saved = ckpt.resume_checkpoint(model, optimizer, args.experiment_path,
                                                    logger=logger,
                                                    steps_per_epoch=steps_per_epoch)
        best = AccMetric(saved.get("acc", 0.0))

    train_step = make_train_step(model, optimizer, config, args)
    eval_step = make_eval_step(model, config, args)
    metrics = validate(eval_step, val_loader, device, 0, logger=logger)

    # `or -1` would drop epoch 0; the reference's `joint_optimization == epoch`
    # accepts it. A full fine-tune never switches: no baseline parameter is
    # in the joint set, so the switch would leave nothing to train (the JAX
    # package switches there too)
    jo = getattr(args, "joint_optimization", None)
    peft = getattr(args, "peft_model", True)
    joint_epoch = int(jo) if jo is not None and peft else -1

    def joint_switch():
        print_log("[joint optimization] switching trainable set", logger=logger)
        set_trainable(model, JOINT_PEFT_LIST)

    if 0 <= joint_epoch < start_epoch:     # a resumed run past the switch
        joint_switch()
    val_freq = max(int(getattr(args, "val_freq", 1)), 1)
    for epoch in range(start_epoch, int(config.max_epoch) + 1):
        train_loader.set_epoch(epoch)
        meters = AverageMeter(["loss", "acc"])
        t0 = time.time()
        lr_epoch = optimizer.sched(epoch * steps_per_epoch)

        def drain(batch_idx, m):
            loss_v, acc_v = float(m["loss"]), float(m["acc"])
            if not np.isfinite(loss_v):
                print_log(f"[DIVERGED] non-finite loss at epoch {epoch} step "
                          f"{batch_idx}: {loss_v}", logger=logger)
            meters.update([loss_v, acc_v])
            if train_writer is not None:
                n_itr = epoch * steps_per_epoch + batch_idx
                train_writer.add_scalar("Loss/Batch/Loss", loss_v, n_itr)
                train_writer.add_scalar("Loss/Batch/TrainAcc", acc_v, n_itr)
                train_writer.add_scalar("Loss/Batch/LR", lr_epoch, n_itr)

        pending = []
        for batch_idx, (pts, label) in enumerate(train_loader):
            pending.append((batch_idx, train_step(torch.from_numpy(pts).to(device),
                                                  torch.from_numpy(label).to(device))))
            if len(pending) > FETCH_LAG:
                drain(*pending.pop(0))
        for item in pending:
            drain(*item)
        if epoch == joint_epoch:
            joint_switch()
        print_log("[Training] EPOCH: %d EpochTime = %.3f (s) Losses = %s" %
                  (epoch, time.time() - t0, ["%.4f" % v for v in meters.avg()]),
                  logger=logger)
        if train_writer is not None:
            train_writer.add_scalar("Loss/Epoch/Loss", meters.avg(0), epoch)
        if epoch % val_freq == 0 and epoch != 0:
            metrics = validate(eval_step, val_loader, device, epoch, logger=logger)
            if val_writer is not None:
                val_writer.add_scalar("Metric/ACC", metrics.acc, epoch)
            if metrics.better_than(best):
                best = metrics
                ckpt.save_checkpoint(model, optimizer, epoch, "ckpt-best",
                                     args.experiment_path,
                                     metrics=metrics.state_dict(), logger=logger)
        ckpt.save_checkpoint(model, optimizer, epoch, "ckpt-last", args.experiment_path,
                             metrics=metrics.state_dict(), logger=logger)
    ckpt.wait_for_pending_saves()
    return best


def finetune_run_net(args, config, train_writer=None, val_writer=None) -> AccMetric:
    """Full fine-tuning (``tools/runner_finetune.py``): the same loop with
    every parameter trainable throughout (no joint switch)."""
    args.peft_model = False
    return run_net(args, config, train_writer, val_writer)


def test_vote(model, loader, config, args, device: torch.device, times: int = 10,
              draws: Optional[Iterable[CorruptDraws]] = None) -> float:
    """Accuracy (%) of the sum of ``times`` votes' logits
    (``runner_module.py:427-490``): each vote FPS-resamples a cloud to 1200
    points, keeps a random 1024 of their columns and scale-translates them,
    then runs the downstream pass alone (no prompters). The votes' draws
    (``choice``, ``aug_scale``, ``aug_shift``, one per vote in order) come
    from ``draws`` or a device generator seeded from ``args.seed + 4242``,
    each per-cloud draw made for a whole one-process batch (the loader's
    batch size times the ranks), of which this rank's batch holds every
    world-th row (``parallel.shard.Shard(strided=True)``): the ranks vote as
    one process does."""
    npoints = int(config.npoints)
    gen = torch.Generator(device).manual_seed(int(getattr(args, "seed", 0)) + 4242)
    draws = iter(draws) if draws is not None else None
    rank, world = get_dist_info()
    rows = shard.Shard(rank, world, strided=True, rows=loader.batch_size * world)
    model.eval()
    preds, labels, idxs = [], [], []
    with torch.inference_mode(), shard.global_batch(rows):
        for idx, (pts, label) in loader.iter_indexed():
            pts = torch.from_numpy(pts).to(device)
            logits = 0.0
            for _ in range(times):
                dr = next(draws) if draws is not None else CorruptDraws()
                points = subsample_fps_random(pts, npoints, generator=gen, choice=dr.choice)
                points = scale_translate(points, generator=gen, scale=dr.aug_scale,
                                         shift=dr.aug_shift)
                logits = logits + model(points)
            preds.append(logits.argmax(-1))
            labels.append(np.asarray(label))
            idxs.append(idx)
    return _accuracy(preds, labels, idxs)


def test_net(args, config) -> float:
    """Evaluate on the config's test split (``runner_module.test_net``), on
    ``args.device`` (CUDA unless the caller names another), from
    ``--ckpts`` or a seeded init; with ``--vote`` also the 10-vote
    accuracy. Returns the single-pass accuracy."""
    device = resolve_device(getattr(args, "device", None))
    logger = get_logger(getattr(args, "log_name", "upp_torch"))
    test_ds = build_dataset_from_cfg(config.dataset.test._base_,
                                     config.dataset.test.others)
    loader = sharded_loader(test_ds, config.dataset.test.others.bs)
    model = init_model(args, config, device, logger=logger)
    eval_step = make_eval_step(model, config, args)
    metrics = validate(eval_step, loader, device, 0, logger=logger)
    print_log(f"[TEST] acc = {metrics.acc:.4f}", logger=logger)
    if getattr(args, "vote", False):
        acc = test_vote(model, loader, config, args, device)
        print_log(f"[TEST_VOTE] acc = {acc:.4f}", logger=logger)
    return metrics.acc
