"""Part-segmentation runners (counterpart of ``upp_tpu/train/runner_seg.py``;
reference ``tools/runner_unify_seg.py`` and ``tools/runner_finetune_seg.py``):
ShapeNetPart training with one-hot category conditioning, the UPP train
step's raw 25% viewpoint crop (kept at its size), +24 shell and +64 lidar
points, NLL over per-point log-probabilities, and the accuracy / class-avg /
instance-avg mIoU validation. Over several ranks each trains on its shard
of every batch and validates its shard of the set; the per-sample
predictions are gathered and the padding duplicates dropped
(``upp_tpu/train/runner_seg.py:112-182``).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..data import build_dataset_from_cfg
from ..data.partnormal import SEG_CLASSES
from ..ops.corrupt import gaussian_shell_noise, lidar_noise, separate_point_cloud
from ..parallel import shard
from ..parallel.dist import gather_samples, reduce_mean
from ..utils.logger import get_logger, print_log
from . import checkpoint as ckpt
from .metrics import AverageMeter, nll_seg_loss, seg_miou_metrics
from .optim import build_optimizer, count_params, set_trainable, step_generator
from .pipeline import CorruptDraws, resolve_augmentation
from .runner_cls import build_loaders, init_model, sharded_loader

# tools/runner_unify_seg.py:143-146
SEG_PEFT_LIST = ["downstream_adapter", "downstream_prompts", "label_conv",
                 "propagation_0", "seg_head", "propagation_1"]
NUM_CLASSES = 16
GAUSSIAN_NUM = 24   # runner_unify_seg.py:218
LIDAR_NUM = 64      # runner_unify_seg.py:221
CROP_RATIO = 0.25


def to_categorical(y: torch.Tensor, num_classes: int = NUM_CLASSES,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """One-hot [B, num_classes] of integer categories [B]."""
    return F.one_hot(y.long().reshape(-1), num_classes).to(dtype)


def make_seg_train_step(model, optimizer, config, args, unify: bool):
    """``train_step(pts [B, N, 3], cls [B], seg [B, N], draws=None) ->
    {"loss", "acc"}`` as 0-d tensors on pts' device, unsynced
    (``upp_tpu/train/runner_seg.py:42``): the config's augmentation; for the
    UPP model with ``noisy_train`` the raw crop of the nearest 25% of the
    points to a viewpoint, +24 shell and then +64 lidar points, and a
    forward through the rectify and completion passes with ``point_num``
    the cropped cloud's size, queried at the augmented full cloud; NLL;
    clip and AdamW. The draws (``viewpoints``, ``shell_normal``,
    ``lidar_idx``, ``lidar_factor``, the augmentation's) come, unless given,
    from a generator seeded from ``args.seed + 777`` and the optimizer's
    count of calls, as dropout and drop-path do; over several ranks drawn
    for the global batch, whose loss and accuracy it returns
    (``parallel.shard``)."""
    num_crop = int(int(config.dataset.train._base_.N_POINTS) * CROP_RATIO)
    augment = resolve_augmentation(config.get("data_augmentation", None))
    noisy = bool(config.get("noisy_train", False))
    deviation = float(getattr(args, "deviation", 0.1))
    noise_radius = float(getattr(args, "noise_radius", 0.8))
    seed = int(getattr(args, "seed", 0)) + 777
    gens = {}

    def train_step(pts: torch.Tensor, cls_label: torch.Tensor, target: torch.Tensor,
                   draws: Optional[CorruptDraws] = None):
        gen = step_generator(gens, pts.device, seed, optimizer.calls)
        dr = draws or CorruptDraws()
        model.train()
        with shard.global_batch(shard.this_rank(), gen):
            if augment is not None:
                pts = augment(pts, gen, dr)
            one_hot = to_categorical(cls_label, dtype=pts.dtype)
            if unify and noisy:
                points, _ = separate_point_cloud(pts, num_crop, viewpoint=dr.viewpoints,
                                                 generator=gen, resample=False)
                B, P, _ = points.shape
                shell = gaussian_shell_noise((B, GAUSSIAN_NUM, 3), loc=0.0, scale=deviation,
                                             shell_radius=noise_radius, generator=gen,
                                             normal=dr.shell_normal, device=pts.device)
                points = torch.cat([points, shell], dim=1)
                lidar = lidar_noise(points, LIDAR_NUM, low=1.2, scale=1.5, generator=gen,
                                    idx=dr.lidar_idx, factor=dr.lidar_factor)
                points = torch.cat([points, lidar], dim=1)
            else:
                points, P = pts, pts.shape[1]
            if unify:
                out = model(points, one_hot, pts, completion_prompt=noisy, denoise=noisy,
                            point_num=P)
            else:
                out = model(points, one_hot, pts)
        loss = nll_seg_loss(out, target)
        acc = (out.argmax(-1) == target).float().mean() * 100.0
        optimizer.zero_grad()
        loss.backward()
        optimizer.step()
        loss, acc = reduce_mean(torch.stack([loss.detach(), acc.detach()]))
        return {"loss": loss, "acc": acc}

    return train_step


def make_seg_eval_step(model, config, unify: bool):
    """``eval_step(pts [B, N, 3], cls [B]) -> log-probabilities [B, N,
    cls_dim]``: the model in eval mode on the clean clouds (the UPP model's
    downstream pass alone, as in the JAX package)."""

    @torch.inference_mode()
    def eval_step(pts: torch.Tensor, cls_label: torch.Tensor) -> torch.Tensor:
        model.eval()
        one_hot = to_categorical(cls_label, dtype=pts.dtype)
        if unify:
            return model(pts, one_hot, completion_prompt=False, denoise=False,
                         point_num=pts.shape[1])
        return model(pts, one_hot)

    return eval_step


def _part_masks(seg: np.ndarray, num_parts: int) -> np.ndarray:
    """[B, num_parts] bool: the parts of each sample's category, read from
    its first point's label as the reference does."""
    label_to_cat = {p: c for c, parts in SEG_CLASSES.items() for p in parts}
    mask = np.zeros((seg.shape[0], num_parts), bool)
    for i, first in enumerate(seg[:, 0]):
        mask[i, SEG_CLASSES[label_to_cat[int(first)]]] = True
    return mask


def validate(eval_step, loader, device: torch.device, epoch: int, logger=None):
    """The mIoU suite of ``eval_step`` over ``loader``
    (``runner_unify_seg.py:300-368``): each point's prediction is the argmax
    over its object's category's parts only; then accuracy, class-avg and
    instance-avg mIoU over every rank's samples, each once, logged with the
    per-category table in the reference's format. The predictions are
    fetched once, after the sweep."""
    preds, targets, cats, idxs = [], [], [], []
    for idx, (pts, cls, seg) in loader.iter_indexed():
        logp = eval_step(torch.from_numpy(pts).to(device), torch.from_numpy(cls).to(device))
        allowed = torch.from_numpy(_part_masks(seg, logp.shape[-1])).to(device)
        preds.append(logp.masked_fill(~allowed[:, None, :], -torch.inf).argmax(-1))
        targets.append(seg)
        cats.append(cls)
        idxs.append(idx)
    _, cols = gather_samples(np.concatenate(idxs), torch.cat(preds).cpu().numpy(),
                             np.concatenate(targets), np.concatenate(cats))
    m = seg_miou_metrics(*cols, SEG_CLASSES)
    for cat in sorted(m["per_category_iou"]):
        print_log("eval mIoU of %s %f" % (cat + " " * (14 - len(cat)),
                                          m["per_category_iou"][cat]), logger=logger)
    print_log("Epoch %d test Accuracy: %f  Class avg mIOU: %f  Instance avg mIOU: %f" %
              (epoch, m["accuracy"] * 100, m["class_avg_iou"] * 100,
               m["instance_avg_iou"] * 100), logger=logger)
    return m


def _floats(metrics) -> dict:
    return {k: v for k, v in metrics.items() if isinstance(v, float)}


def run_net(args, config, train_writer=None, val_writer=None, unify: bool = True):
    """Segmentation training on ``args.device`` (CUDA unless the caller
    names another): epochs 0..max_epoch with ``SEG_PEFT_LIST`` trainable
    (UPP with ``--peft_model``) or every parameter; validation every
    ``val_freq`` epochs; ``ckpt-best`` when the instance-avg mIoU does not
    fall and ``ckpt-last`` every epoch; ``--resume``; ``--ckpts``. Metrics
    are fetched once per epoch, as in the JAX runner. Returns the last
    validation's metrics."""
    device = resolve_device(getattr(args, "device", None))
    logger = get_logger(getattr(args, "log_name", "upp_torch"))
    train_loader, val_loader = build_loaders(args, config)
    model = init_model(args, config, device, logger=logger)
    steps_per_epoch = max(len(train_loader), 1)
    set_trainable(model, SEG_PEFT_LIST if unify and getattr(args, "peft_model", True)
                  else None)
    optimizer = build_optimizer(config, model, steps_per_epoch)
    trainable, total = count_params(model)
    print_log(f"# TrainableParams: {trainable / 1e6:.2f} M / {total / 1e6:.2f} M",
              logger=logger)

    start_epoch, best_ins_iou = 0, 0.0
    if getattr(args, "resume", False):
        start_epoch, saved = ckpt.resume_checkpoint(model, optimizer, args.experiment_path,
                                                    logger=logger,
                                                    steps_per_epoch=steps_per_epoch)
        best_ins_iou = saved.get("instance_avg_iou", 0.0)

    train_step = make_seg_train_step(model, optimizer, config, args, unify)
    eval_step = make_seg_eval_step(model, config, unify)
    metrics = {"instance_avg_iou": 0.0}
    val_freq = max(int(getattr(args, "val_freq", 1)), 1)
    for epoch in range(start_epoch, int(config.max_epoch) + 1):
        train_loader.set_epoch(epoch)
        meters = AverageMeter(["loss", "acc"])
        t0 = time.time()
        pending = [train_step(*(torch.from_numpy(a).to(device) for a in batch))
                   for batch in train_loader]
        for batch_idx, m in enumerate(pending):   # one fetch per epoch
            loss_v = float(m["loss"])
            if not np.isfinite(loss_v):
                print_log(f"[DIVERGED] non-finite loss at epoch {epoch} step "
                          f"{batch_idx}: {loss_v}", logger=logger)
            meters.update([loss_v, float(m["acc"])])
        print_log("[Training] EPOCH: %d EpochTime = %.3f (s) Losses = %s" %
                  (epoch, time.time() - t0, ["%.4f" % v for v in meters.avg()]),
                  logger=logger)
        if train_writer is not None:
            train_writer.add_scalar("Loss/Epoch/Loss", meters.avg(0), epoch)
            train_writer.add_scalar("Loss/Epoch/TrainAcc", meters.avg(1), epoch)
            train_writer.add_scalar("Loss/Epoch/LR",
                                    optimizer.sched(epoch * steps_per_epoch), epoch)
        if epoch % val_freq == 0:
            metrics = validate(eval_step, val_loader, device, epoch, logger=logger)
            if val_writer is not None:
                for k in ("accuracy", "class_avg_iou", "instance_avg_iou"):
                    val_writer.add_scalar(f"Metric/{k}", metrics[k], epoch)
            if metrics["instance_avg_iou"] >= best_ins_iou:
                best_ins_iou = metrics["instance_avg_iou"]
                ckpt.save_checkpoint(model, optimizer, epoch, "ckpt-best",
                                     args.experiment_path, metrics=_floats(metrics),
                                     logger=logger)
        ckpt.save_checkpoint(model, optimizer, epoch, "ckpt-last", args.experiment_path,
                             metrics=_floats(metrics), logger=logger)
    return metrics


def finetune_run_net(args, config, train_writer=None, val_writer=None):
    """Full fine-tune segmentation (``tools/runner_finetune_seg.py``)."""
    return run_net(args, config, train_writer, val_writer, unify=False)


def test_net(args, config, unify: bool = True):
    """The mIoU suite on the config's test split, on ``args.device``, from
    ``--ckpts`` or a seeded init."""
    device = resolve_device(getattr(args, "device", None))
    logger = get_logger(getattr(args, "log_name", "upp_torch"))
    test_ds = build_dataset_from_cfg(config.dataset.test._base_,
                                     config.dataset.test.others)
    loader = sharded_loader(test_ds, config.dataset.test.others.bs)
    model = init_model(args, config, device, logger=logger)
    return validate(make_seg_eval_step(model, config, unify), loader, device, 0,
                    logger=logger)
