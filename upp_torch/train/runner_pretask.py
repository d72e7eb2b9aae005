"""Prompter pretraining runner (counterpart of
``upp_tpu/train/runner_pretask.py``; reference ``tools/runner_pretask.py``).

Trains the rectification and completion prompters with Chamfer and noise
losses on cropped, noised clouds. One step: augment (the config's
``data_augmentation``) → viewpoint crop at a random ratio, both halves kept
→ shell noise, then lidar noise drawn from the cloud that already holds it
→ model → three CD-L1 terms plus the noise loss → AdamW. At epoch 20 the
rectify set is frozen (stage 2); the optimizer's state carries over. Over
several ranks each trains on its shard of every batch (``parallel.shard``)
and validates its shard of the set, the per-sample rows gathered and the
padding duplicates dropped (``upp_tpu/train/runner_pretask.py:199-280``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..data import build_dataset_from_cfg
from ..data.loader import shard_indices
from ..ops.chamfer import chamfer_l1, chamfer_l1_per_sample, chamfer_l2_per_sample
from ..ops.corrupt import (gaussian_shell_noise, lidar_noise, partial_point_cloud,
                           separate_point_cloud)
from ..ops.fps import fps
from ..parallel import shard
from ..parallel.dist import data_group, gather_samples, get_dist_info, reduce_mean
from ..utils.logger import get_logger, print_log
from . import checkpoint as ckpt
from .metrics import AverageMeter, CDMetric, Metrics, completion_metrics
from .optim import build_optimizer, count_params, set_trainable, step_generator
from .pipeline import AugmentDraws, resolve_augmentation
from .runner_cls import build_loaders, init_model

# tools/runner_pretask.py:110-123
PRETASK_PEFT_LIST = [
    "rectify_adapter", "downstream_adapter", "pretask_adapter",
    "rectify_adapter1", "downstream_adapter1", "pretask_adapter1",
    "rectify_prompts", "downstream_prompts", "pretask_prompts",
    "coarse_pred", "increase_dim", "mask_token", "dense_pred",
    "rectify_prompter", "shape_pred", "predict_token_generator",
    "mask_prompter", "mask_token_generator",
]
# tools/runner_pretask.py:283-296 (the epoch-20 switch: rectify set frozen)
PRETASK_STAGE2_LIST = [
    "downstream_adapter", "pretask_adapter", "downstream_adapter1",
    "pretask_adapter1", "downstream_prompts", "pretask_prompts",
    "coarse_pred", "dense_pred", "mask_token", "shape_pred",
    "predict_token_generator", "increase_dim", "mask_prompter",
    "mask_token_generator",
]
STAGE2_EPOCH = 20
GAUSSIAN_NUM = 20   # runner_pretask.py:198
LIDAR_NUM = 32      # runner_pretask.py:207

CROP_RATIOS = {"easy": 0.25, "median": 0.5, "hard": 0.75}
VIEWPOINTS_8 = [(1, 1, 1), (1, 1, -1), (1, -1, 1), (-1, 1, 1),
                (-1, -1, 1), (-1, 1, -1), (1, -1, -1), (-1, -1, -1)]
LOSS_NAMES = ("cropping_coarse", "cropping_dense", "dense", "noise_loss", "recall")


@dataclasses.dataclass
class PretaskDraws(AugmentDraws):
    """The random numbers of one pretask train step (with those of its
    augmentation). A field left None is drawn: ``num_crop`` and ``shell_u``
    from the step's host generator (no device sync), the rest from its
    device generator. Tests fill them with the JAX package's draws."""
    num_crop: Optional[int] = None               # in [0.15 N, 0.5 N]
    viewpoints: Optional[torch.Tensor] = None    # [B, 3] crop viewpoints
    shell_u: Optional[float] = None              # U(0, 1): radius (u + 2) / 3
    shell_normal: Optional[torch.Tensor] = None  # [B, GAUSSIAN_NUM, 3]
    lidar_idx: Optional[torch.Tensor] = None     # [LIDAR_NUM]
    lidar_factor: Optional[torch.Tensor] = None  # [LIDAR_NUM]


def make_pretask_train_step(model, optimizer, config, args):
    """``train_step(gt [B, N, 3], draws=None) -> dict`` of the step's loss
    terms (x1000, recall x100) as 0-d tensors on gt's device, unsynced.
    Follows ``upp_tpu/train/runner_pretask.py:71-125``. The draws come,
    unless given, from generators seeded from ``args.seed + 777`` and the
    optimizer's count of calls (``optim.step_generator``), dropout and
    drop-path too; over several ranks drawn for the global batch, whose loss
    terms it returns (``parallel.shard``)."""
    npoints = int(config.npoints)
    n_pts_ds = int(config.dataset.train._base_.N_POINTS)
    augment = resolve_augmentation(config.get("data_augmentation", None))
    add_noise = bool(getattr(args, "noise", True))
    noise_types = tuple(getattr(args, "noise_type", ("gaussian_noise", "lidar_noise")))
    crop_lo, crop_hi = int(n_pts_ds * 0.15), int(n_pts_ds * 0.5)
    seed = int(getattr(args, "seed", 0)) + 777
    host_gens, gens = {}, {}        # made at the first step

    def train_step(gt: torch.Tensor, draws: Optional[PretaskDraws] = None):
        dr = draws or PretaskDraws()
        host_gen = step_generator(host_gens, torch.device("cpu"), seed, optimizer.calls)
        gen = step_generator(gens, gt.device, seed, optimizer.calls)
        model.train()
        with shard.global_batch(shard.this_rank(), gen):
            if augment is not None:
                gt = augment(gt, gen, dr)
            num_crop = dr.num_crop
            if num_crop is None:
                num_crop = int(torch.randint(crop_lo, crop_hi + 1, (), generator=host_gen))
            partial, cropping = separate_point_cloud(gt, num_crop, sample_points=npoints,
                                                     viewpoint=dr.viewpoints, generator=gen)
            points = partial
            if add_noise:
                if "gaussian_noise" in noise_types:
                    u = dr.shell_u
                    if u is None:
                        u = float(torch.rand((), generator=host_gen))
                    shell = gaussian_shell_noise(
                        (gt.shape[0], GAUSSIAN_NUM, 3), loc=0.0, scale=0.2,
                        shell_radius=(u + 2.0) / 3.0, generator=gen,
                        normal=dr.shell_normal, device=gt.device)
                    points = torch.cat([points, shell], dim=1)
                if "lidar_noise" in noise_types:
                    lidar = lidar_noise(points, LIDAR_NUM, low=1.2, scale=1.5, generator=gen,
                                        idx=dr.lidar_idx, factor=dr.lidar_factor)
                    points = torch.cat([points, lidar], dim=1)

            out = model(points, point_num=npoints, train_with_gaussian=add_noise)
            if add_noise:
                predict_center, rebuild, noise_loss, recall = out
            else:
                (predict_center, rebuild), noise_loss, recall = out, gt.new_zeros(()), gt.new_ones(())
        # loss terms (runner_pretask.py:217-225)
        cropping_coarse = chamfer_l1(predict_center, cropping)
        cropping_dense = chamfer_l1(rebuild, cropping)
        dense = chamfer_l1(torch.cat([partial, rebuild], dim=1), gt)
        loss = cropping_coarse + cropping_dense + dense + noise_loss
        optimizer.zero_grad()
        loss.backward()
        optimizer.step()
        terms = reduce_mean(torch.stack([cropping_coarse * 1000, cropping_dense * 1000,
                                         dense * 1000, noise_loss * 1000,
                                         recall * 100]).detach(), data_group())
        return dict(zip(LOSS_NAMES, terms))

    return train_step


def make_pretask_eval_step(model, config, mode: str = "easy"):
    """``eval_step(gt [B, N, 3], viewpoint [3]) -> dict``: fixed-viewpoint
    crop → model → per-sample coarse/dense CD x1000 against the full cloud,
    plus the Metrics table entries (``runner_pretask.py:359-388``)."""
    npoints = int(config.npoints)
    n_pts_ds = int(config.dataset.val._base_.N_POINTS)
    num_crop = int(n_pts_ds * CROP_RATIOS[mode])

    @torch.no_grad()
    def eval_step(gt: torch.Tensor, viewpoint: torch.Tensor):
        model.eval()
        partial = partial_point_cloud(gt, num_crop, sample_points=npoints,
                                      viewpoint=viewpoint)
        partial_center, _ = fps(partial, 128)
        predict_center, rebuild = model(partial, point_num=npoints,
                                        train_with_gaussian=False)
        coarse = torch.cat([partial_center, predict_center], dim=1)
        dense = torch.cat([partial, rebuild], dim=1)
        out = {"sparse_l1": chamfer_l1_per_sample(coarse, gt) * 1000,
               "sparse_l2": chamfer_l2_per_sample(coarse, gt) * 1000,
               "dense_l1": chamfer_l1_per_sample(dense, gt) * 1000,
               "dense_l2": chamfer_l2_per_sample(dense, gt) * 1000}
        out.update(completion_metrics(dense, gt))
        return out

    return eval_step


CD_NAMES = ["sparse_l1", "sparse_l2", "dense_l1", "dense_l2"]


def validate(eval_step, loader, device: torch.device, epoch: int, logger=None) -> CDMetric:
    """CD meters over ``loader`` from the first viewpoint, over every rank's
    samples, each once; the per-sample vectors are fetched once, after the
    sweep."""
    meters = AverageMeter(CD_NAMES)
    vp = torch.tensor(VIEWPOINTS_8[0], dtype=torch.float32)
    idxs, pending = [], []
    for idx, batch in loader.iter_indexed():
        idxs.append(idx)
        pending.append(eval_step(torch.from_numpy(batch[0]).to(device), vp))
    cds = np.concatenate([torch.stack([m[c] for c in CD_NAMES], 1).cpu().numpy()
                          for m in pending]) if pending else np.zeros((0, len(CD_NAMES)))
    _, (cds,) = gather_samples(np.concatenate(idxs) if idxs else [], cds)
    meters.update_vectors(list(cds.T))
    print_log("[Epoch %d] validate dense Chamfer Distance L2: %.5f"
              % (epoch, meters.avg(3)), logger=logger)
    return CDMetric(meters.avg(3))


def validate_detailed(eval_step, dataset, device: torch.device, epoch: int,
                      logger=None) -> CDMetric:
    """One sample at a time, 8 viewpoints each: the CD meters and the
    per-taxonomy Metrics table with its Overall row, the reference's TEST
    RESULTS report (``tools/runner_pretask.py:385-447``). Each rank
    evaluates its shard of the samples; the rows are gathered, the padding
    duplicates dropped, and the meters filled in sample order, as one
    process fills them."""
    names = CD_NAMES + Metrics.names()
    rank, world = get_dist_info()
    idxs, taxonomies, rows = [], [], []
    for i in shard_indices(np.arange(len(dataset)), world, rank):
        taxonomy_id, _, payload = dataset[i]
        gt = torch.from_numpy(np.asarray(payload[0], np.float32))[None].to(device)
        per_vp = []
        for vp in VIEWPOINTS_8:
            m = eval_step(gt, torch.tensor(vp, dtype=torch.float32))
            per_vp.append([float(m[c].mean()) for c in names])
        idxs.append(i)
        taxonomies.append(str(taxonomy_id))
        rows.append(per_vp)
    _, (taxonomies, rows) = gather_samples(
        idxs, np.asarray(taxonomies, dtype=object),
        np.asarray(rows, np.float64).reshape(-1, len(VIEWPOINTS_8), len(names)))
    meters = AverageMeter(CD_NAMES)
    category_metrics: dict = {}
    for taxonomy_id, per_vp in zip(taxonomies, rows):
        for vals in per_vp:
            meters.update(list(vals[:len(CD_NAMES)]))
            category_metrics.setdefault(
                taxonomy_id, AverageMeter(Metrics.names())).update(list(vals[len(CD_NAMES):]))
    _print_metrics_table(category_metrics, logger)
    print_log("[Epoch %d] validate dense Chamfer Distance L2: %.5f"
              % (epoch, meters.avg(3)), logger=logger)
    return CDMetric(meters.avg(3))


def _print_metrics_table(category_metrics: dict, logger=None) -> None:
    """One row per taxonomy and an Overall row averaging the per-taxonomy
    averages (``runner_pretask.py:418-447``)."""
    overall = AverageMeter(Metrics.names())
    print_log("============================ TEST RESULTS "
              "============================", logger=logger)
    print_log("Taxonomy\t#Sample\t" + "\t".join(Metrics.names()), logger=logger)
    for tax, meter in category_metrics.items():
        overall.update(meter.avg())
        row = "\t".join("%.3f" % v for v in meter.avg())
        print_log(f"{tax}\t{meter.count(0)}\t{row}", logger=logger)
    print_log("Overall\t\t" + "\t".join("%.3f" % v for v in overall.avg()),
              logger=logger)


def run_net(args, config, train_writer=None, val_writer=None) -> CDMetric:
    """Train on ``args.device`` (CUDA unless the caller names another):
    epochs 0..max_epoch, validate every ``val_freq`` epochs, write
    ``ckpt-best`` and ``ckpt-last``; the stage-2 freeze after epoch 20. The
    writers get the epoch's mean loss terms and learning rate and the
    validation metrics."""
    device = resolve_device(getattr(args, "device", None))
    logger = get_logger(getattr(args, "log_name", "upp_torch"))
    train_loader, val_loader = build_loaders(args, config)
    model = init_model(args, config, device, logger=logger)
    steps_per_epoch = max(len(train_loader), 1)
    set_trainable(model, PRETASK_PEFT_LIST if getattr(args, "peft_model", True) else None)
    optimizer = build_optimizer(config, model, steps_per_epoch)
    trainable, total = count_params(model)
    print_log(f"# TrainableParams: {trainable / 1e6:.2f} M / {total / 1e6:.2f} M",
              logger=logger)

    start_epoch, best = 0, CDMetric(1000.0)
    if getattr(args, "resume", False):
        start_epoch, saved = ckpt.resume_checkpoint(model, optimizer, args.experiment_path,
                                                    logger=logger,
                                                    steps_per_epoch=steps_per_epoch)
        best = CDMetric(saved.get("cd", 1000.0))
    if start_epoch > STAGE2_EPOCH:      # a resumed run past the switch stays in stage 2
        set_trainable(model, PRETASK_STAGE2_LIST)

    train_step = make_pretask_train_step(model, optimizer, config, args)
    eval_step = make_pretask_eval_step(model, config,
                                       mode=getattr(args, "mode", None) or "easy")
    metrics = CDMetric(1000.0)
    for epoch in range(start_epoch, int(config.max_epoch) + 1):
        train_loader.set_epoch(epoch)
        meters = AverageMeter(["CroppingCoarseLoss", "CroppingDenseLoss",
                               "DenseLoss", "NoiseLoss", "Recall"])
        t0 = time.time()
        pending = [train_step(torch.from_numpy(batch[0]).to(device))
                   for batch in train_loader]
        for m in pending:              # one fetch per epoch keeps the queue full
            meters.update([float(m[k]) for k in LOSS_NAMES])
        print_log("[Training] EPOCH: %d EpochTime = %.3f (s) Losses = %s" %
                  (epoch, time.time() - t0, ["%.4f" % v for v in meters.avg()]),
                  logger=logger)
        if train_writer is not None:
            for name, v in zip(meters.items, meters.avg()):
                train_writer.add_scalar(f"Loss/Epoch/{name}", v, epoch)
            train_writer.add_scalar("Loss/Epoch/LR",
                                    optimizer.sched(epoch * steps_per_epoch), epoch)
        if epoch == STAGE2_EPOCH:
            print_log("[stage 2] freezing rectify set", logger=logger)
            set_trainable(model, PRETASK_STAGE2_LIST)
        if epoch % max(int(getattr(args, "val_freq", 1)), 1) == 0:
            metrics = validate(eval_step, val_loader, device, epoch, logger=logger)
            if val_writer is not None:
                for k, v in metrics.state_dict().items():
                    val_writer.add_scalar(f"Metric/{k}", float(v), epoch)
            if metrics.better_than(best):
                best = metrics
                ckpt.save_checkpoint(model, optimizer, epoch, "ckpt-best",
                                     args.experiment_path,
                                     metrics=metrics.state_dict(), logger=logger)
        ckpt.save_checkpoint(model, optimizer, epoch, "ckpt-last", args.experiment_path,
                             metrics=metrics.state_dict(), logger=logger)
    ckpt.wait_for_pending_saves()
    return best


def test_net(args, config) -> CDMetric:
    """Detailed pretask eval on ``args.device``: 8 fixed viewpoints per test
    sample, crop ratio from ``--mode``."""
    device = resolve_device(getattr(args, "device", None))
    logger = get_logger(getattr(args, "log_name", "upp_torch"))
    test_ds = build_dataset_from_cfg(config.dataset.test._base_,
                                     config.dataset.test.others)
    model = init_model(args, config, device, logger=logger)
    eval_step = make_pretask_eval_step(model, config,
                                       mode=getattr(args, "mode", None) or "easy")
    return validate_detailed(eval_step, test_ds, device, 0, logger=logger)
