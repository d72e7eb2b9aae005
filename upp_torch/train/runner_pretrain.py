"""Point-MAE pretraining runner (counterpart of
``upp_tpu/train/runner_pretrain.py``; reference ``tools/runner_pretrain.py``).

One step: FPS to ``npoints``, the config's augmentation, ``Point_MAE`` in
train mode (a random 60% of the groups masked, the Chamfer loss of their
rebuild), backward, AdamW over every parameter. Validation is the linear
SVM probe over the encoder's features (``svm_probe``), when the config has
an ``extra_train`` and a ``val`` split. Over several ranks each trains on
its shard of every batch (``parallel.shard``); the probe's features are
gathered from every rank before the fit, as
``upp_tpu/train/runner_pretrain.py:59-103`` gathers them.
"""

from __future__ import annotations

import time
import types
from typing import Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..data import build_dataset_from_cfg
from ..ops.fps import fps
from ..parallel import shard
from ..parallel.dist import broadcast_object, gather_samples, get_dist_info, reduce_mean
from ..utils.logger import get_logger, print_log
from . import checkpoint as ckpt
from .metrics import AccMetric, AverageMeter
from .optim import build_optimizer, count_params, step_generator
from .pipeline import AugmentDraws, resolve_augmentation
from .runner_cls import init_model, sharded_loader


def make_pretrain_step(model, optimizer, config, args):
    """``train_step(pts [B, N, 3], draws=None, masks=None) -> {"loss"}``, a
    0-d tensor on pts' device, unsynced (``upp_tpu/train/runner_pretrain.py:26-53``).
    The augmentation draws, the group mask and drop-path come, unless
    given (``draws``: ``AugmentDraws``; ``masks``: (visible, masked) group
    indices), from a device generator seeded from ``args.seed + 777`` and
    the optimizer's count of calls (``optim.step_generator``); over several
    ranks drawn for the global batch, whose loss it returns
    (``parallel.shard``)."""
    npoints = int(config.npoints)
    augment = resolve_augmentation(config.get("data_augmentation", "scale-translate"))
    seed = int(getattr(args, "seed", 0)) + 777
    gens = {}                       # the device generator, made at the first step

    def train_step(pts: torch.Tensor, draws: Optional[AugmentDraws] = None,
                   masks: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        gen = step_generator(gens, pts.device, seed, optimizer.calls)
        model.train()
        with shard.global_batch(shard.this_rank(), gen):
            points, _ = fps(pts, npoints)
            if augment is not None:
                points = augment(points, gen, draws)
            loss = model(points, masks=masks, generator=gen)
        optimizer.zero_grad()
        loss.backward()
        optimizer.step()
        return {"loss": reduce_mean(loss.detach())}

    return train_step


@torch.inference_mode()
def probe_features(model, loader, npoints: int, device: torch.device
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """(features [n, trans_dim], labels [n]) of every cloud of ``loader``
    on every rank, each once, in index order: FPS to ``npoints``, then
    ``Point_MAE``'s eval features on running BatchNorm statistics; fetched
    once, after the sweep, then gathered."""
    model.eval()
    feats, labels, idxs = [], [], []
    for idx, (pts, label) in loader.iter_indexed():
        points, _ = fps(torch.from_numpy(pts).to(device), npoints)
        feats.append(model(points, eval_features=True))
        labels.append(np.asarray(label))
        idxs.append(idx)
    _, (feats, labels) = gather_samples(np.concatenate(idxs), torch.cat(feats).cpu().numpy(),
                                        np.concatenate(labels))
    return feats, labels


def svm_probe(model, train_loader, val_loader, npoints: int, device: torch.device,
              logger=None) -> float:
    """Accuracy (%) on ``val_loader`` of a linear SVM fitted to the frozen
    encoder's features of ``train_loader`` (``runner_pretrain.py:203-262``),
    both gathered from every rank; rank 0 fits, and every rank returns its
    accuracy (the fit draws from numpy's global RNG, which ranks need not
    share). Needs scikit-learn, imported here, as in JAX."""
    x_tr, y_tr = probe_features(model, train_loader, npoints, device)
    x_te, y_te = probe_features(model, val_loader, npoints, device)
    acc = None
    if get_dist_info()[0] == 0:
        from sklearn.svm import LinearSVC
        clf = LinearSVC(max_iter=2000)
        clf.fit(x_tr, y_tr)
        acc = float((clf.predict(x_te) == y_te).mean() * 100.0)
    acc = broadcast_object(acc)
    print_log(f"[SVM probe] acc = {acc:.4f}", logger=logger)
    return acc


def run_net(args, config, train_writer=None, val_writer=None) -> AccMetric:
    """Pretrain on ``args.device`` (CUDA unless the caller names another),
    epochs 0..max_epoch (``runner_pretrain.py:102-223``): the SVM probe
    every ``val_freq`` epochs after epoch 0 when the config has
    ``extra_train`` and ``val`` splits, each at its own batch size;
    ``ckpt-best`` on the probe's accuracy, ``ckpt-last`` every epoch and
    ``ckpt-epoch-XXX`` every 25 epochs from 250; a warm start from
    ``--start_ckpts`` (or ``--ckpts``) unless ``--resume``. The loss is
    fetched once per epoch. ``fsdp`` has no effect: over several ranks
    every rank holds the whole model and optimizer state (the same step as
    JAX's ZeRO-3 sharding, without its memory saving). The writers get the epoch's mean loss x1000
    (``Loss/Epoch/Loss_1``), its learning rate and the probe accuracy.
    Returns the best probe accuracy."""
    device = resolve_device(getattr(args, "device", None))
    logger = get_logger(getattr(args, "log_name", "upp_torch"))
    seed = int(getattr(args, "seed", 0))
    train_cfg = config.dataset.train
    train_loader = sharded_loader(build_dataset_from_cfg(train_cfg._base_, train_cfg.others),
                                  train_cfg.others.bs, shuffle=True, drop_last=True,
                                  seed=seed)
    extra_loader = val_loader = None
    if config.dataset.get("extra_train") and config.dataset.get("val"):
        extra_loader, val_loader = (
            sharded_loader(build_dataset_from_cfg(config.dataset[s]._base_,
                                                  config.dataset[s].others),
                           config.dataset[s].others.bs)
            for s in ("extra_train", "val"))

    resume = bool(getattr(args, "resume", False))
    warm = getattr(args, "start_ckpts", None) or getattr(args, "ckpts", None)
    model = init_model(types.SimpleNamespace(seed=seed, ckpts=None if resume else warm),
                       config, device, logger=logger)
    steps_per_epoch = max(len(train_loader), 1)
    optimizer = build_optimizer(config, model, steps_per_epoch)
    trainable, total = count_params(model)
    print_log(f"# TrainableParams: {trainable / 1e6:.2f} M / {total / 1e6:.2f} M",
              logger=logger)

    start_epoch, best = 0, AccMetric(0.0)
    if resume:
        start_epoch, saved = ckpt.resume_checkpoint(model, optimizer, args.experiment_path,
                                                    logger=logger,
                                                    steps_per_epoch=steps_per_epoch)
        best = AccMetric(saved.get("acc", 0.0))

    train_step = make_pretrain_step(model, optimizer, config, args)
    npoints = int(config.npoints)
    val_freq = max(int(getattr(args, "val_freq", 1) or 1), 1)
    for epoch in range(start_epoch, int(config.max_epoch) + 1):
        train_loader.set_epoch(epoch)
        meters = AverageMeter(["loss"])
        t0 = time.time()
        pending = [train_step(torch.from_numpy(batch[0]).to(device))
                   for batch in train_loader]
        for m in pending:              # one fetch per epoch keeps the queue full
            meters.update([float(m["loss"]) * 1000])
        print_log("[Training] EPOCH: %d EpochTime = %.3f (s) LossX1000 = %.4f" %
                  (epoch, time.time() - t0, meters.avg(0)), logger=logger)
        if train_writer is not None:
            train_writer.add_scalar("Loss/Epoch/Loss_1", meters.avg(0), epoch)
            train_writer.add_scalar("Loss/Epoch/LR",
                                    optimizer.sched(epoch * steps_per_epoch), epoch)
        if extra_loader is not None and epoch % val_freq == 0 and epoch != 0:
            acc = svm_probe(model, extra_loader, val_loader, npoints, device, logger=logger)
            print_log("[Validation] EPOCH: %d  acc = %.4f" % (epoch, acc), logger=logger)
            if val_writer is not None:
                val_writer.add_scalar("Metric/ACC", acc, epoch)
            if AccMetric(acc).better_than(best):
                best = AccMetric(acc)
                ckpt.save_checkpoint(model, optimizer, epoch, "ckpt-best",
                                     args.experiment_path, metrics=best.state_dict(),
                                     logger=logger)
        ckpt.save_checkpoint(model, optimizer, epoch, "ckpt-last", args.experiment_path,
                             metrics=best.state_dict(), logger=logger)
        if epoch % 25 == 0 and epoch >= 250:
            ckpt.save_checkpoint(model, optimizer, epoch, f"ckpt-epoch-{epoch:03d}",
                                 args.experiment_path, logger=logger)
    return best
