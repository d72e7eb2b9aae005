"""Plain PyTorch reference of UPP's steps: the corruption of a batch, the
losses, gradient clipping and AdamW, and the four steps the benchmark
times (classification PEFT training, prompter pretraining, robust
classification, completion evaluation).

Every random number is an input: the corruption's draws as a dict, the
model's masks from the generator handed in (``model.Draws``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from . import ops
from .model import Draws, Net

BETAS, ADAM_EPS = (0.9, 0.999), 1e-8


def trainable(names: Sequence[str], targets: Sequence[str]) -> List[str]:
    """The names that contain one of ``targets`` (the PEFT rule)."""
    return [n for n in names if any(t in n for t in targets)]


def cosine_lr(opt: dict, sched: dict, step: int, steps_per_epoch: int) -> float:
    """CosLR stepped per epoch (timm's CosineLRScheduler, lr_min and the
    warm-up start 1e-6, the cosine over the raw epoch)."""
    base = float(opt["lr"])
    epoch = step // max(steps_per_epoch, 1)
    warm = int(sched.get("initial_epochs", 0))
    if epoch < warm:
        return 1e-6 + (base - 1e-6) * epoch / max(warm, 1)
    t = min(max(epoch / max(int(sched["epochs"]), 1), 0.0), 1.0)
    return 1e-6 + 0.5 * (base - 1e-6) * (1.0 + math.cos(math.pi * t))


class AdamW:
    """AdamW over the named tensors ``params`` (torch's update, in its
    order of operations), weight decay off for 1-D tensors, biases and
    names with "token"; an optional clip of the global gradient norm."""

    def __init__(self, params: Dict[str, torch.Tensor], weight_decay: float, clip=None):
        self.params, self.clip, self.step_count = params, clip, 0
        self.wd = {n: 0.0 if (p.dim() == 1 or n.endswith(".bias") or "token" in n)
                   else weight_decay for n, p in params.items()}
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor], lr: float) -> Dict[str, torch.Tensor]:
        """One update of the tensors that have a gradient (a tensor the loss
        does not reach keeps its value and its moments); returns the
        gradients as the update used them."""
        grads = {n: g for n, g in grads.items() if g is not None}
        if self.clip is not None:
            norm = torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(g, 2.0) for g in grads.values()]), 2.0)
            coef = torch.clamp(self.clip / (norm + 1e-6), max=1.0)
            grads = {n: g * coef for n, g in grads.items()}
        self.step_count += 1
        t = self.step_count
        b1, b2 = BETAS
        for n, g in grads.items():
            p = self.params[n]
            p.mul_(1.0 - lr * self.wd[n])
            self.m[n].lerp_(g, 1.0 - b1)
            self.v[n].mul_(b2).addcmul_(g, g, value=1.0 - b2)
            denom = (self.v[n].sqrt() / math.sqrt(1.0 - b2 ** t)).add_(ADAM_EPS)
            p.addcdiv_(self.m[n], denom, value=-lr / (1.0 - b1 ** t))
        return grads


def corrupt_cls(pts, draws: dict, npoints: int, num_crop: int) -> torch.Tensor:
    """The classification training corruption: viewpoint crop to
    ``npoints``, 48 lidar points pushed out by U(1.2, 1.5), 24 shell points
    (scale 0.1, radius 0.9), then scale-translate."""
    points = ops.crop(pts, num_crop, draws["viewpoints"], npoints)
    points = torch.cat([points, ops.lidar_noise(points, draws["lidar_idx"],
                                                draws["lidar_factor"])], 1)
    points = torch.cat([points, ops.shell_noise(draws["shell_normal"], 0.1, 0.9)], 1)
    return ops.scale_translate(points, draws["aug_scale"], draws["aug_shift"])


def cross_entropy(logits, labels) -> torch.Tensor:
    return -F.log_softmax(logits, dim=-1).gather(1, labels.long()[:, None]).mean()


def cls_train_loss(P, cfg, pts, labels, draws, generator, npoints, num_crop):
    """Loss of one classification PEFT step (train mode, robust passes)."""
    net = Net(P, cfg, Draws(generator))
    points = corrupt_cls(pts, draws, npoints, num_crop)
    return cross_entropy(net.classify(points, npoints), labels)


@torch.no_grad()
def cls_eval_logits(P, cfg, pts, npoints: int) -> torch.Tensor:
    """Logits of robust classification: FPS to ``npoints``, then the
    rectify, completion and downstream passes in eval mode."""
    return Net(P, cfg).classify(ops.fps(pts, npoints)[0], npoints)


@torch.no_grad()
def pretask_eval(P, cfg, gt, viewpoint, num_crop: int, npoints: int) -> Dict[str, torch.Tensor]:
    """Per-sample Chamfer distances x1000 of the fixed-viewpoint crop's
    completion against the whole cloud, the per-sample F-score, and the
    batch's Chamfer-L1 and -L2 x1000."""
    partial = ops.crop(gt, num_crop, viewpoint, npoints)
    centers, _ = ops.fps(partial, 128)
    pred_center, rebuild = Net(P, cfg).complete(partial)
    coarse = torch.cat([centers, pred_center], 1)
    dense = torch.cat([partial, rebuild], 1)
    return {"sparse_l1": ops.chamfer_l1_per_sample(coarse, gt) * 1000,
            "sparse_l2": ops.chamfer_l2_per_sample(coarse, gt) * 1000,
            "dense_l1": ops.chamfer_l1_per_sample(dense, gt) * 1000,
            "dense_l2": ops.chamfer_l2_per_sample(dense, gt) * 1000,
            "fscore": ops.fscore(dense, gt),
            "cdl1": ops.chamfer_l1(dense, gt) * 1000,
            "cdl2": ops.chamfer_l2_per_sample(dense, gt).mean() * 1000}
