"""Segmentation PEFT training, the loop body of
``upp_torch.train.runner_seg.run_net``: a host batch of clouds, their
categories and per-point part labels copied to the card each step,
``make_seg_train_step(..., unify=True)`` (scale-translate, the raw crop of
the 25% nearest a viewpoint, 24 shell and 64 lidar points, the rectify,
completion and downstream passes, the per-point head at the augmented
whole cloud, NLL, AdamW over ``SEG_PEFT_LIST``), the losses fetched once an
epoch: ``steps_per_epoch`` steps after their dispatch.

Part labels come from the seed's clouds by one rule: a cloud of category c
has ShapeNetPart's parts of c (``parts_per_category``, in category order,
numbered on from the categories before it), given to its points by height:
the point of z-rank r (0-based, ties in index order) of N takes part
``first(c) + min(r * n(c) // N, n(c) - 1)``."""

from __future__ import annotations

import numpy as np
import torch

from harness import common, inputs
from harness.cells import TrainCell
from reference import seg, step_flops

CROP_RATIO = 0.25


def part_labels(clouds: np.ndarray, categories: np.ndarray, parts_per_category) -> np.ndarray:
    """[..., N] int64 part labels of ``clouds`` [..., N, 3] by the height
    rule, from each cloud's category [...]."""
    n = np.asarray(parts_per_category)
    first = np.concatenate([[0], np.cumsum(n)[:-1]])
    N = clouds.shape[-2]
    rank = np.argsort(np.argsort(clouds[..., 2], axis=-1, kind="stable"), axis=-1,
                      kind="stable")
    count = n[categories][..., None]
    return first[categories][..., None] + np.minimum(rank * count // N, count - 1)


def seg_draws(gen: torch.Generator, B: int, points: int, device):
    """One seg step's corruption draws, in the recipe's order: scale and
    shift, crop viewpoints, shell normals (24 a cloud), then the lidar
    indices into the ``points`` of the crop with its shell points, and
    their factors (64)."""
    d = inputs._scale_shift(gen, B, device)
    d["viewpoints"] = inputs._unit(torch.randn((B, 3), generator=gen, device=device))
    d["shell_normal"] = torch.randn((B, seg.SHELL_NUM, 3), generator=gen, device=device)
    d["lidar_idx"] = torch.randint(0, points, (seg.LIDAR_NUM,), generator=gen, device=device)
    d["lidar_factor"] = 1.2 + (1.5 - 1.2) * torch.rand((seg.LIDAR_NUM,), generator=gen,
                                                       device=device)
    return d


class Cell(TrainCell):

    def make_step(self):
        from upp_torch.train import runner_seg
        from upp_torch.train.optim import build_optimizer, set_trainable
        from upp_torch.utils.config import ConfigDict
        pcfg = common.program_config(self.cfg, self.T.get("recipe", {}))
        set_trainable(self.prog_model, runner_seg.SEG_PEFT_LIST)
        opt = build_optimizer(pcfg, self.prog_model, int(self.cfg["steps_per_epoch"]))
        self.prog_step = runner_seg.make_seg_train_step(
            self.prog_model, opt, pcfg, ConfigDict(seed=self.ctx.program_seed), unify=True)
        self.lag = int(self.cfg["steps_per_epoch"])

    def shapes(self):
        self.points = int(self.T["points"])
        self.num_crop = int(self.points * CROP_RATIO)
        self.parts = part_labels(self.pool, self.labels, self.T["parts_per_category"])

    def weight_shapes(self):
        return seg.param_shapes(self.cfg["model"])

    def flops(self):
        return step_flops.segment(self.cfg["model"], self.B, self.points, self.num_crop)

    def label(self, i):
        j = i % len(self.labels)
        return (torch.from_numpy(self.labels[j]).to(self.dev),
                torch.from_numpy(self.parts[j]).to(self.dev))

    def step_call(self, x, y):
        return self.prog_step(x, *y)

    def drain(self, out):
        loss, _ = float(out["loss"]), float(out["acc"])
        return [loss]

    def reference_step(self, P, s):
        gen = inputs.recipe_generator(self.ctx.program_seed, s, self.dev)
        draws = seg_draws(gen, self.B, self.points - self.num_crop + seg.SHELL_NUM, self.dev)
        category, parts = self.label(s)
        loss = seg.train_loss(P, self.cfg["model"], self.batch(s), category, parts, draws, gen,
                              self.num_crop)
        return loss, [loss.detach()]
