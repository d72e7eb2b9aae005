"""Classification PEFT training, the loop body of
``upp_torch.train.runner_cls.run_net``: a host batch copied to the card
each step, ``make_train_step`` (viewpoint crop, lidar and shell noise,
scale-translate, the rectify, completion and downstream passes,
cross-entropy, AdamW over the PEFT set), metrics fetched ``FETCH_LAG``
steps after their dispatch."""

from __future__ import annotations

import torch

from harness import common, inputs
from harness.cells import TrainCell
from reference import flops, model


class Cell(TrainCell):

    def make_step(self):
        from upp_torch.train import runner_cls
        from upp_torch.train.optim import build_optimizer, set_trainable
        from upp_torch.utils.config import ConfigDict
        pcfg = common.program_config(self.cfg, self.T.get("recipe", {}))
        set_trainable(self.prog_model, runner_cls.PEFT_LIST)
        opt = build_optimizer(pcfg, self.prog_model, int(self.cfg["steps_per_epoch"]))
        self.prog_step = runner_cls.make_train_step(self.prog_model, opt, pcfg,
                                                    ConfigDict(seed=self.ctx.program_seed))
        self.lag = runner_cls.FETCH_LAG

    def shapes(self):
        self.npoints = int(self.cfg["npoints"])
        self.num_crop = int(int(self.T["points"]) * 0.25)

    def weight_shapes(self):
        return model.param_shapes(self.cfg["model"])

    def flops(self):
        """The PEFT step (``PEFT_LIST`` trainable), the rectify pass over
        the cropped cloud with its lidar and shell points."""
        return flops.classify(self.cfg["model"], self.B,
                              self.npoints + inputs.CLS_LIDAR + inputs.CLS_SHELL, train=True)

    def label(self, i):
        return torch.from_numpy(self.labels[i % len(self.labels)]).to(self.dev)

    def step_call(self, x, y):
        return self.prog_step(x, y)

    def drain(self, out):
        loss, _ = float(out["loss"]), float(out["acc"])
        return [loss]

    def reference_step(self, P, s):
        from reference import train as rt
        gen = inputs.recipe_generator(self.ctx.program_seed, s, self.dev)
        draws = inputs.cls_draws(gen, self.B, self.npoints, self.dev)
        loss = rt.cls_train_loss(P, self.cfg["model"], self.batch(s), self.label(s), draws, gen,
                                 self.npoints, self.num_crop)
        return loss, [loss.detach()]
