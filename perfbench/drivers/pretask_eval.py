"""The prompter-pretraining validation sweep: host batches handed back to
back to ``upp_torch.train.runner_pretask.make_pretask_eval_step("easy")``
(the fixed-viewpoint crop, FPS of 128 centres, the completion pass, two
sparse and five dense Chamfer calls, the F-score); the per-sample
distances are fetched once, at the end of the window, inside it, as
``runner_pretask.validate`` does."""

from __future__ import annotations

import torch

from harness import common
from harness.cells import EvalCell
from reference import flops, model

CDS = ("sparse_l1", "sparse_l2", "dense_l1", "dense_l2")


class Cell(EvalCell):

    def make_step(self):
        from upp_torch.train import runner_pretask
        pcfg = common.program_config(self.cfg, self.T.get("recipe", {}))
        self.prog_step = runner_pretask.make_pretask_eval_step(self.prog_model, pcfg, "easy")

    def shapes(self):
        self.npoints = int(self.cfg["npoints"])
        self.num_crop = int(int(self.T["points"]) * float(self.T["crop_ratio"]))
        self.viewpoint = torch.tensor(self.T["viewpoint"], dtype=torch.float32)

    def weight_shapes(self):
        return model.param_shapes(self.cfg["model"])

    def flops(self):
        return flops.complete(self.cfg["model"], self.B)

    def run(self, x, i):
        self.kept.append((i, self.prog_step(x, self.viewpoint)))
        return len(self.kept) - 1

    def finish_all(self, outs):
        for j in outs:
            i, out = self.kept[j]
            batch = torch.stack([out["F-Score"], out["CDL1"], out["CDL2"]]).expand(self.B, 3)
            host = torch.cat([torch.stack([out[c] for c in CDS], 1), batch], 1).cpu()
            self.kept[j] = (i, {"cds": host[:, :len(CDS)], "fscore": float(host[0, -3]),
                                "cd_batch": host[0, -2:]})

    def compare_batch(self, answers, ref):
        """cd_gap: the worst relative gap of a sample's Chamfer distance or
        of the batch's Chamfer-L1 and -L2; fscore_gap: the batch F-score's
        absolute gap."""
        r = torch.stack([ref[c] for c in CDS], 1).cpu()
        rb = torch.stack([ref["cdl1"], ref["cdl2"]]).cpu()
        cd_gap = max(float(((answers["cds"] - r).abs() / r.abs().clamp_min(1e-30)).max()),
                     float(((answers["cd_batch"] - rb).abs() / rb.abs()).max()))
        return {"cd_gap": cd_gap, "fscore_gap": abs(answers["fscore"] - float(ref["fscore"].mean()))}

    def reference(self, i, P):
        from reference import train as rt
        return rt.pretask_eval(P, self.cfg["model"], self.batch(i), self.viewpoint,
                               self.num_crop, self.npoints)

    @staticmethod
    def as_answers(ref):
        """The reference's outputs in the form the program's answers take."""
        return {"cds": torch.stack([ref[c] for c in CDS], 1).cpu(),
                "fscore": float(ref["fscore"].mean()),
                "cd_batch": torch.stack([ref["cdl1"], ref["cdl2"]]).cpu()}
