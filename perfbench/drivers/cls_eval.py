"""Robust classification, as ``cfgs/unify_real_sensors_cls.yaml`` runs it
(``noisy_validate``): one caller hands a host batch of noisy scans to
``upp_torch.train.runner_cls.make_eval_step`` (FPS to 1024, rectify with
the 5% drop, completion, downstream, argmax) and waits for the labels it
returns on the host before it sends the next.

The check judges the returned labels, and besides the logits behind them
where a forward hook on the model sees them: a label alone separates the
TF32 control on some seeds only (``PERF.md``). A step that runs the model
where no hook fires (a replayed CUDA graph) leaves the logits out, and its
labels are still judged."""

from __future__ import annotations

from harness import common
from harness.cells import EvalCell
from reference import flops, model


class Cell(EvalCell):
    closed_loop = True

    def make_step(self):
        from upp_torch.train import runner_cls
        from upp_torch.utils.config import ConfigDict
        pcfg = common.program_config(self.cfg, self.T.get("recipe", {}))
        self.prog_step = runner_cls.make_eval_step(self.prog_model, pcfg, ConfigDict())
        self.prog_logits = []
        self.prog_hook = self.prog_model.register_forward_hook(
            lambda module, args, out: self.prog_logits.append(out))

    def shapes(self):
        self.npoints = int(self.cfg["npoints"])

    def weight_shapes(self):
        return model.param_shapes(self.cfg["model"])

    def flops(self):
        return flops.classify(self.cfg["model"], self.B, self.npoints, train=False)

    def run(self, x, i):
        labels = self.prog_step(x)
        logits = self.prog_logits[-1] if self.prog_logits else None
        self.prog_logits.clear()
        self.kept.append((i, {"labels": labels, "logits": logits}))
        return len(self.kept) - 1

    def finish_all(self, outs):
        for j in outs:
            answers = self.kept[j][1]
            answers["labels"] = answers["labels"].cpu()

    def compare_batch(self, answers, ref):
        """label_gap: the widest gap, over the batch's clouds, by which the
        reference's logit of the returned label lies below the reference's
        largest logit; logit_gap (where the hook saw the logits): the
        widest gap of a logit; both over that cloud's largest absolute
        reference logit."""
        ref = ref.float()
        scale = ref.abs().amax(-1)
        labels = answers["labels"].to(ref.device).long()
        gap = ref.amax(-1) - ref.gather(1, labels[:, None])[:, 0]
        out = {"label_gap": float((gap / scale).max())}
        if answers.get("logits") is not None:
            diff = (answers["logits"].float().to(ref.device) - ref).abs().amax(-1)
            out["logit_gap"] = float((diff / scale).max())
        return out

    def reference(self, i, P):
        from reference import train as rt
        return rt.cls_eval_logits(P, self.cfg["model"], self.batch(i), self.npoints)

    @staticmethod
    def as_answers(ref):
        """The reference's logits ``ref`` and the labels they give, in the
        form the program's answers take."""
        return {"labels": ref.argmax(-1), "logits": ref}
