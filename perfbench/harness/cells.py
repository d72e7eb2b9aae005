"""The two shapes of cell: a training loop (``TrainCell``) and an
evaluation loop (``EvalCell``). A driver (``drivers/<name>.py``) fills in
the program's step, the reference's step, the readings compared, the
weights' layout and the step's model FLOPs.

Every unit the program runs, in set-up, in the window and in the profiled
slice, goes through one loop (``loop``), so the profile describes the
window's own loop. A training cell builds one train step and runs
``warmup_steps + check_steps`` steps through that loop in set-up; the
reference follows all of them. Compared: each step's loss terms, the first
step's gradient as the optimizer used it (each trainable leaf's ``.grad``,
its norm taken on the device before the next step), and each leaf's change
over all the steps, read from the leaves themselves. The same step then
serves the window.
An evaluation cell keeps what the window's batches returned and holds a
sample of them, drawn from the seed, to the reference.
"""

from __future__ import annotations

import contextlib
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from . import common, inputs


@contextlib.contextmanager
def precision(tf32: bool):
    """float32 products, or TF32 ones (the control's precision)."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = m, c


class Window:
    """What a run of the loop did: units (steps or batches), clouds,
    seconds, host seconds inside each step call, each batch's latency
    (closed loops), and the time each unit was handed in."""

    def __init__(self):
        self.units = self.clouds = 0
        self.seconds = 0.0
        self.dispatch: List[float] = []
        self.latency: List[float] = []
        self.starts: List[float] = []

    def slices(self, n: int = 5) -> List[float]:
        """Units a second in each of ``n`` equal slices of the window."""
        if self.units < 2 or self.seconds <= 0:
            return []
        t0, width = self.starts[0], self.seconds / n
        counts = np.bincount(np.minimum(((np.array(self.starts) - t0) / width).astype(int),
                                        n - 1), minlength=n)
        return [round(float(c) / width, 2) for c in counts]


class Cell:
    """Shared by both shapes: the context, the pool, the device sync."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.phases = {}            # seconds of each set-up phase, for the record
        self.mark = time.time()
        self.dev = ctx.device
        self.T = ctx.traffic
        self.cfg = ctx.config
        self.B = int(self.T["batch"])
        self.pool, self.labels = inputs.make_clouds(
            int(self.T["pool"]), self.B, int(self.T["points"]), int(self.T.get("classes", 40)),
            ctx.seed, float(self.T.get("jitter", 0.0)), int(self.T.get("outliers", 0)))
        self.next = 0
        self.failed = 0             # units whose loss came back non-finite
        self.phase("pool")
        if self.dev.type == "cuda":
            torch.cuda.init()
            torch.empty(1, device=self.dev)
            self.phase("device")

    def phase(self, name: str):
        now = time.time()
        self.phases[name] = round(now - self.mark, 3)
        self.mark = now

    def sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def batch(self, i: int) -> torch.Tensor:
        """Pool entry ``i`` copied to the device as the runners copy a
        loader's batch."""
        return torch.from_numpy(self.pool[i % len(self.pool)]).to(self.dev)

    def weights(self) -> Dict[str, torch.Tensor]:
        """The seeded weights in the layout of the driver's reference model."""
        return inputs.make_weights(self.weight_shapes(), self.ctx.seed, self.dev)

    def flops(self) -> Optional[int]:
        """Model FLOPs of one unit (the driver's count), or None: no
        ``step_mfu`` then."""
        return None

    def release(self):
        """Drop the program's state, so the reference has the card."""
        for name in list(vars(self)):
            if name.startswith("prog_"):
                delattr(self, name)
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()


class TrainCell(Cell):
    """A training loop: ``make_step`` (the program's step, its model in
    ``self.prog_model``), ``step_call(x, y)``, ``drain(out)`` (a step's
    fetched loss terms, as floats), ``shapes()``, ``weight_shapes()`` and
    ``reference_step(P, s)`` come from the driver. ``program=False`` sets up
    the reference's side alone (the control)."""

    def __init__(self, ctx, program: bool = True):
        super().__init__(ctx)
        self.shapes()
        self.steps = int(self.T["warmup_steps"]) + int(self.T["check_steps"])
        W = self.weights()
        self.names = common.float_names(W, self.cfg["trainable"])
        if not program:
            return
        w0 = {n: W[n].detach().clone() for n in self.names}
        self.phase("weights")
        self.prog_model = common.program_model(self.cfg, W, self.dev)
        del W
        self.make_step()
        self.phase("model and step")
        params = dict(self.prog_model.named_parameters())
        grads: Dict[str, torch.Tensor] = {}

        def first_grad(step: int):
            if step == 0:
                grads.update({n: params[n].grad.norm() for n in self.names
                              if params[n].grad is not None})
        losses: List[List[float]] = []
        self.loop(units=self.steps, losses=losses, after=first_grad)
        change = {n: float((params[n].detach() - w0[n]).norm()) for n in self.names}
        self.readings = {"losses": losses, "grad": {n: float(g) for n, g in grads.items()},
                         "change": change}
        self.phase("warm-up and check steps")

    def loop(self, seconds: Optional[float] = None, units: Optional[int] = None,
             losses: Optional[list] = None, after=None) -> Window:
        """Steps dispatched as the runner dispatches them, each step's loss
        terms fetched ``lag`` steps later, for ``seconds`` or ``units``; the
        last steps' are fetched before the loop ends. ``losses`` collects
        the fetched terms in step order; ``after(step)`` runs after each
        step's dispatch."""
        w, pending = Window(), []
        t0 = time.perf_counter()
        while not w.units or (time.perf_counter() - t0 < seconds if units is None
                              else w.units < units):
            i = self.next
            self.next += 1
            a = time.perf_counter()
            w.starts.append(a)
            x, y = self.batch(i), self.label(i)
            b = time.perf_counter()
            pending.append(self.step_call(x, y))
            w.dispatch.append(time.perf_counter() - b)
            if after is not None:
                after(w.units)
            w.units += 1
            if len(pending) > self.lag:
                self._fetch(pending.pop(0), losses)
        for out in pending:
            self._fetch(out, losses)
        w.seconds = time.perf_counter() - t0
        w.clouds = w.units * self.B
        return w

    def _fetch(self, out, losses):
        terms = self.drain(out)
        self.failed += not all(np.isfinite(terms))
        if losses is not None:
            losses.append(terms)

    def window(self, seconds: float) -> Window:
        return self.loop(seconds=seconds)

    def profiled(self, steps: int):
        self.loop(units=steps)

    def label(self, i: int) -> Optional[torch.Tensor]:
        return None

    # -- the check --------------------------------------------------------------
    def reference_readings(self, tf32: bool = False) -> Dict:
        """The reference's readings over the same steps, from the seed."""
        from reference import train as rt
        P = self.weights()
        w0 = {n: P[n].detach().clone() for n in self.names}
        for n in self.names:
            P[n].requires_grad_(True)
        opt = self.cfg["optimizer"]["kwargs"]
        adam = rt.AdamW({n: P[n] for n in self.names}, float(opt.get("weight_decay", 0.0)),
                        self.cfg.get("grad_norm_clip"))
        losses, grad = [], {}
        with precision(tf32):
            for s in range(self.steps):
                loss, terms = self.reference_step(P, s)
                grads = torch.autograd.grad(loss, [P[n] for n in self.names], allow_unused=True)
                lr = rt.cosine_lr(opt, self.cfg["scheduler"]["kwargs"], s,
                                  int(self.cfg["steps_per_epoch"]))
                used = adam.step(dict(zip(self.names, grads)), lr)
                losses.append([float(t) for t in terms])
                if s == 0:
                    grad = {n: float(g.norm()) for n, g in used.items()}
                del loss, terms, grads, used
        change = {n: float((P[n].detach() - w0[n]).norm()) for n in self.names}
        return {"losses": losses, "grad": grad, "change": change}

    def compare(self, prog: Dict, ref: Dict) -> Dict[str, float]:
        """loss_gap: the worst relative gap of a loss term over all the
        steps; grad_gap: the worst leaf's gap of the first gradient's norms;
        change_gap: the worst leaf's gap of the norms of the change over all
        the steps, over the leaves whose first reference gradient is at
        least a thousandth of the median leaf's (the others move by
        round-off). Leaf gaps as ``common.leaf_gap``."""
        loss_gap = max(common.rel_gap(p, r) for ps, rs in zip(prog["losses"], ref["losses"])
                       for p, r in zip(ps, rs))
        if len(prog["losses"]) != len(ref["losses"]):
            loss_gap = max(loss_gap, 1.0)
        g = ref["grad"]
        med = float(np.median(list(g.values()))) if g else 0.0
        moved = {n for n, v in g.items() if v >= 1e-3 * med}
        return {"loss_gap": loss_gap, "grad_gap": common.leaf_gap(prog["grad"], g),
                "change_gap": common.leaf_gap(prog["change"], ref["change"], keep=moved)}

    def check(self) -> Dict[str, float]:
        ref = self.reference_readings()
        print(f"perfbench: losses program {self.readings['losses']} reference {ref['losses']}",
              file=sys.stderr)
        return self.compare(self.readings, ref)


class EvalCell(Cell):
    """An evaluation loop: ``make_step`` (``self.prog_step``), ``run(x, i)``
    (one batch through the program, what it returns kept), ``finish_all(outs)``,
    ``shapes()``, ``weight_shapes()``, ``reference(i, P)``,
    ``compare_batch(answers, ref)`` and ``as_answers(ref)`` (the control's
    answers) come from the driver. ``program=False`` sets up the
    reference's side alone (the control)."""

    closed_loop = False

    def __init__(self, ctx, program: bool = True):
        super().__init__(ctx)
        self.shapes()
        if not program:
            return
        W = self.weights()
        self.phase("weights")
        self.prog_model = common.program_model(self.cfg, W, self.dev)
        del W
        self.make_step()
        self.phase("model and step")
        self.kept: List = []           # (pool index, the program's answers) a batch
        self.loop(units=int(self.T["warmup_batches"]))
        self.kept.clear()
        self.sync()
        self.phase("warm-up")

    def loop(self, seconds: Optional[float] = None, units: Optional[int] = None) -> Window:
        """Batches for ``seconds`` or ``units``: closed loop (each batch's
        answers on the host before the next is handed in) or back to back
        (fetched once, at the end, inside the loop)."""
        w, outs = Window(), []
        t0 = time.perf_counter()
        while not w.units or (time.perf_counter() - t0 < seconds if units is None
                              else w.units < units):
            i = self.next
            self.next += 1
            a = time.perf_counter()
            w.starts.append(a)
            x = self.batch(i)
            b = time.perf_counter()
            out = self.run(x, i)
            w.dispatch.append(time.perf_counter() - b)
            if self.closed_loop:
                self.finish_all([out])
                w.latency.append(time.perf_counter() - a)
            else:
                outs.append(out)
            w.units += 1
        if outs:
            self.finish_all(outs)
        w.seconds = time.perf_counter() - t0
        w.clouds = w.units * self.B
        return w

    def window(self, seconds: float) -> Window:
        w = self.loop(seconds=seconds)
        self.window_units = w.units
        return w

    def profiled(self, batches: int):
        self.loop(units=batches)

    def check(self) -> Dict[str, float]:
        """The worst of each compared number over a sample of the window's
        batches drawn from the seed, the last batch among them."""
        n = self.window_units
        pick = set(inputs.sample(self.ctx.seed, max(n - 1, 1), int(self.T["check_batches"]) - 1))
        pick.add(n - 1)
        P = self.weights()
        worst: Dict[str, float] = {}
        for j in sorted(pick):
            i, answers = self.kept[j]
            for k, v in self.compare_batch(answers, self.reference(i, P)).items():
                worst[k] = max(worst.get(k, 0.0), v)
        return worst
