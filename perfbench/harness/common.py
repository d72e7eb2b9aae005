"""What the drivers share: the program's model and config built from a
configuration file, the benchmark's weights loaded into it, and the
numbers the checks compare."""

from __future__ import annotations

import copy
import statistics
from typing import Dict, List, Sequence

import torch


def program_config(cfg: Dict, recipe: Dict):
    """The configuration file as the program reads it, with the traffic's
    recipe keys (e.g. ``noisy_validate``) laid over it."""
    from upp_torch.utils.config import to_config
    d = copy.deepcopy({k: v for k, v in cfg.items()
                       if k not in ("source", "paper", "synthetic", "deployment", "trainable",
                                    "steps_per_epoch", "steps_per_epoch_why", "reduced")})
    d.update(recipe)
    return to_config(d)


def program_model(cfg: Dict, weights: Dict[str, torch.Tensor], device):
    """The program's model for the configuration, built by its runners'
    set-up (``runner_cls.init_model``), then holding ``weights``."""
    from upp_torch.train.runner_cls import init_model
    from upp_torch.utils.config import ConfigDict
    model = init_model(ConfigDict(seed=0), program_config(cfg, {}), device)
    model.load_state_dict(weights, strict=True)
    return model


def float_names(P: Dict[str, torch.Tensor], targets: Sequence[str]) -> List[str]:
    """Trainable names: those matching ``targets`` that are parameters
    (BatchNorm statistics are not)."""
    return [n for n in P if any(t in n for t in targets)
            and not n.endswith(("running_mean", "running_var", "num_batches_tracked"))]


def rel_gap(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float], keep=None) -> float:
    """Worst leaf's |‖program‖ - ‖reference‖| over the larger of that leaf's
    reference norm and the median leaf's; ``keep`` limits the leaves. A leaf
    the program lacks reads as 1."""
    names = [n for n in ref if keep is None or n in keep]
    if not names:
        return 0.0
    med = statistics.median(ref[n] for n in names)
    return max(abs(prog.get(n, 0.0) - ref[n]) / max(ref[n], med, 1e-30) for n in names)
