"""Classification evaluation (counterpart of the eval half of
``upp_tpu/train/runner_cls.py``: ``make_eval_step``, ``validate``,
``test_net``). Training, checkpoint loading and the vote arrive with the
training slice.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..data import BatchLoader, build_dataset_from_cfg
from ..models import build_model_from_cfg
from ..ops.corrupt import normalize_unit_sphere
from ..ops.fps import fps
from ..utils.logger import get_logger, print_log


def init_model(args, config, device: torch.device, logger=None):
    """Build the model from the config with weights from ``args.seed``,
    created on the CPU first so every device gets the same weights."""
    if getattr(args, "ckpts", None):
        raise NotImplementedError("loading --ckpts arrives with the training "
                                  "slice; omit it to evaluate a seeded init")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(int(getattr(args, "seed", 0)))
        model = build_model_from_cfg(config.model)
    print_log(f"Evaluating a seeded init (seed {getattr(args, 'seed', 0)})",
              logger=logger)
    return model.to(device).eval()


def make_eval_step(model, config, args):
    """``eval_step(pts [B, N, 3]) -> predicted class [B]``: FPS to
    ``npoints``, then the model, through the rectify and completion passes
    when the config sets ``noisy_validate``."""
    npoints = int(config.npoints)
    noisy_validate = bool(config.get("noisy_validate", False))
    normalize = bool(getattr(args, "normalize", False))

    @torch.inference_mode()
    def eval_step(pts: torch.Tensor) -> torch.Tensor:
        points, _ = fps(pts, npoints)
        if normalize:
            points = normalize_unit_sphere(points)
        logits = model(points, completion_prompt=noisy_validate,
                       denoise=noisy_validate, point_num=npoints)
        return logits.argmax(-1)

    return eval_step


def validate(eval_step, loader, device: torch.device, epoch: int,
             logger=None) -> float:
    """Accuracy (%) of ``eval_step`` over ``loader`` (single process)."""
    preds, labels = [], []
    for pts, label in loader:
        preds.append(eval_step(torch.from_numpy(pts).to(device)))
        labels.append(np.asarray(label))
    hit = (torch.cat(preds).cpu().numpy() == np.concatenate(labels)) if preds \
        else np.zeros((0,), bool)
    acc = float(hit.mean() * 100.0) if hit.size else 0.0
    print_log(f"[Validation] EPOCH: {epoch}  acc = {acc:.4f}", logger=logger)
    return acc


def test_net(args, config) -> float:
    """Evaluate on the config's test split (``runner_module.test_net``), on
    ``args.device`` (CUDA unless the caller names another device)."""
    if getattr(args, "vote", False):
        raise NotImplementedError("--vote arrives with the training slice")
    device = resolve_device(getattr(args, "device", None))
    logger = get_logger(getattr(args, "log_name", "upp_torch"))
    test_ds = build_dataset_from_cfg(config.dataset.test._base_,
                                     config.dataset.test.others)
    loader = BatchLoader(test_ds, config.dataset.test.others.bs)
    model = init_model(args, config, device, logger=logger)
    eval_step = make_eval_step(model, config, args)
    acc = validate(eval_step, loader, device, 0, logger=logger)
    print_log(f"[TEST] acc = {acc:.4f}", logger=logger)
    return acc
