"""``--ckpts``: load a ``.pth`` into a model, non-strictly (counterpart of
``upp_tpu/train/ckpt_io.py:97-125``; reference ``tools/builder.py:138-163``
and ``load_model_from_ckpt``, ``models/Point_MAE_unify.py:505-536``).

The port's modules carry the reference's ``.pth`` key names, so the
reference's released checkpoints and the port's own (``checkpoint.py``, the
pretask phase's ``ckpt-best.pth``) load with the reference's key clean-up
alone: the state dict is ``base_model``, else ``model``, else the whole
dict; ``module.`` is stripped, ``_block`` dropped, and a leading
``MAE_encoder.`` or ``base_model.`` stripped unless the model has the key
as it is: ``Point_MAE`` keeps ``MAE_encoder.*`` (a warm start of the
pretraining, as the reference's ``builder.load_model``), while
``PointTransformer`` takes the same file's backbone stripped (the
reference's fine-tune recipe). A key the model lacks, or
whose shape differs from the model's, is reported as unexpected, never
fatal; a model key the checkpoint does not fill is reported as missing
(``load_state_dict(strict=False)``'s report).
"""

from __future__ import annotations

import warnings
from typing import Container, Dict, List, Tuple

import torch
from torch import nn

from ..utils.logger import print_log


def load_torch_state_dict(path: str, keep: Container[str] = ()
                          ) -> Dict[str, torch.Tensor]:
    """The state dict of the ``.pth`` at ``path``, keys cleaned up as the
    reference does (``Point_MAE_unify.py:505-516``); a key in ``keep`` keeps
    its prefix."""
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        # legacy pickle checkpoints need the unsafe loader, which runs the
        # file's pickle code: only load trusted checkpoints
        warnings.warn(f"{path}: falling back to torch.load(weights_only=False) "
                      "(legacy pickle format; only load trusted checkpoints)")
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
    state = ckpt.get("base_model", ckpt.get("model", ckpt))
    out = {}
    for k, v in state.items():
        k = k.replace("module.", "").replace("_block", "")
        for prefix in ("MAE_encoder.", "base_model."):
            if k not in keep and k.startswith(prefix):
                k = k[len(prefix):]
                break
        out[k] = v
    return out


def load_weights(model: nn.Module, path: str, logger=None) -> Tuple[List[str], List[str]]:
    """Load the ``.pth`` at ``path`` into ``model``, after every pending
    checkpoint write has landed; logs and returns (missing, unexpected) keys
    (the first 20 of each are logged)."""
    from .checkpoint import wait_for_pending_saves
    wait_for_pending_saves()
    own = model.state_dict()
    fit, unexpected = {}, []
    for k, v in load_torch_state_dict(path, keep=own).items():
        if k not in own:
            unexpected.append(k)
        elif tuple(v.shape) != tuple(own[k].shape):
            unexpected.append(f"{k} (shape {tuple(v.shape)} vs model {tuple(own[k].shape)})")
        else:
            fit[k] = v
    model.load_state_dict(fit, strict=False)
    missing = [k for k in own if k not in fit]
    print_log(f"[ckpt_io] loaded {len(fit)} tensors from {path}; {len(missing)} "
              f"missing, {len(unexpected)} unexpected", logger=logger)
    if missing:
        print_log(f"missing_keys ({len(missing)}): {missing[:20]}...", logger=logger)
    if unexpected:
        print_log(f"unexpected_keys ({len(unexpected)}): {unexpected[:20]}...",
                  logger=logger)
    return missing, unexpected
