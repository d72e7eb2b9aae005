"""Checkpoint save and resume (counterpart of ``upp_tpu/train/checkpoint.py``;
reference ``tools/builder.py:91-163``).

``<experiment_path>/<prefix>.pth`` holds the reference layout
``{base_model, optimizer, epoch, metrics}``: the model's state dict (the
reference ``.pth`` keys), the optimizer's state dict, the epoch just
finished and the metric dict. Written synchronously by one process (rank 0
of several), through a temporary file and a rename, so a crash never leaves
a torn checkpoint. Every rank loads it whole: a checkpoint of N ranks is a
one-process checkpoint (the model unwrapped, no ``module.`` prefix), and
loads into any number of ranks.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..parallel.dist import barrier, get_dist_info
from ..utils.logger import print_log


def checkpoint_path(experiment_path: str, prefix: str) -> str:
    return os.path.join(experiment_path, f"{prefix}.pth")


def save_checkpoint(model: nn.Module, optimizer, epoch: int, prefix: str,
                    experiment_path: str, metrics: Optional[Dict] = None,
                    logger=None) -> str:
    """Write the checkpoint (rank 0; every rank holds the same state), then
    wait for every rank, so none reads it before it is whole. Every rank
    calls it at the same points of the run."""
    path = checkpoint_path(experiment_path, prefix)
    if get_dist_info()[0] == 0:
        os.makedirs(experiment_path, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save({"base_model": model.state_dict(),
                    "optimizer": optimizer.state_dict(),
                    "epoch": int(epoch), "metrics": dict(metrics or {})}, tmp)
        os.replace(tmp, path)
        print_log(f"Save checkpoint at {path}", logger=logger)
    barrier()
    return path


def resume_checkpoint(model: nn.Module, optimizer, experiment_path: str,
                      prefix: str = "ckpt-last", logger=None,
                      steps_per_epoch: int = 0) -> Tuple[int, Dict]:
    """Load a checkpoint written by ``save_checkpoint`` into ``model`` and
    ``optimizer``; returns (start_epoch = saved epoch + 1, metrics). Without
    a checkpoint: (0, {}). An optimizer state saved without its step count
    resumes at ``start_epoch * steps_per_epoch`` steps."""
    path = checkpoint_path(experiment_path, prefix)
    if not os.path.exists(path):
        print_log(f"[RESUME] no checkpoint at {path}", logger=logger)
        return 0, {}
    state = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(state["base_model"], strict=True)
    start_epoch = int(state["epoch"]) + 1
    optimizer.load_state_dict(state["optimizer"], num_steps=start_epoch * steps_per_epoch)
    print_log(f"[RESUME] restored ckpt @ epoch {state['epoch']}", logger=logger)
    return start_epoch, dict(state.get("metrics") or {})
