"""Checkpoint save and resume (counterpart of ``upp_tpu/train/checkpoint.py``;
reference ``tools/builder.py:91-163``).

``<experiment_path>/<prefix>.pth`` holds the reference layout
``{base_model, optimizer, epoch, metrics}``: the model's state dict (the
reference ``.pth`` keys), the optimizer's state dict, the epoch just
finished and the metric dict. One process writes it (rank 0 of several),
through a temporary file and a rename, so a crash never leaves a torn
checkpoint. Every rank loads it whole: a checkpoint of N ranks is a
one-process checkpoint (the model unwrapped, no ``module.`` prefix), and
loads into any number of ranks. A ZeRO-3 model (``parallel.fsdp``) is
gathered whole on every rank, synchronously and outside the writer
thread, before rank 0 writes, and a resume shards the whole file again
(``upp_tpu/train/checkpoint.py:96-109``, ``runner_pretrain.py:170-177``).

``save_checkpoint`` is asynchronous by default, as in the JAX package: the
state is copied on its device at once (the next optimizer step writes the
parameters and moments in place), and the copy is written to disk by one
writer thread per path. A save issued while that path's write is in flight
does not wait: it replaces any snapshot still queued for the path
(latest-wins, what overwriting ``ckpt-last`` means) and the writer picks it
up next. ``wait_for_pending_saves`` joins the writers, re-raises the first
failed write and then waits for every rank, so no rank reads a
half-written file; the runners call it at their end, and every load of a
checkpoint (``resume_checkpoint``, ``ckpt_io.load_weights``) calls it
first. No collective runs on a writer thread.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from ..parallel import fsdp
from ..parallel.dist import barrier, get_dist_info
from ..utils.logger import print_log

# path -> (the writer thread of its chain, the chain's error box); a failed
# write lands in the box and surfaces on the next join
_PENDING: Dict[str, Tuple[threading.Thread, List[BaseException]]] = {}
_QUEUED: Dict[str, Callable[[], None]] = {}   # path -> newest write not yet started
# path -> the entry of a chain that ended after a failed write, which the next
# join re-raises (the first such chain of a path)
_FAILED: Dict[str, Tuple[threading.Thread, List[BaseException]]] = {}
_PENDING_LOCK = threading.Lock()


def checkpoint_path(experiment_path: str, prefix: str) -> str:
    return os.path.join(experiment_path, f"{prefix}.pth")


def _join_writer(t: threading.Thread, err_box: list, path: str) -> None:
    t.join()
    if err_box:
        raise RuntimeError(f"async checkpoint write to {path} failed") from err_box[0]


def wait_for_pending_saves() -> None:
    """Block until every in-flight checkpoint write has landed, re-raise the
    first failed one (a run must not finish reporting checkpoints that were
    never written), then wait for every rank."""
    with _PENDING_LOCK:
        pending = [*_FAILED.items(), *_PENDING.items()]
        _PENDING.clear()
        _FAILED.clear()
    first = None
    for path, (t, err_box) in pending:
        try:
            _join_writer(t, err_box, path)
        except RuntimeError as e:
            first = first or e
    if first is not None:
        raise first
    barrier()


def _snapshot(obj):
    """A copy of every tensor in a nested dict / list / tuple, on its
    device."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().clone()
    if isinstance(obj, dict):
        return {k: _snapshot(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_snapshot(v) for v in obj)
    return obj


def save_checkpoint(model: nn.Module, optimizer, epoch: int, prefix: str,
                    experiment_path: str, metrics: Optional[Dict] = None,
                    logger=None, block: bool = False) -> str:
    """Write the checkpoint from rank 0 (every rank holds the same state);
    every rank calls it at the same points of the run. By default the write
    runs on the path's writer thread (see the module's doc); ``block=True``
    writes before returning, after any write in flight on the path, and
    then waits for every rank."""
    path = checkpoint_path(experiment_path, prefix)
    if fsdp.is_sharded(model):      # a collective: every rank, on this thread
        model_state = fsdp.full_state_dict(model)
        optimizer_state = fsdp.full_optimizer_state_dict(model, optimizer)
    if get_dist_info()[0] != 0:
        if block:
            barrier()
        return path
    os.makedirs(experiment_path, exist_ok=True)
    if not fsdp.is_sharded(model):
        model_state = _snapshot(model.state_dict())
        optimizer_state = _snapshot(optimizer.state_dict())
    payload = {"base_model": model_state, "optimizer": optimizer_state,
               "epoch": int(epoch), "metrics": dict(metrics or {})}
    err_box: List[BaseException] = []

    def write():
        try:
            tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
            torch.save(payload, tmp)
            os.replace(tmp, path)
        except BaseException as e:  # surfaced on the next join of this path
            err_box.append(e)
            print_log(f"[CKPT] save to {path} FAILED: {e!r}", logger=logger)
            raise

    if block:
        # never two writers on one path: finish the chain first, and drop a
        # queued older snapshot, which this state supersedes
        with _PENDING_LOCK:
            prev = _PENDING.pop(path, None)
            _QUEUED.pop(path, None)
        if prev is not None:
            _join_writer(*prev, path)
        write()
        print_log(f"Save checkpoint at {path}", logger=logger)
        barrier()
        return path

    with _PENDING_LOCK:
        if path in _PENDING:
            chain_box = _PENDING[path][1]

            def queued_write(w=write, box=chain_box):
                try:
                    w()
                except BaseException as e:
                    box.append(e)

            _QUEUED[path] = queued_write
        else:
            def chain_loop(first=write):
                w = first
                while True:
                    try:
                        w()
                    except BaseException:
                        pass  # already in the chain's error box
                    with _PENDING_LOCK:
                        w = _QUEUED.pop(path, None)
                        if w is None:
                            # a join that took the entry already reports it
                            mine = _PENDING.get(path)
                            if mine is not None and mine[0] is threading.current_thread():
                                del _PENDING[path]
                                if mine[1]:
                                    _FAILED.setdefault(path, mine)
                            return

            t = threading.Thread(target=chain_loop, name=f"ckpt-writer {path}")
            _PENDING[path] = (t, err_box)
            t.start()
    print_log(f"Save checkpoint at {path}", logger=logger)
    return path


def resume_checkpoint(model: nn.Module, optimizer, experiment_path: str,
                      prefix: str = "ckpt-last", logger=None,
                      steps_per_epoch: int = 0) -> Tuple[int, Dict]:
    """Load a checkpoint written by ``save_checkpoint`` into ``model`` and
    ``optimizer``; returns (start_epoch = saved epoch + 1, metrics). Without
    a checkpoint: (0, {}). An optimizer state saved without its step count
    resumes at ``start_epoch * steps_per_epoch`` steps. Waits for pending
    saves first."""
    wait_for_pending_saves()
    path = checkpoint_path(experiment_path, prefix)
    if not os.path.exists(path):
        print_log(f"[RESUME] no checkpoint at {path}", logger=logger)
        return 0, {}
    state = torch.load(path, map_location="cpu", weights_only=True)
    start_epoch = int(state["epoch"]) + 1
    num_steps = start_epoch * steps_per_epoch
    if fsdp.is_sharded(model):
        fsdp.load_full_state(model, state["base_model"], optimizer, state["optimizer"],
                             num_steps=num_steps)
    else:
        model.load_state_dict(state["base_model"], strict=True)
        optimizer.load_state_dict(state["optimizer"], num_steps=num_steps)
    print_log(f"[RESUME] restored ckpt @ epoch {state['epoch']}", logger=logger)
    return start_epoch, dict(state.get("metrics") or {})
