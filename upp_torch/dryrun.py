"""Driver entry points of the port (counterpart of ``__graft_entry__.py``).

``entry()``             -> (forward function, its arguments): the flagship
                           ``Point_MAE_unify`` at full width, the noisy
                           three-pass forward (rectify, completion,
                           downstream) at batch 8.
``dryrun_multichip(n)`` -> the tiny flagship PEFT train step (clip 10) on n
                           ranks under three placements, from the same
                           weights on the same data: data parallel over n;
                           data (n/2) x tensor parallel 2 (``parallel.tensor``);
                           ZeRO-3 over n (``parallel.fsdp``, ``min_size``
                           256). Each loss must be within 1e-3 of the data
                           parallel one, as in JAX.

Both run on CUDA unless the caller names another device, and never move to
the CPU on their own. ``dryrun_multichip`` starts its own n processes
(``python -m upp_torch.dryrun --worker``) and says which backend it chose:
gloo when the caller asks for the CPU, NCCL when the host has n cards,
otherwise gloo ranks sharing card 0 (NCCL takes one rank a card)."""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import types
from pathlib import Path

import numpy as np
import torch

from . import resolve_device
from .utils.config import ConfigDict, cfg_from_yaml_file

REPO = Path(__file__).resolve().parent.parent
POINT_NUM = 128                 # the dry run's npoints
N_POINTS_DS = 512               # its clouds' points
TOL = 1e-3
TIMEOUT_S = 900                 # a rank's three steps; the tiny model takes seconds


def _flagship_cfg(tiny: bool = False) -> ConfigDict:
    """The flagship model node of ``cfgs/unify_modelnet_cls.yaml``; the tiny
    variant overrides only the sizes (``__graft_entry__.py:44-65``)."""
    node = cfg_from_yaml_file(str(REPO / "cfgs" / "unify_modelnet_cls.yaml")).model.to_plain()
    if tiny:
        dim, depth, heads = 48, 4, 4
        node["transformer_config"].update(
            trans_dim=dim, encoder_dims=dim, depth=depth, num_heads=heads,
            decoder_depth=2, decoder_num_heads=heads)
        node.update(cls_dim=6, group_size=8, num_group=16)
        pc = node["prompter_config"]
        for key in ("rectify_prompts_depth", "rectify_depth", "pretask_prompts_depth",
                    "pretask_depth", "downstream_prompts_depth"):
            pc[key] = min(pc[key], depth)
        pc["downstream_prompts_num"] = 3
        pc["downstream_depth"] = depth
    return ConfigDict.from_nested(node)


def entry(device=None, tiny: bool = False):
    """(fn, (model, pts)): ``fn(model, pts)`` is the full noisy forward
    (rectify, completion, downstream) of the flagship at full width (the
    tiny sizes with ``tiny``) on ``pts`` [8, 1096, 3] of zeros (1024 points
    + 48 lidar + 24 shell), on ``device`` (CUDA unless named); logits [8,
    cls_dim]."""
    from .models import build_model_from_cfg
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_model_from_cfg(_flagship_cfg(tiny)).to(dev).eval()
    point_num = 1024
    pts = torch.zeros((8, point_num + 72, 3), device=dev)

    def fn(model, pts):
        with torch.inference_mode():
            return model(pts, completion_prompt=True, denoise=True, point_num=point_num)

    return fn, (model, pts)


def _step_config() -> ConfigDict:
    return ConfigDict.from_nested({
        "model": _flagship_cfg(tiny=True).to_plain(),
        "optimizer": {"type": "AdamW", "kwargs": {"lr": 5e-4, "weight_decay": 0.05}},
        "scheduler": {"type": "CosLR", "kwargs": {"epochs": 10, "initial_epochs": 1}},
        "dataset": {"train": {"_base_": {"N_POINTS": N_POINTS_DS}}},
        "npoints": POINT_NUM, "grad_norm_clip": 10,
        "noisy_train": True, "data_augmentation": "scale-translate"})


def placement_losses(device: torch.device) -> dict:
    """This rank's run of the three placements (a process group is up): the
    tiny PEFT step on ``2 * world`` seeded clouds, from the same seeded
    weights each time; the global loss of each."""
    from .parallel import fsdp, tensor
    from .parallel.dist import clear_grid, data_group, data_info, get_dist_info, make_grid, \
        model_group
    from .train.optim import build_optimizer, set_trainable
    from .train.runner_cls import PEFT_LIST, init_model, make_train_step
    n = get_dist_info()[1]
    config = _step_config()
    args = types.SimpleNamespace(seed=0, incomplete_cropping=True, noise=True,
                                 noise_type=("gaussian_noise", "lidar_noise"), normalize=False)
    B = 2 * n
    pts = np.random.default_rng(0).standard_normal((B, N_POINTS_DS, 3)).astype(np.float32)

    def run(place):
        if place == "tp":
            make_grid(2)
        model = init_model(args, config, device)
        set_trainable(model, PEFT_LIST)
        if place == "tp":
            tensor.shard_model(model, model_group())
        elif place == "fsdp":
            fsdp.shard_model(model, data_group(), min_size=256)
        step = make_train_step(model, build_optimizer(config, model, steps_per_epoch=10),
                               config, args)
        rank, world = data_info()
        b = B // world
        rows = slice(rank * b, (rank + 1) * b)
        m = step(torch.from_numpy(pts[rows]).to(device),
                 torch.zeros((b,), dtype=torch.int64, device=device))
        loss = float(m["loss"])
        clear_grid()
        return loss

    out = {"dp": run("dp")}
    if n >= 2 and n % 2 == 0:
        out["tp"] = run("tp")
    out["fsdp"] = run("fsdp")
    return out


def _free_port() -> str:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return str(sock.getsockname()[1])


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Run the three placements on ``n_devices`` ranks (processes started
    here) and print an ``OK`` line for each; raises when a rank fails, a
    loss is not finite or is more than 1e-3 from the data-parallel one.
    Returns the losses by placement."""
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= n_devices:
        backend, cards, how = "nccl", list(range(n_devices)), "a card a rank"
    elif dev.type == "cuda":
        backend, cards = "gloo", [0] * n_devices
        how = f"{torch.cuda.device_count()} card(s): the ranks share card 0"
    else:
        backend, cards, how = "gloo", [0] * n_devices, "the CPU, as asked"
    print(f"[dryrun_multichip] {n_devices} ranks over {backend} on {dev.type} ({how})",
          flush=True)
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = os.pathsep.join([str(REPO)] + [p for p in (env.get("PYTHONPATH"),) if p])
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    with tempfile.TemporaryDirectory(prefix="upp_dryrun_") as tmp:
        out = os.path.join(tmp, "losses.json")
        procs = []
        try:
            for r in range(n_devices):
                log = open(os.path.join(tmp, f"rank{r}.log"), "w")
                procs.append((log, subprocess.Popen(
                    [sys.executable, "-m", "upp_torch.dryrun", "--worker", out, dev.type,
                     backend],
                    env=dict(env, RANK=str(r), WORLD_SIZE=str(n_devices),
                             LOCAL_RANK=str(cards[r]), MASTER_ADDR="127.0.0.1",
                             MASTER_PORT=port),
                    stdout=log, stderr=subprocess.STDOUT, cwd=str(REPO))))
            for log, p in procs:
                p.wait(timeout=TIMEOUT_S)
        finally:
            for log, p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
                log.close()
        for r, (log, p) in enumerate(procs):
            if p.returncode != 0:
                tail = open(log.name).read()[-4000:]
                raise RuntimeError(f"dryrun_multichip({n_devices}) rank {r} failed "
                                   f"rc={p.returncode}:\n{tail}")
        losses = json.load(open(out))
    loss = losses["dp"]
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss in the multichip dry run: {loss}")
    print(f"[dryrun_multichip] n_devices={n_devices} OK, loss={loss:.4f}", flush=True)
    for key, label in (("tp", f"dp{n_devices // 2}xtp2"), ("fsdp", f"fsdp{n_devices}")):
        if key not in losses:
            continue
        got = losses[key]
        if not (np.isfinite(got) and abs(got - loss) < TOL):
            raise AssertionError(f"{label}: loss {got} vs data parallel {loss}")
        print(f"[dryrun_multichip] {label} OK, loss={got:.4f}", flush=True)
    return losses


def _worker(out: str, device: str, backend: str) -> None:
    from .parallel.dist import get_dist_info, init_dist
    if device == "cpu":
        torch.set_num_threads(2)        # small ops; the other ranks share the cores
    dev = resolve_device(init_dist("pytorch", device, backend=backend))
    losses = placement_losses(dev)
    if get_dist_info()[0] == 0:
        with open(out, "w") as f:
            json.dump(losses, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[1:2] != ["--worker"]:
        sys.exit("usage: python -m upp_torch.dryrun --worker OUT DEVICE BACKEND "
                 "(started by dryrun_multichip)")
    _worker(*sys.argv[2:5])
