"""Visualisation runner (counterpart of ``upp_tpu/train/runner_vis.py``;
reference ``tools/runner.py``): a ``Point_MAE`` over the test split, one
cloud at a time, writing each input cloud after FPS to ``npoints`` as
``vis/input-XXX.npy`` (and a ``.png`` where matplotlib imports) and logging
the masked-reconstruction Chamfer loss of a train-mode forward. Not on the
CLI, as in the JAX package."""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import resolve_device
from ..data import BatchLoader, build_dataset_from_cfg
from ..ops.fps import fps
from ..utils.logger import get_logger, print_log
from .runner_cls import init_model


def _render_png(path: str, cloud: np.ndarray) -> None:
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(projection="3d")
    ax.axis("off")
    ax.scatter(cloud[:, 0], cloud[:, 2], cloud[:, 1], s=2, c=cloud[:, 1], cmap="jet")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def test_net(args, config, max_items: int = 40) -> int:
    """Dump up to ``max_items`` clouds of the test split under
    ``args.experiment_path/vis`` (``tools/runner.py:53-127``), on
    ``args.device``; the model from ``args.seed`` and ``args.ckpts``.
    Returns the number written. The forward runs in train mode for its
    random group mask (drawn from a generator seeded by the item's number)
    and BatchNorm's batch statistics; the running statistics stay as
    loaded, as the JAX runner discards their update."""
    device = resolve_device(getattr(args, "device", None))
    logger = get_logger(getattr(args, "log_name", "upp_torch"))
    test_ds = build_dataset_from_cfg(config.dataset.test._base_, config.dataset.test.others)
    model = init_model(args, config, device, logger=logger)
    for m in model.modules():
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            m.momentum = 0.0
    model.train()
    npoints = int(config.npoints)
    out_dir = os.path.join(args.experiment_path, "vis")
    os.makedirs(out_dir, exist_ok=True)
    count = 0
    for batch in BatchLoader(test_ds, 1, prefetch=0):
        if count >= max_items:
            break
        pts = torch.as_tensor(np.asarray(batch[0]), dtype=torch.float32, device=device)
        with torch.no_grad():
            points, _ = fps(pts, npoints)
            loss = model(points, generator=torch.Generator(device).manual_seed(count))
        cloud = points[0].cpu().numpy()
        np.save(os.path.join(out_dir, f"input-{count:03d}.npy"), cloud)
        _render_png(os.path.join(out_dir, f"input-{count:03d}.png"), cloud)
        print_log(f"[VIS] item {count} CD loss {float(loss):.5f}", logger=logger)
        count += 1
    print_log(f"[VIS] wrote {count} items to {out_dir}", logger=logger)
    return count
