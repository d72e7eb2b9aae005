"""What the benchmark makes from ``--seed``: weights, point clouds and the
training recipe's random draws.

Weights come from one ``randn`` on the device, carved by the layout the
cell's driver takes from its reference model; both the program and the
reference get them. Clouds copy the synthetic dataset's procedural
surfaces (sphere, cube shell, cylinder, torus, cone, plane; the class picks
the surface) and its real-scan noise (jitter, shell outliers at radius
U(1.05, 1.5)), made in bulk on the host. The draws re-derive, from the seed
alone, what the classification recipe draws in a step, in its order
(``cls_draws``).
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

PROGRAM_SEED_MOD = 1 << 31      # the program's own seed: --seed modulo this
CLS_LIDAR, CLS_SHELL = 48, 24   # points the classification recipe adds a cloud


def make_weights(shapes: Dict[str, tuple], seed: int, device) -> Dict[str, torch.Tensor]:
    """Name -> tensor for each of ``shapes`` (name -> shape, the released
    layout): matrices N(0, 1/fan_in), biases N(0, 0.02^2), norm scales
    1 + N(0, 0.1^2), prompts and tokens N(0, 0.02^2); BatchNorm running
    mean 0 and variance 1."""
    sizes = {n: math.prod(s) for n, s in shapes.items() if not n.endswith("num_batches_tracked")}
    gen = torch.Generator(device).manual_seed(seed)
    flat = torch.randn(sum(sizes.values()), generator=gen, device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        if name.endswith("num_batches_tracked"):
            out[name] = torch.zeros((), dtype=torch.long, device=device)
            continue
        r = flat[at:at + sizes[name]].view(shape)
        at += sizes[name]
        if name.endswith("running_mean"):
            out[name] = torch.zeros(shape, device=device)
        elif name.endswith("running_var"):
            out[name] = torch.ones(shape, device=device)
        elif name.endswith(("prompts", "token", "cls_pos")):
            out[name] = r * 0.02
        elif name.endswith(".bias"):
            out[name] = r * 0.02
        elif len(shape) == 1:
            out[name] = 1.0 + 0.1 * r
        else:
            out[name] = r * (1.0 / math.sqrt(math.prod(shape[1:])))
    return out


def _surface(kind: int, b: int, n: int, gen: torch.Generator) -> torch.Tensor:
    """[b, n, 3] points on surface ``kind`` (0-5), float64."""
    u = torch.rand((b, n, 2), generator=gen, dtype=torch.float64)
    two_pi = 2 * math.pi
    if kind == 0:                                   # sphere
        g = torch.randn((b, n, 3), generator=gen, dtype=torch.float64)
        return g / g.norm(dim=-1, keepdim=True)
    if kind == 1:                                   # cube shell
        pts = 2 * torch.rand((b, n, 3), generator=gen, dtype=torch.float64) - 1
        face = (u[..., 0] * 3).long().clamp(max=2)
        sign = torch.where(u[..., 1] < 0.5, -1.0, 1.0).to(pts.dtype)
        return pts.scatter(-1, face[..., None], sign[..., None])
    if kind == 2:                                   # cylinder
        t = two_pi * u[..., 0]
        return torch.stack([t.cos(), t.sin(), 2 * u[..., 1] - 1], -1)
    if kind == 3:                                   # torus, R 0.7, r 0.3
        a, c = two_pi * u[..., 0], two_pi * u[..., 1]
        return torch.stack([(0.7 + 0.3 * c.cos()) * a.cos(), (0.7 + 0.3 * c.cos()) * a.sin(),
                            0.3 * c.sin()], -1)
    if kind == 4:                                   # cone
        h, th = u[..., 0], two_pi * u[..., 1]
        return torch.stack([(1 - h) * th.cos(), (1 - h) * th.sin(), 2 * h - 1], -1)
    z = 0.05 * torch.randn((b, n), generator=gen, dtype=torch.float64)     # plane
    return torch.stack([2 * u[..., 0] - 1, 2 * u[..., 1] - 1, z], -1)


def _surfaces(kind: torch.Tensor, n: int, gen: torch.Generator) -> torch.Tensor:
    """[B, n, 3] points on surface ``kind[b]``, each cloud scaled into the
    unit sphere."""
    pts = torch.empty((kind.shape[0], n, 3), dtype=torch.float64)
    for k in range(6):
        rows = (kind == k).nonzero()[:, 0]
        if len(rows):
            pts[rows] = _surface(k, len(rows), n, gen)
    return pts / pts.norm(dim=-1).amax(1)[:, None, None]


def make_clouds(batches: int, batch: int, n: int, num_classes: int, seed: int,
                jitter: float = 0.0, outliers: int = 0):
    """(clouds [batches, batch, n, 3] float32, labels [batches, batch] int64),
    numpy arrays on the host: every cloud differs."""
    gen = torch.Generator().manual_seed(seed)
    labels = torch.randint(0, num_classes, (batches, batch), generator=gen)
    clouds = []
    for i in range(batches):
        pts = _surfaces(labels[i] % 6, n, gen)
        if jitter > 0.0:
            pts = pts + jitter * torch.randn(pts.shape, generator=gen, dtype=torch.float64)
        if outliers > 0:
            d = torch.randn((batch, outliers, 3), generator=gen, dtype=torch.float64)
            r = 1.05 + 0.45 * torch.rand((batch, outliers, 1), generator=gen, dtype=torch.float64)
            pts[:, -outliers:] = d / d.norm(dim=-1, keepdim=True) * r
        clouds.append(pts.float())
    return torch.stack(clouds).numpy(), labels.numpy()


def recipe_generator(program_seed: int, step: int, device) -> torch.Generator:
    """The training recipe's generator of step ``step`` (0-based):
    ``((seed + 777) << 32) + step``."""
    return torch.Generator(device).manual_seed(((program_seed + 777) << 32) + step)


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)


def cls_draws(gen: torch.Generator, B: int, npoints: int, device) -> Dict[str, torch.Tensor]:
    """One classification training step's corruption draws, in the recipe's
    order: crop viewpoints, lidar indices and factors (48), shell normals
    (24 a cloud), scale and shift."""
    d = {"viewpoints": _unit(torch.randn((B, 3), generator=gen, device=device))}
    d["lidar_idx"] = torch.randint(0, npoints, (CLS_LIDAR,), generator=gen, device=device)
    d["lidar_factor"] = 1.2 + (1.5 - 1.2) * torch.rand((CLS_LIDAR,), generator=gen,
                                                       device=device)
    d["shell_normal"] = torch.randn((B, CLS_SHELL, 3), generator=gen, device=device)
    d.update(_scale_shift(gen, B, device))
    return d


def _scale_shift(gen, B, device):
    scale = 2.0 / 3.0 + (3.0 / 2.0 - 2.0 / 3.0) * torch.rand((B, 1, 3), generator=gen,
                                                             device=device)
    shift = 0.2 * (2.0 * torch.rand((B, 1, 3), generator=gen, device=device) - 1.0)
    return {"aug_scale": scale, "aug_shift": shift}


def sample(seed: int, n: int, k: int) -> np.ndarray:
    """``k`` distinct indices of ``range(n)`` drawn from the seed, sorted."""
    return np.sort(np.random.default_rng(seed).choice(n, size=min(k, n), replace=False))
