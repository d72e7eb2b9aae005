"""Furthest point sampling (counterpart of ``upp_tpu/ops/fps.py``).

On a CUDA tensor ``fps`` runs the hand-written kernel (``fps_cuda`` /
``csrc/fps.cu``); on a CPU tensor it runs ``fps_plain_idx``, the plain
PyTorch version the kernel is held against. Semantics follow pointnet2 and
the JAX package: start at the first valid slot (or ``start_idx``), keep a
running min-distance table, take the argmax each round (lowest index on
ties); invalid slots are never selected and never shrink a distance.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .geometry import index_points

_BIG = 1e10  # pointnet2 initialises the running distances to 1e10


def fps_plain_idx(xyz: torch.Tensor, n_samples: int,
                  valid: Optional[torch.Tensor] = None,
                  start_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch FPS: indices [B, n_samples] int64.

    The squared distance is ``(dx*dx + dy*dy) + dz*dz``, one elementwise op
    at a time, which is the kernel's arithmetic (``.pow(2).sum(-1)`` would
    leave the summation order to the backend)."""
    pts = xyz.detach().float()
    B, N, _ = pts.shape
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    if valid is None:
        start = torch.zeros(B, dtype=torch.long, device=pts.device)
    else:
        valid = valid.expand(B, N)
        start = valid.float().argmax(1)
    if start_idx is not None:
        start = start_idx.long().expand(B)
    dists = torch.full((B, N), _BIG, dtype=torch.float32, device=pts.device)
    idx = torch.empty((B, n_samples), dtype=torch.long, device=pts.device)
    rows = torch.arange(B, device=pts.device)
    cur = start
    for i in range(n_samples):
        idx[:, i] = cur
        dx = x - x[rows, cur][:, None]
        dy = y - y[rows, cur][:, None]
        dz = z - z[rows, cur][:, None]
        d = dx * dx + dy * dy + dz * dz
        dists = torch.minimum(dists, d)
        cand = dists if valid is None else torch.where(valid, dists, -1.0)
        cur = cand.argmax(1)          # first maximum: lowest index on ties
    return idx


def fps(xyz: torch.Tensor, n_samples: int,
        valid: Optional[torch.Tensor] = None,
        start_idx: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample ``n_samples`` points per cloud by furthest point sampling.

    Args:
      xyz:   [B, N, 3] point clouds (distances in float32).
      n_samples: number of points to select.
      valid: optional [B, N] bool mask; False entries are never selected.
             Callers must guarantee >= n_samples valid points per cloud.
      start_idx: optional [B] — explicit first selection per cloud.
    Returns:
      (sampled [B, n_samples, 3] in xyz's dtype, idx [B, n_samples] int64).
      Gradients reach ``xyz`` through the final gather only.
    """
    if xyz.device.type == "cuda":
        from . import fps_cuda
        idx = fps_cuda.fps_idx(xyz.detach().float().contiguous(), n_samples,
                               valid, start_idx).long()
    elif xyz.device.type == "cpu":
        idx = fps_plain_idx(xyz, n_samples, valid, start_idx)
    else:
        raise ValueError(f"fps: unsupported device {xyz.device}")
    return index_points(xyz, idx), idx
