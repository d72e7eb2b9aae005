"""k-nearest-neighbour search (counterpart of ``upp_tpu/ops/knn.py``).

On CUDA tensors ``knn``/``knn_points`` run the hand-written kernel
(``knn_cuda`` / ``csrc/knn.cu``) at every call site, whatever the size; on
CPU tensors they run ``knn_plain``, the plain PyTorch version the kernel is
held against. Both use the difference form of the squared distance, as the
Pallas kernel does, and break ties toward the lowest index.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .geometry import index_points


def knn_plain(query: torch.Tensor, points: torch.Tensor, k: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch kNN: (sq_dists [B,S,k] ascending, idx [B,S,k] int64).

    ``(dx*dx + dy*dy) + dz*dz`` one elementwise op at a time (the kernel's
    arithmetic), then a stable sort: ``torch.topk`` does not promise the
    lowest index on ties. For k > N the farthest neighbour is repeated, as
    in the JAX package (``knn.py:45-51``)."""
    q = query.float()
    p = points.float()
    dx = q[..., 0][:, :, None] - p[..., 0][:, None, :]
    dy = q[..., 1][:, :, None] - p[..., 1][:, None, :]
    dz = q[..., 2][:, :, None] - p[..., 2][:, None, :]
    d = dx * dx + dy * dy + dz * dz                       # [B, S, N]
    d, idx = torch.sort(d, dim=-1, stable=True)
    n = points.shape[1]
    if k > n:
        pad = k - n
        d = torch.cat([d, d[..., -1:].expand(*d.shape[:-1], pad)], -1)
        idx = torch.cat([idx, idx[..., -1:].expand(*idx.shape[:-1], pad)], -1)
        return d, idx
    return d[..., :k], idx[..., :k]


def _kernel(query, points, k, gather):
    from . import knn_cuda
    return knn_cuda.knn(query.float().contiguous(), points.float().contiguous(),
                        k, gather)


def knn(query: torch.Tensor, points: torch.Tensor, k: int
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each query, the k nearest of ``points`` (squared distances).

    Args:
      query:  [B, S, 3]
      points: [B, N, 3]
    Returns:
      (sq_dists [B, S, k] ascending, idx [B, S, k] int64)
    """
    if query.device.type == "cuda":
        d, idx, _ = _kernel(query, points, k, gather=False)
        return d, idx.long()
    if query.device.type == "cpu":
        return knn_plain(query, points, k)
    raise ValueError(f"knn: unsupported device {query.device}")


def knn_points(query: torch.Tensor, points: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """pytorch3d.ops.knn_points analogue: also gathers the neighbour xyz.

    Returns (sq_dists [B,S,k], idx [B,S,k] int64, nn_xyz [B,S,k,3])."""
    if query.device.type == "cuda":
        d, idx, nbr = _kernel(query, points, k, gather=True)
        return d, idx.long(), nbr.to(points.dtype)
    if query.device.type == "cpu":
        d, idx = knn_plain(query, points, k)
        return d, idx, index_points(points, idx)
    raise ValueError(f"knn_points: unsupported device {query.device}")
