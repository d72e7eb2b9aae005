"""Elementary batched point-geometry primitives
(counterpart of ``upp_tpu/ops/geometry.py``)."""

from __future__ import annotations

import torch


def square_distance(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Pairwise squared euclidean distances, matmul form.

    Args:
      src: [B, N, C]
      dst: [B, M, C]
    Returns:
      [B, N, M] with d[b,n,m] = ||src[b,n] - dst[b,m]||^2
    """
    src = src.float()
    dst = dst.float()
    dist = -2.0 * torch.einsum("bnc,bmc->bnm", src, dst)
    dist = dist + (src * src).sum(-1)[..., :, None]
    return dist + (dst * dst).sum(-1)[..., None, :]


def index_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched gather along the point axis.

    Args:
      points: [B, N, C]
      idx:    [B, ...] integer indices into the N axis.
    Returns:
      [B, ..., C]
    """
    B, C = points.shape[0], points.shape[-1]
    flat = idx.reshape(B, -1, 1).long().expand(-1, -1, C)
    out = torch.gather(points, 1, flat)
    return out.reshape(*idx.shape, C)
