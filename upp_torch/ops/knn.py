"""k-nearest-neighbour search (counterpart of ``upp_tpu/ops/knn.py``).

On CUDA tensors ``knn``/``knn_points`` run the hand-written kernel
(``knn_cuda`` / ``csrc/knn.cu``) at every call site, whatever the size,
inside ``KnnKernel``, an autograd Function whose backward is the JAX
package's custom VJP (``knn_pallas.py:186-204, 229-237``) in plain tensor
code, as it is there. On CPU tensors they run ``knn_plain``, the plain
PyTorch version the kernel is held against, and autograd differentiates it.
Both use the difference form of the squared distance, as the Pallas kernel
does, and break ties toward the lowest index.
"""

from __future__ import annotations

from typing import Optional, Tuple

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


def knn_backward(query: torch.Tensor, points: torch.Tensor, idx: torch.Tensor,
                 nbr: torch.Tensor, g_d: torch.Tensor, g_nb: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gradients (query, points) of d_j = ||q - nb_j||^2 and nb_j =
    points[idx_j]: g_q = sum_j 2 g_d (q - nb_j); each neighbour row adds
    g_nb - 2 g_d (q - nb_j) to its point (a scatter-add over ``idx``)."""
    diff = query.float()[:, :, None, :] - nbr.float()          # [B, S, k, 3]
    g_q = (2.0 * g_d[..., None] * diff).sum(2)
    rows = -2.0 * g_d[..., None] * diff
    if g_nb is not None:
        rows = rows + g_nb.float()
    B, N = points.shape[:2]
    flat = (idx + (torch.arange(B, device=idx.device) * N)[:, None, None]).reshape(-1)
    g_p = torch.zeros((B * N, 3), dtype=torch.float32, device=points.device)
    g_p.index_add_(0, flat, rows.reshape(-1, 3))
    return g_q.to(query.dtype), g_p.reshape(points.shape).to(points.dtype)


class KnnKernel(torch.autograd.Function):
    """The kNN kernel with a backward: forward (query [B,S,3], points
    [B,N,3], k, gather) -> (d, idx int64[, nbr]) from ``knn_cuda.knn``."""

    @staticmethod
    def forward(ctx, query, points, k: int, gather: bool):
        from . import knn_cuda
        d, idx, nbr = knn_cuda.knn(query.detach().float().contiguous(),
                                   points.detach().float().contiguous(), k, gather)
        idx = idx.long()
        ctx.mark_non_differentiable(idx)
        ctx.save_for_backward(query, points, idx, nbr)
        if gather:
            return d, idx, nbr.to(points.dtype)
        return d, idx

    @staticmethod
    def backward(ctx, g_d, _g_idx, g_nb=None):
        query, points, idx, nbr = ctx.saved_tensors
        if nbr is None:                      # idx-only: gather for the backward
            nbr = index_points(points, idx)
        g_q, g_p = knn_backward(query, points, idx, nbr, g_d, g_nb)
        return g_q, g_p, None, None


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
        return KnnKernel.apply(query, points, k, False)
    if query.device.type == "cpu":
        return knn_plain(query, points, k)
    raise ValueError(f"knn: unsupported device {query.device}")


def knn_points(query: torch.Tensor, points: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """pytorch3d.ops.knn_points analogue: also gathers the neighbour xyz.

    Returns (sq_dists [B,S,k], idx [B,S,k] int64, nn_xyz [B,S,k,3])."""
    if query.device.type == "cuda":
        return KnnKernel.apply(query, points, k, True)
    if query.device.type == "cpu":
        d, idx = knn_plain(query, points, k)
        return d, idx, index_points(points, idx)
    raise ValueError(f"knn_points: unsupported device {query.device}")
