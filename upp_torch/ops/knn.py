"""k-nearest-neighbour search (counterpart of ``upp_tpu/ops/knn.py``).

On CUDA tensors ``knn``/``knn_points`` run a hand-written kernel at every
call site, whatever the size, inside ``KnnKernel``, an autograd Function
whose backward is the JAX package's custom VJP (``knn_pallas.py:186-204,
229-237``) in plain tensor code, as it is there: ``knn_cuda.knn``
(``csrc/knn.cu``) up to k = 64 and N = 16384, past either limit the
large-k ``knn_cuda.knn_select`` (``csrc/knn_select.cu``, the patch
denoiser's k = 1000), whose neighbours' xyz ``index_points`` gathers, as
the JAX package gathers outside any kernel there (``knn.py:58-67``). On CPU
tensors they run ``knn_plain``, the plain PyTorch version both kernels are
held against, and autograd differentiates it. All use the difference form
of the squared distance, as the Pallas kernel does, and break ties toward
the lowest index.
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
    return _repeat_last(d[..., :k], k, 2), _repeat_last(idx[..., :k], k, 2)


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


def _repeat_last(t: torch.Tensor, k: int, dim: int) -> torch.Tensor:
    """``t`` extended to ``k`` along ``dim`` by repeating its last entry."""
    n = t.shape[dim]
    if k <= n:
        return t
    shape = list(t.shape)
    shape[dim] = k - n
    return torch.cat([t, t.narrow(dim, n - 1, 1).expand(shape)], dim)


class KnnKernel(torch.autograd.Function):
    """The kNN kernels with a backward: forward (query [B,S,3], points
    [B,N,3], k, gather) -> (d, idx int64[, nbr]) from ``knn_cuda.knn``, or
    past its limits from ``knn_cuda.knn_select`` and ``index_points``. For
    k > N the kernel finds all N and the farthest is repeated, as in the
    JAX package (``knn.py:45-51``) and ``knn_plain``."""

    @staticmethod
    def forward(ctx, query, points, k: int, gather: bool):
        from . import knn_cuda
        q = query.detach().float().contiguous()
        p = points.detach().float().contiguous()
        n_k = min(k, p.shape[1])
        if n_k <= knn_cuda.MAX_K and p.shape[1] <= knn_cuda.MAX_N:
            d, idx, nbr = knn_cuda.knn(q, p, n_k, gather)
            idx = idx.long()
        else:
            d, idx = knn_cuda.knn_select(q, p, n_k)
            idx = idx.long()
            nbr = index_points(p, idx) if gather else None
        d, idx = _repeat_last(d, k, 2), _repeat_last(idx, k, 2)
        nbr = None if nbr is None else _repeat_last(nbr, k, 2)
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
