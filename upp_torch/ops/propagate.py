"""Inverse-distance-weighted feature propagation (counterpart of
``upp_tpu/ops/propagate.py``)."""

from __future__ import annotations

import torch

from .geometry import index_points
from .knn import knn


def inverse_distance_interp(xyz1: torch.Tensor, xyz2: torch.Tensor,
                            feats2: torch.Tensor, k: int = 16,
                            eps: float = 1e-4) -> torch.Tensor:
    """Interpolate features from sparse points xyz2 onto dense points xyz1.

    Args:
      xyz1:   [B, N, 3] target positions.
      xyz2:   [B, S, 3] source positions.
      feats2: [B, S, D] source features.
      k:      neighbours to blend (at most S).
      eps:    distance regulariser.
    Returns:
      [B, N, D] interpolated features.
    """
    kk = min(k, xyz2.shape[1])
    dk, idx = knn(xyz1, xyz2, kk)
    # clamp at 0 as the JAX package does (a matmul-form distance can round a
    # self-distance below zero; the difference form here cannot, so the
    # clamp only keeps the two formulas identical)
    w = 1.0 / (dk.clamp_min(0.0) + eps)
    w = w / w.sum(-1, keepdim=True)
    # the JAX package mixes through a dense [N, S] matrix for S <= 256 (an
    # MXU matmul); a gather computes the same weighted sum
    return (index_points(feats2, idx) * w[..., None]).sum(2)


def propagate(xyz1, xyz2, points1, points2, de_neighbors: int = 64,
              dist_e: float = 1e-8):
    """Residual propagation: points1 + 0.3 * interp(points2)."""
    interp = inverse_distance_interp(xyz1, xyz2, points2, k=de_neighbors, eps=dist_e)
    return points1 + 0.3 * interp
