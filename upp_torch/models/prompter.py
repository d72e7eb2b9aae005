"""Rectification Prompter — per-point noise-rectification vector field
(counterpart of ``upp_tpu/models/prompter.py``; reference
``models/Point_MAE_pretask_dev.py:386-517``)."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.geometry import index_points
from ..ops.group import group_points
from ..ops.propagate import inverse_distance_interp
from .layers import BN_EPS, PointConv, batch_norm_last, positional_embedding


class PointNetSetAbstraction(nn.Module):
    """Group + shared MLP (Conv2d k=1 / BatchNorm2d) + max-pool downsample
    of per-point features (no relative xyz is concatenated)."""

    def __init__(self, num_group: int, group_size: int, in_channel: int,
                 mlp: Sequence[int]):
        super().__init__()
        self.num_group = num_group
        self.group_size = group_size
        chans = [in_channel, *mlp]
        self.mlp_convs = nn.ModuleList(
            PointConv(a, b, conv_dims=2) for a, b in zip(chans, chans[1:]))
        self.mlp_bns = nn.ModuleList(nn.BatchNorm2d(b, eps=BN_EPS) for b in mlp)

    def forward(self, xyz, feats):
        g = group_points(xyz.float(), self.num_group, self.group_size)
        x = index_points(feats, g.idx)                    # [B, G, S, D]
        for conv, bn in zip(self.mlp_convs, self.mlp_bns):
            x = F.relu(batch_norm_last(bn, conv(x)))
        return g.center, x.amax(2)


class PointNetFeaturePropagation(nn.Module):
    """Inverse-distance upsample + pointwise Conv1d/BatchNorm1d/ReLU stack."""

    def __init__(self, in_channel: int, mlp: Sequence[int],
                 interpolate_neighbors: int = 16):
        super().__init__()
        self.interpolate_neighbors = interpolate_neighbors
        chans = [in_channel, *mlp]
        self.mlp_convs = nn.ModuleList(PointConv(a, b) for a, b in zip(chans, chans[1:]))
        self.mlp_bns = nn.ModuleList(nn.BatchNorm1d(b, eps=BN_EPS) for b in mlp)

    def forward(self, xyz1, xyz2, points1: Optional[torch.Tensor], points2):
        x = inverse_distance_interp(xyz1, xyz2, points2,
                                    k=self.interpolate_neighbors, eps=1e-4)
        if points1 is not None:
            x = torch.cat([points1, x], dim=-1)
        for conv, bn in zip(self.mlp_convs, self.mlp_bns):
            x = F.relu(batch_norm_last(bn, conv(x)))
        return x


class RectifyPrompter(nn.Module):
    """Per-point rectification vector head.

    forward(x [B,N,3], center1 [B,G,3], center1_feature [B,G,D]):
      abstraction(center1, feats)             → center2 [B,32,3], feats2 [B,32,12]
      propagation2(center1 ← center2)         → [B, G, 32]
      propagation1(x ← center1, skip=NeRF(x)) → [B, N, 32]
      score head 32 → 64 → relu → dropout → 3
    """

    def __init__(self, hidden_dimension: int = 384, out_channels: int = 3,
                 embedding_level: int = 4, num_group: int = 32,
                 group_size: int = 16, top_center_dim: int = 12):
        super().__init__()
        self.embedding_level = embedding_level
        self.abstraction = PointNetSetAbstraction(
            num_group, group_size, hidden_dimension, (64, 32, top_center_dim))
        self.propagation2 = PointNetFeaturePropagation(top_center_dim, (64, 32))
        skip_dim = 3 * (1 + 2 * embedding_level)
        self.propagation1 = PointNetFeaturePropagation(skip_dim + 32, (32, 32))
        self.score_head = nn.Sequential(PointConv(32, 64), nn.ReLU(),
                                        nn.Dropout(0.2), PointConv(64, out_channels))

    def forward(self, x, center1, center1_feature):
        center2, center2_feature = self.abstraction(center1, center1_feature)
        c1_feat = self.propagation2(center1, center2, None, center2_feature)
        skip = positional_embedding(x, self.embedding_level)
        feat = self.propagation1(x, center1, skip, c1_feat)
        return self.score_head(feat)
