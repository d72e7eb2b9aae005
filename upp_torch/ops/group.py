"""FPS + kNN patchifier ("Group"), counterpart of ``upp_tpu/ops/group.py``."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .fps import fps
from .geometry import index_points
from .knn import knn, knn_points


class Grouped(NamedTuple):
    neighborhood: torch.Tensor  # [B, G, S, 3] center-relative
    center: torch.Tensor        # [B, G, 3]
    idx: torch.Tensor           # [B, G, S] int64 indices into the input cloud
    center_idx: torch.Tensor    # [B, G] int64


def group_points(xyz: torch.Tensor, num_group: int, group_size: int,
                 valid: Optional[torch.Tensor] = None) -> Grouped:
    """Patchify a cloud into ``num_group`` neighbourhoods of ``group_size``:
    FPS centers, kNN neighbours of each center, center-relative coordinates."""
    center, center_idx = fps(xyz, num_group, valid)
    if valid is not None:
        # invalid slots go to a far shell, so the kNN takes them only when
        # fewer than group_size valid points exist; real coordinates below
        far = torch.where(valid.expand(xyz.shape[:2])[..., None], xyz,
                          torch.full_like(xyz, 1e6))
        _, idx = knn(center, far, group_size)
        neighborhood = index_points(xyz, idx)
    else:
        _, idx, neighborhood = knn_points(center, xyz, group_size)
    neighborhood = neighborhood - center[:, :, None, :]
    return Grouped(neighborhood, center, idx, center_idx)
