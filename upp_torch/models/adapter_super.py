"""Elastic-width bottleneck adapters (counterpart of
``upp_tpu/models/adapter_super.py``; reference ``models/adapter_super.py``).
No UPP model builds them; they are part of the component inventory.
``AdapterSuper`` can run on the first ``sample_embed_dim`` bottleneck
channels alone (the supernet's elastic width, the reference's
``set_sample_config``); ``AdapterSuperF`` puts a LayerNorm in front and
scales its output by 0.7, with no residual. Parameter names follow the
reference: ``ln1``, ``ln2`` (and ``layer_norm``)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Dropout, layer_norm


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class AdapterSuper(nn.Module):
    """``identity + ln2(dropout(quick_gelu(ln1(x))))`` over the first
    ``sample_embed_dim`` bottleneck channels (all when None); ``identity``
    is ``x`` unless given."""

    def __init__(self, embed_dims: int, reduction_dims: int, drop_rate_adapter: float = 0.1):
        super().__init__()
        self.ln1 = nn.Linear(embed_dims, reduction_dims)
        self.ln2 = nn.Linear(reduction_dims, embed_dims)
        self.dropout = Dropout(drop_rate_adapter)

    def bottleneck(self, x: torch.Tensor, sample_embed_dim: Optional[int]) -> torch.Tensor:
        k = sample_embed_dim or self.ln1.out_features
        h = quick_gelu(F.linear(x, self.ln1.weight[:k], self.ln1.bias[:k]))
        return F.linear(self.dropout(h), self.ln2.weight[:, :k], self.ln2.bias)

    def forward(self, x: torch.Tensor, identity: Optional[torch.Tensor] = None,
                sample_embed_dim: Optional[int] = None) -> torch.Tensor:
        return (x if identity is None else identity) + self.bottleneck(x, sample_embed_dim)


class AdapterSuperF(AdapterSuper):
    """``AdapterSuper_f``: LayerNorm, the bottleneck, a fixed 0.7 scale."""

    scale = 0.7

    def __init__(self, embed_dims: int, reduction_dims: int, drop_rate_adapter: float = 0.1):
        super().__init__(embed_dims, reduction_dims, drop_rate_adapter)
        self.layer_norm = layer_norm(embed_dims)

    def forward(self, x: torch.Tensor, sample_embed_dim: Optional[int] = None) -> torch.Tensor:
        return self.bottleneck(self.layer_norm(x), sample_embed_dim) * self.scale
