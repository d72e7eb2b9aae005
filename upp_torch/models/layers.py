"""Shared neural building blocks (counterpart of ``upp_tpu/models/layers.py``).

Module and parameter names follow the reference's ``.pth`` layout
(``models/Point_MAE_unify.py``), so its checkpoints load without renaming.
Pointwise ("Conv1d/Conv2d k=1") layers keep the reference's weight shapes
but compute on a channels-last layout as a matrix product, like the JAX
package's Dense layers.

Numerics as in the JAX model: LayerNorm eps 1e-6, BatchNorm eps 1e-5 with
torch's running-statistics semantics (momentum 0.1 here is flax's 0.9;
batch statistics in ``.train()``, the unbiased variance folded into the
running average, as the JAX ``TorchBatchNorm`` imitates), exact GELU.
Random draws of train mode (dropout, drop-path) come from torch's RNG on the
tensors' device, or drop-path's from a generator the caller passes.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-6
BN_EPS = 1e-5


def layer_norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=LN_EPS)


def drop_path(x: torch.Tensor, rate: float, training: bool,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Per-sample stochastic depth (timm DropPath): in training, each sample
    is zeroed with probability ``rate`` and the rest scaled by 1/(1-rate),
    drawn from ``generator`` (torch's RNG when None)."""
    if rate == 0.0 or not training:
        return x
    keep = 1.0 - rate
    mask = torch.empty((x.shape[0],) + (1,) * (x.dim() - 1), device=x.device,
                       dtype=x.dtype).bernoulli_(keep, generator=generator)
    return x / keep * mask


def batch_norm_last(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor) -> torch.Tensor:
    """Apply a BatchNorm module over the last axis of ``x`` (statistics over
    all other axes), whatever the module's own dimensionality."""
    flat = x.reshape(-1, x.shape[-1])
    y = F.batch_norm(flat, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                     bn.training, bn.momentum, bn.eps)
    return y.reshape(x.shape)


class PointConv(nn.Module):
    """Pointwise convolution with the reference's ``Conv1d``/``Conv2d``
    (kernel 1) weight shape [out, in, 1] / [out, in, 1, 1], applied to
    channels-last input as ``x @ W.T + b``."""

    def __init__(self, in_ch: int, out_ch: int, conv_dims: int = 1, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty((out_ch, in_ch) + (1,) * conv_dims))
        self.bias = nn.Parameter(torch.empty(out_ch)) if bias else None
        # torch's Conv default init: kaiming_uniform(a=sqrt(5))
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))
        if self.bias is not None:
            bound = 1.0 / math.sqrt(in_ch)
            nn.init.uniform_(self.bias, -bound, bound)

    def forward(self, x):
        return F.linear(x, self.weight.reshape(self.weight.shape[0], -1), self.bias)


class TwoLayerHead(nn.Sequential):
    """Linear → GELU → Linear (shape_pred / coarse_pred /
    predict_token_generator, ``Point_MAE_unify.py:424-439``)."""

    def __init__(self, in_dim: int, hidden: int, out_dim: int):
        super().__init__(nn.Linear(in_dim, hidden), nn.GELU(),
                         nn.Linear(hidden, out_dim))


class PosEmbedMLP(TwoLayerHead):
    """3 → 128 → GELU → out_dim positional embedding
    (``Point_MAE_unify.py:408-412``)."""

    def __init__(self, out_dim: int, hidden: int = 128):
        super().__init__(3, hidden, out_dim)


class Mlp(nn.Module):
    """Transformer MLP (``Point_MAE_unify.py:226-242``); dropout 0."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Attention(nn.Module):
    """Multi-head self-attention without qkv bias
    (``Point_MAE_unify.py:245-269``), written out as matrix products."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        B, N, C = x.shape
        H = self.num_heads
        hd = C // H
        qkv = self.qkv(x).reshape(B, N, 3, H, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]                     # [B, H, N, hd]
        attn = torch.softmax((q @ k.transpose(-2, -1)) * hd ** -0.5, dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(B, N, C)
        return self.proj(out)


class Adapter(nn.Module):
    """Bottleneck adapter with dropout 0.1 inside and a fixed 0.7 output
    scale (``Point_MAE_pretask_dev.py:54-104``)."""

    scale = 0.7

    def __init__(self, embed_dims: int, reduction_dims: int = 32):
        super().__init__()
        self.layer_norm = layer_norm(embed_dims)
        self.ln1 = nn.Linear(embed_dims, reduction_dims)
        self.dropout = nn.Dropout(0.1)
        self.ln2 = nn.Linear(reduction_dims, embed_dims)

    def forward(self, x):
        h = self.dropout(F.gelu(self.ln1(self.layer_norm(x))))
        return self.ln2(h) * self.scale


class Encoder(nn.Module):
    """Mini-PointNet group tokenizer (``Point_MAE_unify.py:191-222``):
    [B, G, n, 3] center-relative neighbourhoods → tokens [B, G, C]. BatchNorm
    statistics span (batch, groups, points), as torch's BatchNorm1d on the
    flattened (B*G, C, n) layout.

    ``vis_idx`` [B, V] (MAE pretraining) returns the tokens of those groups
    alone, gathered right after the second BatchNorm: every group enters
    both BatchNorms' statistics, as the reference encodes all groups before
    its mask select (``Point_MAE_cp.py:352-357``), and the last conv and
    pool run on the visible groups only (``upp_tpu/models/layers.py:224-228``).
    Gathering before the encoder would change the statistics."""

    def __init__(self, encoder_channel: int):
        super().__init__()
        self.encoder_channel = encoder_channel
        self.first_conv = nn.Sequential(
            PointConv(3, 128), nn.BatchNorm1d(128, eps=BN_EPS), nn.ReLU(),
            PointConv(128, 256))
        self.second_conv = nn.Sequential(
            PointConv(512, 512), nn.BatchNorm1d(512, eps=BN_EPS), nn.ReLU(),
            PointConv(512, encoder_channel))

    def forward(self, point_groups, vis_idx: Optional[torch.Tensor] = None):
        bs, g, n, _ = point_groups.shape
        x = self.first_conv(point_groups.reshape(bs * g * n, 3))
        x = x.reshape(bs * g, n, 256)
        g_max = x.amax(1, keepdim=True).expand(-1, n, -1)
        x = torch.cat([g_max, x], dim=-1).reshape(bs * g * n, 512)
        x = self.second_conv[1](self.second_conv[0](x))
        if vis_idx is not None:
            g = vis_idx.shape[1]
            x = torch.gather(x.reshape(bs, -1, n, 512), 1,
                             vis_idx[:, :, None, None].expand(-1, -1, n, 512))
            x = x.reshape(bs * g * n, 512)
        x = self.second_conv[3](self.second_conv[2](x))
        x = x.reshape(bs * g, n, self.encoder_channel).amax(1)
        return x.reshape(bs, g, self.encoder_channel)


def positional_embedding(x: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """NeRF sin/cos embedding, x ‖ sin(2^k x) ‖ cos(2^k x)."""
    out = [x]
    for k in range(n_freqs):
        f = float(2 ** k)
        out.append(torch.sin(f * x))
        out.append(torch.cos(f * x))
    return torch.cat(out, dim=-1)
