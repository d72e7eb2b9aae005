"""Deformable local attention family (counterpart of
``upp_tpu/models/deform_attn.py``).

The deformable blocks of the reference's ``models/Transformer_utils.py``
zoo, the ``rw_deform`` / ``deform`` / ``deform_graph`` style tokens of
``models/AdaPoinTr.py:15-311``:

* ``DeformableLocalAttention``      (rw_deform, ``Transformer_utils.py:159-266``)
* ``DeformableLocalCrossAttention`` (deform,    ``Transformer_utils.py:269-491``)
* ``DeformableGraphAttention``      (deform_graph, improvedDeformableLocal-
  GraphAttention, ``Transformer_utils.py:623-775``)

Shared recipe: kNN a local region per query token, predict a per-neighbour
3D offset from (region features, query feature), shift the neighbour
positions by tanh(offset) (optionally scaled to the local ball), re-sample
features at the shifted positions by 3-NN inverse-distance interpolation,
then attend or graph-convolve over the re-sampled region.

The region kNN runs the kNN kernel on CUDA tensors. The denoise split's
masked kNN and the 3-NN interpolation are plain tensor code, as they are XLA
(not Pallas) in the JAX package: a stable sort of the distances, so ties go
to the lowest index as ``lax.top_k``'s do (``torch.topk`` promises no order).
Submodule names are the JAX tree's (``resample.linear_offset.lin0``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.geometry import index_points
from ..ops.knn import knn
from .layers import layer_norm


def sq_dists(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[B, L, M] squared distances, difference form (the JAX blocks' own)."""
    return ((q[:, :, None] - v[:, None]) ** 2).sum(-1)


def smallest_k(d: torch.Tensor, k: int) -> torch.Tensor:
    """Indices [..., k] of the k smallest of ``d`` along its last axis,
    ascending, ties to the lowest index (``lax.top_k(-d, k)``'s order)."""
    return torch.sort(d, dim=-1, stable=True)[1][..., :k]


def denoise_mask(nq: int, nv: int, denoise_length: int, device) -> torch.Tensor:
    """[nq, nv] True where a true query (all but the last ``denoise_length``)
    meets a denoise key (the last ``denoise_length``): such pairs are never
    neighbours."""
    key_is_denoise = torch.arange(nv, device=device) >= nv - denoise_length
    query_is_true = torch.arange(nq, device=device) < nq - denoise_length
    return query_is_true[:, None] & key_is_denoise[None, :]


def _knn_idx(q_pos, v_pos, k: int, denoise_length: Optional[int] = None) -> torch.Tensor:
    """kNN indices of q_pos in v_pos; with ``denoise_length``, true queries
    see only true keys: the masked equivalent of the reference's two-kNN
    split (``Transformer_utils.py:408-424``)."""
    if not denoise_length:
        return knn(q_pos, v_pos, k)[1]
    with torch.no_grad():
        d = sq_dists(q_pos, v_pos)
        mask = denoise_mask(q_pos.shape[1], v_pos.shape[1], denoise_length, d.device)
        return smallest_k(d.masked_fill(mask, torch.inf), k)


def three_interpolate(qpos, v_pos, v, eps: float = 1e-8) -> torch.Tensor:
    """Inverse-distance 3-NN feature interpolation, the pointnet2
    ``three_nn`` + ``three_interpolate`` pair. qpos [B, L, 3], v_pos [B, M,
    3], v [B, M, C] → [B, L, C]; weights from squared distances. The three
    distances are recomputed from the chosen pairs, which is what autograd
    of the full distance matrix gives them."""
    with torch.no_grad():
        idx = smallest_k(sq_dists(qpos, v_pos), 3)               # [B, L, 3]
    d = ((qpos[:, :, None] - index_points(v_pos, idx)) ** 2).sum(-1)
    w = 1.0 / (d + eps)
    w = w / w.sum(-1, keepdim=True)
    return (index_points(v, idx) * w[..., None]).sum(-2)


class _OffsetMLP(nn.Module):
    """linear_offset: Linear(dim) → LayerNorm → GELU → Linear(3, no bias)."""

    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.lin0 = nn.Linear(in_dim, dim)
        self.norm = layer_norm(dim)
        self.lin1 = nn.Linear(dim, 3, bias=False)

    def forward(self, x):
        return self.lin1(F.gelu(self.norm(self.lin0(x))))


class _DeformResample(nn.Module):
    """Grouped offsets from (the v_off region, q) and the 3-NN re-sample of
    the raw value features at the shifted positions."""

    def __init__(self, dim: int, k: int, n_group: int):
        super().__init__()
        self.k, self.n_group = k, n_group
        self.linear_offset = _OffsetMLP(2 * dim // n_group, dim)

    def forward(self, q_g, v_off, v, v_pos, idx):
        B, N, C = q_g.shape
        g, c, k = self.n_group, C // self.n_group, self.k
        off_local = index_points(v_off, idx).reshape(B, N, k, g, c)
        group_q = q_g.reshape(B, N, 1, g, c).expand_as(off_local)
        offset = torch.tanh(self.linear_offset(torch.cat([off_local, group_q], -1)))
        local_pos = index_points(v_pos, idx)                        # [B, N, k, 3]
        shift_pos = (local_pos[:, :, :, None, :] + offset).permute(0, 3, 1, 2, 4) \
            .reshape(B * g, N * k, 3)
        M = v_pos.shape[1]
        pos_g = v_pos[:, None].expand(B, g, M, 3).reshape(B * g, M, 3)
        v_g = v.reshape(B, M, g, c).transpose(1, 2).reshape(B * g, M, c)
        interp = three_interpolate(shift_pos, pos_g, v_g)
        return interp.reshape(B, g, N, k, c).permute(0, 2, 3, 1, 4).reshape(B, N, k, C)


class DeformableLocalAttention(nn.Module):
    """'rw_deform': deformable region re-sample + local k x k
    self-attention, max-pooled back to the token
    (``Transformer_utils.py:159-266``)."""

    def __init__(self, dim: int, num_heads: int, k: int = 10, n_group: int = 2):
        super().__init__()
        self.num_heads, self.k = num_heads, k
        self.proj_q = nn.Linear(dim, dim, bias=False)
        self.proj_v_off = nn.Linear(dim, dim, bias=False)
        self.resample = _DeformResample(dim, k, n_group)
        self.proj_k = nn.Linear(dim, dim, bias=False)
        self.proj_v = nn.Linear(dim, dim, bias=False)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, pos, idx=None):
        B, N, C = x.shape
        H, k = self.num_heads, self.k
        hd = C // H
        if idx is None:
            idx = _knn_idx(pos, pos, k)
        q = self.proj_q(x)
        # offsets come from proj_v_off features; the re-sample source is raw x
        interp = self.resample(q, self.proj_v_off(x), x, pos, idx)
        heads = lambda t: t.reshape(B, N, k, H, hd).transpose(2, 3)   # noqa: E731  [B,N,H,k,hd]
        local_q = heads(index_points(q, idx))
        attn = torch.softmax((local_q @ heads(self.proj_k(interp)).transpose(-2, -1))
                             * hd ** -0.5, dim=-1)
        out = (attn @ heads(self.proj_v(interp))).transpose(2, 3).reshape(B, N, k, C)
        return self.proj(out.amax(2))


class DeformableLocalCrossAttention(nn.Module):
    """'deform': deformable region re-sample + 1 x k cross-attention from
    the query token to its re-sampled region
    (``Transformer_utils.py:269-491``). Self-attention when v is None; takes
    the denoise split."""

    def __init__(self, dim: int, num_heads: int, k: int = 10, n_group: int = 2):
        super().__init__()
        self.num_heads, self.k = num_heads, k
        self.proj_q = nn.Linear(dim, dim, bias=False)
        self.proj_v_off = nn.Linear(dim, dim, bias=False)
        self.resample = _DeformResample(dim, k, n_group)
        self.proj_k = nn.Linear(dim, dim, bias=False)
        self.proj_v = nn.Linear(dim, dim, bias=False)
        self.proj = nn.Linear(dim, dim)

    def forward(self, q, q_pos, v=None, v_pos=None, idx=None,
                denoise_length: Optional[int] = None):
        v = q if v is None else v
        v_pos = q_pos if v_pos is None else v_pos
        B, N, C = q.shape
        H, k = self.num_heads, self.k
        hd = C // H
        if idx is None:
            idx = _knn_idx(q_pos, v_pos, k, denoise_length)
        qf = self.proj_q(q)
        interp = self.resample(qf, self.proj_v_off(v), v, v_pos, idx)
        qh = qf.reshape(B, N, H, 1, hd)
        kf = self.proj_k(interp).reshape(B, N, k, H, hd).transpose(2, 3)     # [B,N,H,k,hd]
        vf = self.proj_v(interp).reshape(B, N, k, H, hd).transpose(2, 3)
        attn = torch.softmax((qh @ kf.transpose(-2, -1)) * hd ** -0.5, dim=-1)
        return self.proj((attn @ vf).reshape(B, N, C))


class DeformableGraphAttention(nn.Module):
    """'deform_graph' (improvedDeformableLocalGraphAttention,
    ``Transformer_utils.py:623-775``): ungrouped offsets scaled to the local
    ball, 3-NN re-sample, then an edge-conv (knn_map + max) over the
    re-sampled region."""

    def __init__(self, dim: int, k: int = 10):
        super().__init__()
        self.k = k
        self.proj_v_off = nn.Linear(dim, dim)
        self.linear_offset = _OffsetMLP(2 * dim, dim)
        self.knn_map = nn.Linear(2 * dim, dim)

    def forward(self, q, q_pos, v=None, v_pos=None, idx=None,
                denoise_length: Optional[int] = None):
        v = q if v is None else v
        v_pos = q_pos if v_pos is None else v_pos
        B, N, C = q.shape
        if idx is None:
            idx = _knn_idx(q_pos, v_pos, self.k, denoise_length)
        off_local = index_points(self.proj_v_off(v), idx)           # [B, N, k, C]
        qk = q[:, :, None, :].expand_as(off_local)
        offset = torch.tanh(self.linear_offset(torch.cat([off_local, qk], -1)))
        local_pos = index_points(v_pos, idx)                        # [B, N, k, 3]
        # deform within the local ball: scale = half the region's extent
        scale = 0.5 * (local_pos.amax(-2, keepdim=True) - local_pos.amin(-2, keepdim=True))
        shift_pos = (local_pos + offset * scale).reshape(B, N * self.k, 3)
        interp = three_interpolate(shift_pos, v_pos, v).reshape(B, N, self.k, C)
        h = F.leaky_relu(self.knn_map(torch.cat([interp - qk, qk], -1)), 0.2)
        return h.amax(2)
