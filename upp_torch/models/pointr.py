"""PoinTr completion model (counterpart of ``upp_tpu/models/pointr.py``).

The vendored PoinTr stack (``models/PoinTr.py:16-123``,
``models/Transformer.py`` PCTransformer/Block/DecoderBlock,
``models/dgcnn_group.py`` DGCNN_Grouper): a DGCNN edge-conv grouper with FPS
2048→512→128, a geometry-aware encoder (its first ``knn_layer`` blocks merge
kNN graph features into self-attention), coarse centre queries, a
cross-attention decoder and a FoldingNet rebuild head.

Submodules take the JAX tree's names (``base_model.grouper.layer1.conv``,
``base_model.encoder0.attn.qkv``, ``foldingnet.folding1_c0``), which
``weights.state_dict_from_jax`` maps one to one. FPS, kNN (indices only) and
Chamfer run the port's kernels on CUDA tensors. Numerics as in the JAX
model: LayerNorm and GroupNorm eps 1e-6, BatchNorm eps 1e-5 through
``batch_norm_last`` (the global batch's statistics inside a train step of
several ranks), LeakyReLU 0.2.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.chamfer import chamfer_l1
from ..ops.fps import fps
from ..ops.geometry import index_points
from ..ops.knn import knn
from ..utils.config import to_config
from .build import MODELS
from .layers import BN_EPS, Attention, BatchNorm1d, Mlp, layer_norm

GN_EPS = 1e-6   # flax GroupNorm's default


def edge_features(coor_q, x_q, coor_k, x_k, k: int = 16) -> torch.Tensor:
    """DGCNN graph feature: concat(neighbour - centre, centre)
    (``dgcnn_group.py:90-112``). Returns [B, Nq, k, 2C]."""
    _, idx = knn(coor_q, coor_k, k)                          # [B, Nq, k]
    gathered = index_points(x_k, idx)                         # [B, Nq, k, C]
    center = x_q[:, :, None, :].expand_as(gathered)
    return torch.cat([gathered - center, center], -1)


def graph_feature_tokens(x, coor_q, coor_k, x_k, k: int = 8) -> torch.Tensor:
    """Token-space graph feature of queries ``x`` at ``coor_q`` over keys
    ``x_k`` at ``coor_k`` (``Transformer.py:58-68``)."""
    return edge_features(coor_q, x, coor_k, x_k, k)


def group_norm_last(gn: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
    """``gn`` over channels-last ``x`` [B, ..., C]: each sample's statistics
    over every position and the channels of a group, as flax's GroupNorm on
    [B, N, k, C] (torch's on the permuted [B, C, N, k])."""
    B, C = x.shape[0], x.shape[-1]
    xg = x.reshape(B, -1, gn.num_groups, C // gn.num_groups)
    var, mean = torch.var_mean(xg, dim=(1, 3), correction=0, keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + gn.eps)).reshape(x.shape)
    return y * gn.weight + gn.bias


class _EdgeLayer(nn.Module):
    """Conv2d(k=1, no bias) + GroupNorm(4) + LeakyReLU 0.2 + max over k."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = nn.Linear(in_ch, out_ch, bias=False)
        self.gn = nn.GroupNorm(4, out_ch, eps=GN_EPS)

    def forward(self, feats):                                 # [B, N, k, C]
        x = F.leaky_relu(group_norm_last(self.gn, self.conv(feats)), 0.2)
        return x.amax(2)                                      # [B, N, out_ch]


class DGCNNGrouper(nn.Module):
    """EdgeConv x4 with FPS N→512→128 (``dgcnn_group.py:43-144``)."""

    def __init__(self, n1: int = 512, n2: int = 128):
        super().__init__()
        self.n1, self.n2 = n1, n2
        self.input_trans = nn.Linear(3, 8)
        self.layer1 = _EdgeLayer(16, 32)
        self.layer2 = _EdgeLayer(64, 64)
        self.layer3 = _EdgeLayer(128, 64)
        self.layer4 = _EdgeLayer(128, 128)

    def forward(self, xyz):                                   # [B, N, 3]
        coor = xyz
        f = self.input_trans(xyz)
        f = self.layer1(edge_features(coor, f, coor, f))
        coor_q, idx = fps(coor, self.n1)
        f_q = index_points(f, idx)
        f = self.layer2(edge_features(coor_q, f_q, coor, f))
        coor = coor_q
        f = self.layer3(edge_features(coor, f, coor, f))
        coor_q, idx = fps(coor, self.n2)
        f_q = index_points(f, idx)
        f = self.layer4(edge_features(coor_q, f_q, coor, f))
        return coor_q, f                                      # [B,128,3], [B,128,128]


class KnnMerge(nn.Module):
    """knn_map (Linear 2C→C + LeakyReLU) → max over k → merge_map (Linear
    2C→C) (``Transformer.py:176-190,247-255``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.knn_map = nn.Linear(2 * dim, dim)
        self.merge_map = nn.Linear(2 * dim, dim)

    def forward(self, attn_out, graph_feats):
        knn_f = F.leaky_relu(self.knn_map(graph_feats), 0.2).amax(2)
        return self.merge_map(torch.cat([attn_out, knn_f], -1))


class PoinTrEncBlock(nn.Module):
    """LayerNorm → self-attention (+ the kNN merge) → MLP, both residual."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 2.0, use_knn: bool = False):
        super().__init__()
        self.norm1 = layer_norm(dim)
        self.attn = Attention(dim, num_heads)
        if use_knn:
            self.knn = KnnMerge(dim)
        self.norm2 = layer_norm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, coor):
        norm_x = self.norm1(x)
        x1 = self.attn(norm_x)
        if hasattr(self, "knn"):
            x1 = self.knn(x1, graph_feature_tokens(norm_x, coor, coor, norm_x))
        x = x + x1
        return x + self.mlp(self.norm2(x))


class CrossAttention(nn.Module):
    """(``Transformer.py:119-152``)."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_map = nn.Linear(dim, dim, bias=False)
        self.k_map = nn.Linear(dim, dim, bias=False)
        self.v_map = nn.Linear(dim, dim, bias=False)
        self.proj = nn.Linear(dim, dim)

    def forward(self, q, v):
        B, N, C = q.shape
        H = self.num_heads
        hd = C // H
        qm = self.q_map(q).reshape(B, N, H, hd).transpose(1, 2)     # [B, H, N, hd]
        km = self.k_map(v).reshape(B, -1, H, hd).transpose(1, 2)
        vm = self.v_map(v).reshape(B, -1, H, hd).transpose(1, 2)
        attn = torch.softmax((qm @ km.transpose(-2, -1)) * hd ** -0.5, dim=-1)
        return self.proj((attn @ vm).transpose(1, 2).reshape(B, N, C))


class PoinTrDecBlock(nn.Module):
    """Self-attention (+ kNN merge) → cross-attention (+ cross kNN merge) →
    MLP (``Transformer.py:155-220``)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 2.0, use_knn: bool = False):
        super().__init__()
        self.norm1 = layer_norm(dim)
        self.self_attn = Attention(dim, num_heads)
        self.norm_q = layer_norm(dim)
        self.norm_v = layer_norm(dim)
        self.attn = CrossAttention(dim, num_heads)
        if use_knn:
            self.knn = KnnMerge(dim)
            self.knn_cross = KnnMerge(dim)
        self.norm2 = layer_norm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, q, v, q_coor, v_coor):
        use_knn = hasattr(self, "knn")
        norm_q = self.norm1(q)
        q1 = self.self_attn(norm_q)
        if use_knn:
            q1 = self.knn(q1, graph_feature_tokens(norm_q, q_coor, q_coor, norm_q))
        q = q + q1
        norm_q2, norm_v = self.norm_q(q), self.norm_v(v)
        q2 = self.attn(norm_q2, norm_v)
        if use_knn:
            q2 = self.knn_cross(q2, graph_feature_tokens(norm_q2, q_coor, v_coor, norm_v))
        q = q + q2
        return q + self.mlp(self.norm2(q))


class ConvBNLeaky(nn.Module):
    """Conv1d → BatchNorm → LeakyReLU 0.2 → Conv1d (the increase_dim /
    pos_embed / input_proj stacks of ``Transformer.py:277-296,311-316``),
    channels last."""

    def __init__(self, in_ch: int, hidden: int, out: int):
        super().__init__()
        self.conv0 = nn.Linear(in_ch, hidden)
        self.bn = BatchNorm1d(hidden, eps=BN_EPS)
        self.conv1 = nn.Linear(hidden, out)

    def forward(self, x):
        return self.conv1(F.leaky_relu(self.bn(self.conv0(x)), 0.2))


class Fold(nn.Module):
    """FoldingNet rebuild (``PoinTr.py:16-58``): a 2D seed grid folded
    twice around each feature."""

    def __init__(self, in_channel: int, step: int, hidden_dim: int = 256):
        super().__init__()
        self.in_channel, self.step = in_channel, step
        for name, cin in (("folding1", in_channel + 2), ("folding2", in_channel + 3)):
            self.add_module(f"{name}_c0", nn.Linear(cin, hidden_dim))
            self.add_module(f"{name}_bn0", BatchNorm1d(hidden_dim, eps=BN_EPS))
            self.add_module(f"{name}_c1", nn.Linear(hidden_dim, hidden_dim // 2))
            self.add_module(f"{name}_bn1", BatchNorm1d(hidden_dim // 2, eps=BN_EPS))
            self.add_module(f"{name}_c2", nn.Linear(hidden_dim // 2, 3))

    def _folding(self, name, x):
        h = F.relu(getattr(self, f"{name}_bn0")(getattr(self, f"{name}_c0")(x)))
        h = F.relu(getattr(self, f"{name}_bn1")(getattr(self, f"{name}_c1")(h)))
        return getattr(self, f"{name}_c2")(h)

    def forward(self, x):                                     # [BM, C]
        s = self.step
        lin = torch.linspace(-1.0, 1.0, s, device=x.device, dtype=x.dtype)
        seed = torch.stack([lin.repeat(s), lin.repeat_interleave(s)], -1)    # [S, 2]
        bm = x.shape[0]
        seed = seed[None].expand(bm, s * s, 2)
        feat = x[:, None, :].expand(bm, s * s, self.in_channel)
        fd1 = self._folding("folding1", torch.cat([seed, feat], -1))
        return self._folding("folding2", torch.cat([fd1, feat], -1))       # [BM, S, 3]


class PCTransformer(nn.Module):
    """Geometry-aware encoder and decoder (``Transformer.py:262-425``)."""

    def __init__(self, embed_dim: int = 384, depth_enc: int = 6, depth_dec: int = 8,
                 num_heads: int = 6, num_query: int = 224, knn_layer: int = 1):
        super().__init__()
        self.num_query, self.depth_enc, self.depth_dec = num_query, depth_enc, depth_dec
        self.grouper = DGCNNGrouper()
        self.pos_embed = ConvBNLeaky(3, 128, embed_dim)
        self.input_proj = ConvBNLeaky(128, embed_dim, embed_dim)
        for i in range(depth_enc):
            self.add_module(f"encoder{i}", PoinTrEncBlock(embed_dim, num_heads,
                                                          use_knn=i < knn_layer))
        self.increase_dim = ConvBNLeaky(embed_dim, 1024, 1024)
        self.coarse_pred0 = nn.Linear(1024, 1024)
        self.coarse_pred1 = nn.Linear(1024, 3 * num_query)
        self.mlp_query0 = nn.Linear(1024 + 3, 1024)
        self.mlp_query1 = nn.Linear(1024, 1024)
        self.mlp_query2 = nn.Linear(1024, embed_dim)
        for i in range(depth_dec):
            self.add_module(f"decoder{i}", PoinTrDecBlock(embed_dim, num_heads,
                                                          use_knn=i < knn_layer))

    def forward(self, inpc):
        coor, f = self.grouper(inpc)
        pos = self.pos_embed(coor)
        x = self.input_proj(f)
        for i in range(self.depth_enc):
            x = getattr(self, f"encoder{i}")(x + pos, coor)
        bs = inpc.shape[0]
        glob = self.increase_dim(x).amax(1)                   # [B, 1024]
        coarse = self.coarse_pred1(F.relu(self.coarse_pred0(glob)))
        coarse = coarse.reshape(bs, self.num_query, 3)
        qf = torch.cat([glob[:, None, :].expand(bs, self.num_query, 1024), coarse], -1)
        q = F.leaky_relu(self.mlp_query0(qf), 0.2)
        q = F.leaky_relu(self.mlp_query1(q), 0.2)
        q = self.mlp_query2(q)
        for i in range(self.depth_dec):
            q = getattr(self, f"decoder{i}")(q, x, coarse, coor)
        return q, coarse


@MODELS.register_module("PoinTr")
class PoinTr(nn.Module):
    """(``PoinTr.py:60-123``). ``forward(xyz [B, N, 3])`` → (coarse [B, 2Q,
    3]: the predicted centres and Q FPS samples of the input, rebuild [B,
    Q*step^2 + N, 3]: the folded points and the input), in train and eval
    mode alike (train mode takes the BatchNorms' batch statistics)."""

    def __init__(self, config: Any):
        super().__init__()
        cfg = to_config(config)
        self.trans_dim = int(cfg.trans_dim)
        self.num_pred = int(cfg.num_pred)
        self.num_query = int(cfg.num_query)
        self.fold_step = int((self.num_pred // self.num_query) ** 0.5 + 0.5)
        self.base_model = PCTransformer(embed_dim=self.trans_dim, num_query=self.num_query,
                                        knn_layer=int(cfg.get("knn_layer", 1)))
        self.foldingnet = Fold(self.trans_dim, step=self.fold_step, hidden_dim=256)
        self.increase_dim = ConvBNLeaky(self.trans_dim, 1024, 1024)
        self.reduce_map = nn.Linear(1024 + self.trans_dim + 3, self.trans_dim)

    def forward(self, xyz):
        q, coarse = self.base_model(xyz)
        B, M, _ = q.shape
        glob = self.increase_dim(q).amax(1)
        feat = torch.cat([glob[:, None, :].expand(B, M, 1024), q, coarse], -1)
        feat = self.reduce_map(feat.reshape(B * M, -1))
        rel = self.foldingnet(feat)                           # [BM, S, 3]
        rebuild = (rel.reshape(B, M, -1, 3) + coarse[:, :, None, :]).reshape(B, -1, 3)
        inp_sparse, _ = fps(xyz, self.num_query)
        return torch.cat([coarse, inp_sparse], 1), torch.cat([rebuild, xyz], 1)

    @staticmethod
    def get_loss(ret, gt):
        """(Chamfer-L1 of the coarse points, of the rebuild) against ``gt``."""
        return chamfer_l1(ret[0], gt), chamfer_l1(ret[1], gt)
