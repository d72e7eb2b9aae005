"""AdaPoinTr, adaptive-query point cloud completion (counterpart of
``upp_tpu/models/adapointr.py``).

``models/AdaPoinTr.py``: a PCTransformer with adaptive query generation,
query ranking and the auxiliary denoising task, and the block styles of
``models/Transformer_utils.py`` that its released configs use:

* ``attn``         plain global self- or cross-attention
* ``graph``        DynamicGraphAttention (kNN edge-conv over token features,
  ``Transformer_utils.py:777-858``)
* ``rw_deform``    DeformableLocalAttention (``models/deform_attn.py``)
* ``deform``       DeformableLocalCrossAttention
* ``deform_graph`` improvedDeformableLocalGraphAttention
* combined styles such as ``attn-graph`` or ``attn-deform`` fuse a global and
  a local component by 'concat' (a merge Linear) or 'onebyone' (sequential
  residuals), as ``AdaPoinTr.py:15-311``.

A block creates only the submodules its style calls, with the JAX tree's
names, so ``weights.state_dict_from_jax`` loads it strictly. The denoise
task's attention mask (true queries never attend to denoise tokens,
``AdaPoinTr.py:217-237``) is additive, ``-1e9 * mask``. The denoise queries'
noise is ``jax.random.normal`` under ``make_rng("denoise")`` in JAX; here it
is passed in (``denoise_noise``) or drawn from a ``torch.Generator``.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.chamfer import chamfer_l1
from ..ops.fps import fps
from ..ops.geometry import index_points
from ..ops.knn import knn
from ..utils.config import to_config
from .build import MODELS
from .deform_attn import (DeformableGraphAttention, DeformableLocalAttention,
                          DeformableLocalCrossAttention, denoise_mask, smallest_k, sq_dists)
from .layers import Attention, Mlp, layer_norm
from .pointr import ConvBNLeaky, CrossAttention, DGCNNGrouper, Fold

STYLE_TOKENS = ("attn", "graph", "rw_deform", "deform", "deform_graph")


class MaskedAttention(Attention):
    """Self-attention (qkv without bias, proj) with an optional additive
    mask [N, N] (1 = masked)."""

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        B, N, C = x.shape
        H = self.num_heads
        hd = C // H
        qkv = self.qkv(x).reshape(B, N, 3, H, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]                      # [B, H, N, hd]
        attn = (q @ k.transpose(-2, -1)) * hd ** -0.5
        if mask is not None:
            attn = attn - 1e9 * mask
        attn = torch.softmax(attn, dim=-1)
        return self.proj((attn @ v).transpose(1, 2).reshape(B, N, C))


# the cross-attention of AdaPoinTr's blocks is PoinTr's (q_map, k_map, v_map, proj)
CrossAttn = CrossAttention


class DynamicGraphAttention(nn.Module):
    """kNN edge-conv over token features keyed by positions
    (``Transformer_utils.py:777-858``). Cross variant: queries gather
    neighbours from (v_pos, v)."""

    def __init__(self, dim: int, k: int = 10):
        super().__init__()
        self.k = k
        self.edge = nn.Linear(2 * dim, dim)

    def forward(self, x, pos, v=None, v_pos=None, denoise_length: Optional[int] = None):
        src, src_pos = (v, v_pos) if v is not None else (x, pos)
        if denoise_length and v is None:
            # true queries see only true keys; denoise tokens see everything
            with torch.no_grad():
                d = sq_dists(pos, src_pos).clamp_min(0).sqrt()
                n = pos.shape[1]
                idx = smallest_k(d.masked_fill(denoise_mask(n, n, denoise_length, d.device),
                                               torch.inf), self.k)
        else:
            _, idx = knn(pos, src_pos, self.k)
        nbrs = index_points(src, idx)                          # [B, N, k, C]
        center = x[:, :, None, :].expand_as(nbrs)
        h = F.leaky_relu(self.edge(torch.cat([nbrs - center, center], -1)), 0.2)
        return h.amax(2)


def _style_tokens(style: str) -> Tuple[bool, Optional[str]]:
    """(has_attn, local token) of a block style: the local token is one of
    graph / rw_deform / deform / deform_graph or None
    (``AdaPoinTr.py:45-62``). '-' only separates 'attn' from the local part."""
    tokens = style.split("-")
    if not all(t in STYLE_TOKENS for t in tokens):
        raise ValueError(f"unknown block style {style!r}")
    local = next((t for t in tokens if t != "attn"), None)
    return "attn" in tokens, local


def _local_attn(local: str, dim: int, num_heads: int) -> nn.Module:
    if local == "graph":
        return DynamicGraphAttention(dim)
    if local == "rw_deform":
        return DeformableLocalAttention(dim, num_heads)
    if local == "deform":
        return DeformableLocalCrossAttention(dim, num_heads)
    if local == "deform_graph":
        return DeformableGraphAttention(dim)
    raise ValueError(local)


class SelfAttnBlock(nn.Module):
    """(``AdaPoinTr.py:15-108``): any of attn / graph / rw_deform / deform /
    deform_graph, or attn-<local> combined by 'concat' or 'onebyone'."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 block_style: str = "attn", combine_style: str = "concat"):
        super().__init__()
        self.has_attn, self.local = _style_tokens(block_style)
        self.onebyone = bool(self.has_attn and self.local and combine_style == "onebyone")
        self.norm1 = layer_norm(dim)
        if self.has_attn:
            self.attn = MaskedAttention(dim, num_heads)
        if self.onebyone:
            self.norm3 = layer_norm(dim)
        if self.local:
            self.local_attn = _local_attn(self.local, dim, num_heads)
        if self.has_attn and self.local and not self.onebyone:
            self.merge_map = nn.Linear(2 * dim, dim)
        self.norm2 = layer_norm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def _run_local(self, h, pos, denoise_length):
        if self.local == "rw_deform":
            return self.local_attn(h, pos)
        return self.local_attn(h, pos, denoise_length=denoise_length)

    def forward(self, x, pos, mask=None, denoise_length=None):
        if self.onebyone:
            x = x + self.attn(self.norm1(x), mask)
            x = x + self._run_local(self.norm3(x), pos, denoise_length)
        else:
            norm_x = self.norm1(x)
            feats = []
            if self.has_attn:
                feats.append(self.attn(norm_x, mask))
            if self.local:
                feats.append(self._run_local(norm_x, pos, denoise_length))
            x = x + (feats[0] if len(feats) == 1 else self.merge_map(torch.cat(feats, -1)))
        return x + self.mlp(self.norm2(x))


class CrossAttnBlock(nn.Module):
    """(``AdaPoinTr.py:110-311``): masked self-attention → cross-attention →
    MLP, each part in its own style."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 self_style: str = "attn", cross_style: str = "attn",
                 self_combine: str = "concat", cross_combine: str = "concat"):
        super().__init__()
        self.has_attn, self.local = _style_tokens(self_style)
        self.has_cattn, self.clocal = _style_tokens(cross_style)
        if self.clocal == "rw_deform":
            raise ValueError("rw_deform is self-attention only (the reference asserts it)")
        self.self_onebyone = bool(self.has_attn and self.local and self_combine == "onebyone")
        self.cross_onebyone = bool(self.has_cattn and self.clocal
                                   and cross_combine == "onebyone")
        self.norm1 = layer_norm(dim)
        if self.has_attn:
            self.self_attn = MaskedAttention(dim, num_heads)
        if self.self_onebyone:
            self.norm3 = layer_norm(dim)
        if self.local:
            self.local_self_attn = _local_attn(self.local, dim, num_heads)
        if self.has_attn and self.local and not self.self_onebyone:
            self.self_attn_merge_map = nn.Linear(2 * dim, dim)
        self.norm_q = layer_norm(dim)
        self.norm_v = layer_norm(dim)
        if self.has_cattn:
            self.cross_attn = CrossAttn(dim, num_heads)
        if self.cross_onebyone:
            self.norm_q_2 = layer_norm(dim)
            self.norm_v_2 = layer_norm(dim)
        if self.clocal:
            self.local_cross_attn = _local_attn(self.clocal, dim, num_heads)
        if self.has_cattn and self.clocal and not self.cross_onebyone:
            self.cross_attn_merge_map = nn.Linear(2 * dim, dim)
        self.norm2 = layer_norm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def _run_self_local(self, h, q_pos, denoise_length):
        if self.local == "rw_deform":
            if denoise_length:
                # the reference's DeformableLocalAttention.forward has no
                # denoise_length parameter and raises on this combination
                raise ValueError("rw_deform self-attention does not support the denoise "
                                 "task (reference Transformer_utils.py:159)")
            return self.local_self_attn(h, q_pos)
        return self.local_self_attn(h, q_pos, denoise_length=denoise_length)

    def forward(self, q, v, q_pos, v_pos, denoise_length: Optional[int] = None):
        mask = None
        if denoise_length:
            n = q.shape[1]
            mask = denoise_mask(n, n, denoise_length, q.device).to(q.dtype)
        if self.self_onebyone:
            q = q + self.self_attn(self.norm1(q), mask)
            q = q + self._run_self_local(self.norm3(q), q_pos, denoise_length)
        else:
            norm_q = self.norm1(q)
            feats = []
            if self.has_attn:
                feats.append(self.self_attn(norm_q, mask))
            if self.local:
                feats.append(self._run_self_local(norm_q, q_pos, denoise_length))
            q = q + (feats[0] if len(feats) == 1
                     else self.self_attn_merge_map(torch.cat(feats, -1)))

        if self.cross_onebyone:
            q = q + self.cross_attn(self.norm_q(q), self.norm_v(v))
            q = q + self.local_cross_attn(self.norm_q_2(q), q_pos, v=self.norm_v_2(v),
                                          v_pos=v_pos)
        else:
            norm_q2, norm_v = self.norm_q(q), self.norm_v(v)
            feats = []
            if self.has_cattn:
                feats.append(self.cross_attn(norm_q2, norm_v))
            if self.clocal:
                feats.append(self.local_cross_attn(norm_q2, q_pos, v=norm_v, v_pos=v_pos))
            q = q + (feats[0] if len(feats) == 1
                     else self.cross_attn_merge_map(torch.cat(feats, -1)))
        return q + self.mlp(self.norm2(q))


class GeluMLP(nn.Module):
    def __init__(self, in_dim: int, hidden: int, out: int):
        super().__init__()
        self.lin0 = nn.Linear(in_dim, hidden)
        self.lin1 = nn.Linear(hidden, out)

    def forward(self, x):
        return self.lin1(F.gelu(self.lin0(x)))


class AdaPCTransformer(nn.Module):
    """(``AdaPoinTr.py:761-891``)."""

    def __init__(self, embed_dim: int = 384, enc_depth: int = 6, dec_depth: int = 8,
                 num_heads: int = 6, num_query: int = 256, global_feature_dim: int = 1024,
                 enc_styles: Sequence[str] = ("attn-graph",) + ("attn",) * 5,
                 dec_self_styles: Sequence[str] = ("attn-graph",) + ("attn",) * 7,
                 dec_cross_styles: Sequence[str] = ("attn-graph",) + ("attn",) * 7,
                 enc_combine: str = "concat", dec_self_combine: str = "concat",
                 dec_cross_combine: str = "concat", denoise_length: int = 64):
        super().__init__()
        self.num_query, self.denoise_length = num_query, denoise_length
        self.enc_depth, self.dec_depth = enc_depth, dec_depth
        self.global_feature_dim = global_feature_dim
        self.grouper = DGCNNGrouper()
        self.pos_embed = GeluMLP(3, 128, embed_dim)
        self.input_proj = GeluMLP(128, 512, embed_dim)
        for i in range(enc_depth):
            self.add_module(f"encoder{i}", SelfAttnBlock(
                embed_dim, num_heads, block_style=enc_styles[i], combine_style=enc_combine))
        self.increase_dim = GeluMLP(embed_dim, 1024, global_feature_dim)
        self.coarse_pred = GeluMLP(global_feature_dim, 1024, 3 * num_query)
        self.query_ranking0 = nn.Linear(3, 256)
        self.query_ranking1 = nn.Linear(256, 256)
        self.query_ranking2 = nn.Linear(256, 1)
        self.mlp_query0 = nn.Linear(global_feature_dim + 3, 1024)
        self.mlp_query1 = nn.Linear(1024, 1024)
        self.mlp_query2 = nn.Linear(1024, embed_dim)
        for i in range(dec_depth):
            self.add_module(f"decoder{i}", CrossAttnBlock(
                embed_dim, num_heads, self_style=dec_self_styles[i],
                cross_style=dec_cross_styles[i], self_combine=dec_self_combine,
                cross_combine=dec_cross_combine))

    def forward(self, xyz, denoise_noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        bs = xyz.shape[0]
        coor, f = self.grouper(xyz)
        x = self.input_proj(f) + self.pos_embed(coor)
        for i in range(self.enc_depth):
            x = getattr(self, f"encoder{i}")(x, coor)
        glob = self.increase_dim(x).amax(1)
        coarse = self.coarse_pred(glob).reshape(bs, self.num_query, 3)
        coarse_inp, _ = fps(xyz, self.num_query // 2)
        coarse = torch.cat([coarse, coarse_inp], 1)

        # query ranking: keep the top num_query of the 1.5x candidates
        # (AdaPoinTr.py:858-861); a stable ascending sort of -rank orders
        # ties by the lowest index, as jnp.argsort does
        h = F.gelu(self.query_ranking0(coarse))
        h = F.gelu(self.query_ranking1(h))
        rank = torch.sigmoid(self.query_ranking2(h))[..., 0]
        order = torch.argsort(-rank, dim=1, stable=True)[:, :self.num_query]
        coarse = index_points(coarse, order)

        denoise_length = 0
        if self.training:
            picked, _ = fps(xyz, self.denoise_length)
            if denoise_noise is None:
                denoise_noise = torch.randn(picked.shape, generator=generator,
                                            device=picked.device, dtype=picked.dtype)
            picked = picked + torch.clamp(0.01 * denoise_noise, -0.05, 0.05)
            coarse = torch.cat([coarse, picked], 1)
            denoise_length = self.denoise_length

        n_q = coarse.shape[1]
        qf = torch.cat([glob[:, None, :].expand(bs, n_q, self.global_feature_dim), coarse], -1)
        q = F.gelu(self.mlp_query0(qf))
        q = F.gelu(self.mlp_query1(q))
        q = self.mlp_query2(q)
        for i in range(self.dec_depth):
            q = getattr(self, f"decoder{i}")(q, x, coarse, coor,
                                             denoise_length=denoise_length or None)
        return q, coarse, denoise_length


@MODELS.register_module("AdaPoinTr")
class AdaPoinTr(nn.Module):
    """(``AdaPoinTr.py:893-996``). In train mode ``forward`` returns
    (pred_coarse, denoised_coarse, denoised_fine, pred_fine), in eval mode
    (coarse, rebuild). The denoise queries' noise [B, 64, 3] is
    ``denoise_noise`` when given, else a draw from ``generator`` (torch's
    RNG when None)."""

    def __init__(self, config: Any):
        super().__init__()
        cfg = to_config(config)
        dec = cfg.get("decoder_config", cfg)
        enc = cfg.get("encoder_config", cfg)
        self.trans_dim = int(dec.get("embed_dim", 384))
        self.num_query = int(cfg.num_query)
        num_points = cfg.get("num_points", None)
        self.decoder_type = cfg.get("decoder_type", "fc")
        self.fold_step = 8
        if self.decoder_type == "fold":
            self.factor = self.fold_step ** 2
            self.decode_head = Fold(self.trans_dim, step=self.fold_step, hidden_dim=256)
        else:
            self.factor = (int(num_points) // self.num_query if num_points
                           else self.fold_step ** 2)
            self.rebuild_hidden = nn.Linear(2 * self.trans_dim, 512)
            self.rebuild_out = nn.Linear(512, 3 * self.factor)
        enc_depth = int(enc.get("depth", 6))
        dec_depth = int(dec.get("depth", 8))

        def styles(node, key, depth):
            lst = node.get(key, None)
            if lst is None:
                lst = ["attn-graph"] + ["attn"] * (depth - 1)
            if len(lst) != depth:
                raise ValueError(f"{key}: {len(lst)} styles for depth {depth}")
            return tuple(lst)

        # style lists and combine modes from the config, the keys the
        # reference's PointTransformerEncoder/DecoderEntry expand
        # (AdaPoinTr.py:389-476); defaults: the released configs' zoo
        self.base_model = AdaPCTransformer(
            embed_dim=self.trans_dim, num_query=self.num_query,
            enc_depth=enc_depth, dec_depth=dec_depth,
            enc_styles=styles(enc, "block_style_list", enc_depth),
            enc_combine=str(enc.get("combine_style", "concat")),
            dec_self_styles=styles(dec, "self_attn_block_style_list", dec_depth),
            dec_self_combine=str(dec.get("self_attn_combine_style", "concat")),
            dec_cross_styles=styles(dec, "cross_attn_block_style_list", dec_depth),
            dec_cross_combine=str(dec.get("cross_attn_combine_style", "concat")))
        self.increase_dim = ConvBNLeaky(self.trans_dim, 1024, 1024)
        self.reduce_map = nn.Linear(1024 + self.trans_dim + 3, self.trans_dim)

    def forward(self, xyz, denoise_noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        q, coarse, denoise_length = self.base_model(xyz, denoise_noise, generator)
        B, M, _ = q.shape
        glob = self.increase_dim(q).amax(1)
        feat = torch.cat([glob[:, None, :].expand(B, M, 1024), q, coarse], -1)
        if self.decoder_type == "fold":
            rel = self.decode_head(self.reduce_map(feat.reshape(B * M, -1)))
            rebuild = rel.reshape(B, M, -1, 3) + coarse[:, :, None, :]
        else:
            feat = self.reduce_map(feat)                      # [B, M, C]
            # SimpleRebuildFCLayer (AdaPoinTr.py:737-758): global + token
            g2 = feat.amax(1, keepdim=True).expand_as(feat)
            h = F.gelu(self.rebuild_hidden(torch.cat([g2, feat], -1)))
            rebuild = self.rebuild_out(h).reshape(B, M, self.factor, 3) + coarse[:, :, None, :]
        if denoise_length:
            d = denoise_length
            return (coarse[:, :-d], coarse[:, -d:], rebuild[:, -d:].reshape(B, -1, 3),
                    rebuild[:, :-d].reshape(B, -1, 3))
        return coarse, rebuild.reshape(B, -1, 3)

    def get_loss(self, ret, gt):
        """(``AdaPoinTr.py:924-946``): (0.5 x the denoise Chamfer-L1, coarse
        plus fine Chamfer-L1). The denoise targets are each denoise centre's
        ``factor`` nearest ground-truth points: on CUDA the kNN kernel,
        which takes k <= 32, so the ``fold`` decoder's 64 raises there."""
        pred_coarse, denoised_coarse, denoised_fine, pred_fine = ret
        _, idx = knn(denoised_coarse, gt, self.factor)
        target = index_points(gt, idx).reshape(gt.shape[0], -1, 3)
        loss_denoised = chamfer_l1(denoised_fine, target) * 0.5
        loss_recon = chamfer_l1(pred_coarse, gt) + chamfer_l1(pred_fine, gt)
        return loss_denoised, loss_recon
