"""Part-segmentation models (counterpart of ``upp_tpu/models/unify_seg.py``):
Point_MAE_unify_seg (UPP PEFT, reference
``models/Point_MAE_unify_segment.py:328-625``) and PointTransformer_seg (full
fine-tune, ``models/Point_MAE_segment.py:275-456``).

The UPP model runs the rectify and completion front end of the classifier
(with the 64-group completion geometry), then the downstream pass over
``num_group`` groups, tapping the features after blocks {3, 7, 11}; global
max and mean pooling of the taps with a 128-d embedding of the 16-class
one-hot label; inverse-distance propagation of the group features to the
full-resolution query points (k = 3, k = 5 for PointTransformer_seg); and a
pointwise head giving log-probabilities over the 50 part classes.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fps import fps
from ..ops.group import group_points
from ..utils.config import to_config
from .build import MODELS
from .layers import BN_EPS, Dropout, Encoder, PointConv, PosEmbedMLP, batch_norm_last
from .prompter import PointNetFeaturePropagation
from .scan_blocks import ScannedEncoderStack
from .unify import _UnifyCore

FEATURE_BLOCKS = (3, 7, 11)
LABEL_DIM = 128         # label embedding width
PROP_MLP = (384 * 4, 1024)   # propagation_0's convs, fixed in the reference


class LabelConv(nn.Sequential):
    """16-class one-hot → 128-d label embedding
    (``Point_MAE_unify_segment.py:414-420``): [conv, BN, LeakyReLU] x 2."""

    def __init__(self, num_classes: int = 16):
        super().__init__(
            PointConv(num_classes, 64), nn.BatchNorm1d(64, eps=BN_EPS), nn.LeakyReLU(0.2),
            PointConv(64, LABEL_DIM), nn.BatchNorm1d(LABEL_DIM, eps=BN_EPS),
            nn.LeakyReLU(0.2))

    def forward(self, one_hot: torch.Tensor) -> torch.Tensor:
        x = one_hot
        for m in self:
            x = batch_norm_last(m, x) if isinstance(m, nn.BatchNorm1d) else m(x)
        return x                                                # [B, 128]


class SplitConv(PointConv):
    """The first seg-head conv over [per-point ‖ per-cloud] features without
    the concat (``upp_tpu/models/unify_seg.py:47`` ``_SplitDense``): the
    reference repeats the per-cloud row over all N points before this conv
    (``Point_MAE_unify_segment.py:597-613``); the product splits the weight's
    input columns instead, ``f0 @ W[:, :in_pp].T + glob @ W[:, in_pp:].T + b``,
    the per-cloud term once per cloud. The weight is the one fused
    [out, in_pp + in_glob, 1] tensor of the reference's ``.pth``."""

    def __init__(self, in_pp: int, in_glob: int, out_ch: int):
        super().__init__(in_pp + in_glob, out_ch)
        self.in_pp = in_pp

    def forward(self, f0: torch.Tensor, glob: torch.Tensor) -> torch.Tensor:
        w = self.weight.reshape(self.weight.shape[0], -1)
        per_point = f0 @ w[:, :self.in_pp].T                   # [B, N, out]
        per_cloud = F.linear(glob, w[:, self.in_pp:], self.bias)  # [B, out]
        return per_point + per_cloud[:, None, :]


class SegHead(nn.Sequential):
    """Pointwise seg head (``Point_MAE_unify_segment.py:424-433``): [conv,
    BN, ReLU, Dropout(0.5)], [conv, BN, ReLU], conv → log-softmax over
    ``cls_dim``. Takes the per-point features and the per-cloud row apart
    (``SplitConv``)."""

    def __init__(self, in_glob: int, cls_dim: int, in_pp: int = PROP_MLP[-1]):
        super().__init__(
            SplitConv(in_pp, in_glob, 512), nn.BatchNorm1d(512, eps=BN_EPS), nn.ReLU(),
            Dropout(0.5),
            PointConv(512, 256), nn.BatchNorm1d(256, eps=BN_EPS), nn.ReLU(),
            PointConv(256, cls_dim))

    def forward(self, f0: torch.Tensor, glob: torch.Tensor) -> torch.Tensor:
        x = self[0](f0, glob)
        for m in list(self)[1:]:
            x = batch_norm_last(m, x) if isinstance(m, nn.BatchNorm1d) else m(x)
        return F.log_softmax(x, dim=-1)                         # [B, N, cls]


def seg_features(taps: Sequence[torch.Tensor], label_emb: torch.Tensor):
    """(per-group features [B, G, 3C], per-cloud row [B, 6C + 128]): the
    taps concatenated, their max and mean over the groups and the label
    embedding (``Point_MAE_unify_segment.py:596-606``)."""
    x = torch.cat(list(taps), dim=-1)
    glob = torch.cat([x.amax(1), x.mean(1), label_emb], dim=-1)
    return x, glob


class _SegTail(nn.Module):
    """The label embedding, the propagation to the query points and the seg
    head, shared by both seg models (top-level ``.pth`` keys)."""

    def _init_tail(self, trans_dim: int, depth: int, cls_dim: int, neighbors: int):
        n_taps = sum(i < depth for i in FEATURE_BLOCKS)
        self.label_conv = LabelConv()
        self.propagation_0 = PointNetFeaturePropagation(
            3 + n_taps * trans_dim, PROP_MLP, interpolate_neighbors=neighbors)
        self.seg_head = SegHead(2 * n_taps * trans_dim + LABEL_DIM, cls_dim)

    def _segment(self, query, center, taps, cls_label):
        x, glob = seg_features(taps, self.label_conv(cls_label))
        f0 = self.propagation_0(query, center, query, x)        # [B, N, 1024]
        return self.seg_head(f0, glob)


@MODELS.register_module("Point_MAE_unify_seg")
class PointMAEUnifySeg(_UnifyCore, _SegTail):
    """UPP segmentation model (``Point_MAE_unify_segment.py:328-625``)."""

    def __init__(self, config: Any):
        cfg = to_config(config)
        # the seg front end keeps the 64-group completion geometry whatever
        # num_group the downstream pass uses (``Point_MAE_unify_segment.py:343``)
        super().__init__(cfg, num_group=64, if_half=bool(cfg.get("if_half", False)))
        self._init_tail(self.trans_dim, len(self.blocks.blocks), cfg.cls_dim, neighbors=3)
        self.prompt_propagation_after = bool(cfg.get("prompt_propagation_after", False))
        # the shipped seg config gathers per sample (gather_idx True), into
        # the prompt-augmented tokens unless propagation_semantics is 'clean'
        self.gather_mode = {"gather_idx": bool(cfg.get("gather_idx", True)),
                            "quirk": cfg.get("propagation_semantics", "reference") != "clean"}

    def forward(self, pts: torch.Tensor, cls_label: torch.Tensor,
                label_points: Optional[torch.Tensor] = None, *,
                completion_prompt: bool = True, denoise: bool = True,
                point_num: int = 1024) -> torch.Tensor:
        """Log-probabilities [B, N, cls_dim] at the query points
        ``label_points`` [B, N, 3] (``pts`` when None), from clouds ``pts``
        [B, P, 3] and the one-hot category ``cls_label`` [B, 16]."""
        query = label_points if label_points is not None else pts
        if denoise:
            pts = self.denoise_pts(pts, point_num)
        if completion_prompt:
            _, rebuild = self.complete(pts)
            sample_rebuild, _ = fps(rebuild, point_num // 4)
            pts = torch.cat([pts, sample_rebuild], dim=1)
            if pts.shape[1] > point_num:
                pts, _ = fps(pts, point_num)

        g = group_points(pts, self.num_group, self.group_size)
        tokens = self.encoder(g.neighborhood)
        propagation = None
        if self.prompt_propagation_after:
            lvl2 = group_points(g.center, self.num_group // 2, 8)
            propagation = {"center1": g.center, "center1_idx": lvl2.idx,
                           "center2": lvl2.center, "center2_idx": lvl2.center_idx,
                           **self.gather_mode}
        _, taps = self.blocks(tokens, self.pos_embed(g.center), path="downstream",
                              propagation=propagation, feature_blocks=FEATURE_BLOCKS)
        return self._segment(query, g.center, taps, cls_label)


@MODELS.register_module("PointTransformer_seg")
class PointTransformerSeg(_SegTail):
    """Full fine-tune segmentation baseline (``Point_MAE_segment.py:275-456``):
    the same tail after a plain stack (no prompts, no adapters, no
    propagation), with 5 interpolation neighbours."""

    def __init__(self, config: Any):
        super().__init__()
        cfg = to_config(config)
        self.num_group = cfg.num_group
        self.group_size = cfg.group_size
        self.encoder = Encoder(cfg.encoder_dims)
        self.pos_embed = PosEmbedMLP(cfg.trans_dim)
        self.blocks = ScannedEncoderStack(cfg.trans_dim, cfg.depth, cfg.num_heads,
                                          drop_path_rate=cfg.drop_path_rate)
        self._init_tail(cfg.trans_dim, cfg.depth, cfg.cls_dim, neighbors=5)

    def forward(self, pts: torch.Tensor, cls_label: torch.Tensor,
                label_points: Optional[torch.Tensor] = None, **_ignored) -> torch.Tensor:
        query = label_points if label_points is not None else pts
        g = group_points(pts, self.num_group, self.group_size)
        tokens = self.encoder(g.neighborhood)
        _, taps = self.blocks(tokens, self.pos_embed(g.center), path="none",
                              feature_blocks=FEATURE_BLOCKS)
        return self._segment(query, g.center, taps, cls_label)
