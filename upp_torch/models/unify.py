"""UPP unified models (counterpart of ``upp_tpu/models/unify.py``):
Point_MAE_unify, the classifier (reference
``models/Point_MAE_unify.py:390-655``), and Point_MAE_pretask_dev, the
prompter-pretraining model (``models/Point_MAE_pretask_dev.py:520-741``).

Three passes over one shared prompted backbone: rectify (depth 3, per-point
rectification vectors, top-5% drop), completion (depth 6, coarse missing
centers, 4-block decoder, dense rebuild, re-FPS) and downstream (12 blocks
with prompt propagation) → classification head. Both models train: in
``.train()`` every pass runs in train mode, as the JAX package's
``deterministic=False`` does (BatchNorm on batch statistics, the encoder's
updated once per pass in order; dropout; drop-path).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
from torch import nn

from ..ops.fps import fps
from ..ops.group import group_points
from ..ops.knn import knn_points
from ..ops.propagate import propagate
from ..utils.config import to_config
from .blocks import PrompterConfig
from .build import MODELS
from .layers import (BN_EPS, BatchNorm1d, Dropout, Encoder, PointConv, PosEmbedMLP,
                     TwoLayerHead, layer_norm)
from .prompter import RectifyPrompter
from .scan_blocks import ScannedDecoderStack, ScannedEncoderStack


class ClsHead(nn.Sequential):
    """cls_head_finetune (``Point_MAE_unify.py:475-485``): 2x
    [Linear → BN → ReLU → Dropout(.5)] → Linear(cls_dim)."""

    def __init__(self, in_dim: int, cls_dim: int):
        super().__init__(
            nn.Linear(in_dim, 256), BatchNorm1d(256, eps=BN_EPS), nn.ReLU(),
            Dropout(0.5),
            nn.Linear(256, 256), BatchNorm1d(256, eps=BN_EPS), nn.ReLU(),
            Dropout(0.5),
            nn.Linear(256, cls_dim))


class _UnifyCore(nn.Module):
    """The submodules and passes shared by the unify family. Subclasses hold
    them at the top level, as the reference's ``.pth`` keys do."""

    vis_short = 16

    def __init__(self, cfg, num_group: Optional[int] = None):
        """``num_group``: the group count of the rectify and completion
        geometry, the config's unless given (the segmentation model keeps
        64 while its downstream pass groups ``cfg.num_group``)."""
        super().__init__()
        tc = cfg.transformer_config
        trans_dim, group_size = tc.trans_dim, cfg.group_size
        geometry = cfg.num_group if num_group is None else num_group
        drop_path_rate = tc.drop_path_rate
        self.trans_dim = trans_dim
        self.group_size = group_size
        self.num_group = cfg.num_group         # the downstream pass's groups
        # visible groups: the reference hardcodes the 64-group anchor; the
        # JAX package generalises to num_group (identical at 64)
        self.vis_num = geometry - int(tc.mask_ratio * geometry)
        n_mask = geometry - self.vis_num
        self.encoder = Encoder(tc.encoder_dims)
        self.pos_embed = PosEmbedMLP(trans_dim)
        self.blocks = ScannedEncoderStack(
            trans_dim, tc.depth, tc.num_heads,
            prompter=PrompterConfig.from_cfg(cfg.get("prompter_config")),
            drop_path_rate=drop_path_rate)
        self.norm = layer_norm(trans_dim)
        self.shape_pred = TwoLayerHead(trans_dim, trans_dim // 2, self.vis_short)
        self.coarse_pred = TwoLayerHead(self.vis_short * self.vis_num, trans_dim,
                                        3 * n_mask)
        self.predict_token_generator = TwoLayerHead(trans_dim, 128, trans_dim)
        self.decoder_pos_embed = PosEmbedMLP(trans_dim)
        self.MAE_decoder = ScannedDecoderStack(trans_dim, tc.decoder_depth,
                                               tc.decoder_num_heads,
                                               drop_path_rate=drop_path_rate)
        self.dense_pred = nn.Sequential(PointConv(trans_dim, 3 * group_size))
        self.rectify_prompter = RectifyPrompter(hidden_dimension=trans_dim)
        self.mask_token = nn.Parameter(torch.zeros(1, 1, trans_dim))
        nn.init.trunc_normal_(self.mask_token, std=0.02)

    def rectify_vectors(self, pts: torch.Tensor) -> torch.Tensor:
        """Rectify pass: 16-nn tokens over vis_num centers → prompted blocks
        → per-point rectification vector (``Point_MAE_unify.py:541-554``)."""
        g = group_points(pts, self.vis_num, 16)
        tokens = self.encoder(g.neighborhood)
        tokens = self.blocks(tokens, self.pos_embed(g.center), path="rectify")
        return self.rectify_prompter(pts, g.center, tokens)

    def denoise_pts(self, pts: torch.Tensor, point_num: int) -> torch.Tensor:
        """Nudge points along the rectification vector and drop the noisiest
        points, keeping 95% of ``point_num`` (``Point_MAE_unify.py:554-559``)."""
        pred_vector = self.rectify_vectors(pts)
        score = torch.linalg.norm(pred_vector, dim=-1)            # [B, P]
        order = torch.argsort(-score, dim=1, stable=True)          # descending
        pts = pts + 0.2 * pred_vector
        keep_idx = order[:, -int(point_num * 0.95):]
        return torch.gather(pts, 1, keep_idx[..., None].expand(-1, -1, 3))

    def complete(self, pts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Completion pass (``Point_MAE_unify.py:572-610``): prompted blocks
        → coarse missing centers → propagated mask tokens → decoder → dense
        rebuild. Returns (predict_center [B,M,3], rebuild [B,M*S,3])."""
        g = group_points(pts, self.vis_num, 16)
        x_vis = self.encoder(g.neighborhood)
        x_vis = self.blocks(x_vis, self.pos_embed(g.center), path="pretask")
        x_vis = self.norm(x_vis)

        B = pts.shape[0]
        pos_emd_vis = self.decoder_pos_embed(g.center)
        shape_feature = self.shape_pred(x_vis).reshape(B, self.vis_short * self.vis_num)
        predict_center = self.coarse_pred(shape_feature).reshape(B, -1, 3)
        predict_token = self.predict_token_generator(x_vis)
        pos_emd_mask = self.decoder_pos_embed(predict_center)
        n_mask = predict_center.shape[1]
        mask_token = self.mask_token.expand(B, n_mask, -1)
        mask_token = propagate(predict_center, g.center, mask_token,
                               predict_token, de_neighbors=6)
        x_full = torch.cat([x_vis, mask_token], dim=1)
        pos_full = torch.cat([pos_emd_vis, pos_emd_mask], dim=1)
        x_rec = self.MAE_decoder(x_full, pos_full, n_mask)
        rel = self.dense_pred(x_rec).reshape(B, n_mask, self.group_size, 3)
        rebuild = (rel + predict_center[:, :, None, :]).reshape(B, -1, 3)
        return predict_center, rebuild


@MODELS.register_module("Point_MAE_unify")
class PointMAEUnify(_UnifyCore):
    """UPP classification model (``models/Point_MAE_unify.py:390-655``)."""

    def __init__(self, config: Any):
        cfg = to_config(config)
        super().__init__(cfg)
        semantics = cfg.get("propagation_semantics", "reference")
        if semantics not in ("reference", "clean"):
            raise ValueError(f"propagation_semantics {semantics!r}: 'reference' "
                             "or 'clean'")
        # the propagation's gather mode (ScannedEncoderStack._propagate): the
        # reference's quirky gather unless the config opts into 'clean'
        self.gather_mode = {"gather_idx": bool(cfg.get("gather_idx", False)),
                            "quirk": semantics == "reference"}
        self.prompt_propagation_after = bool(cfg.get("prompt_propagation_after", False))
        self.cls_token = nn.Parameter(torch.zeros(1, 1, self.trans_dim))
        self.cls_pos = nn.Parameter(torch.zeros(1, 1, self.trans_dim))
        nn.init.trunc_normal_(self.cls_token, std=0.02)
        nn.init.trunc_normal_(self.cls_pos, std=0.02)
        self.cls_head_finetune = ClsHead(2 * self.trans_dim, cfg.cls_dim)

    def forward(self, pts: torch.Tensor, *, completion_prompt: bool = False,
                denoise: bool = False, point_num: int = 1024) -> torch.Tensor:
        """Logits [B, cls_dim] of clouds ``pts`` [B, P, 3]; ``denoise`` runs
        the rectify pass, ``completion_prompt`` the completion pass."""
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
        B = tokens.shape[0]
        pos = torch.cat([self.cls_pos.expand(B, -1, -1), self.pos_embed(g.center)], dim=1)
        x = torch.cat([self.cls_token.expand(B, -1, -1), tokens], dim=1)

        propagation = None
        if self.prompt_propagation_after:
            lvl2 = group_points(g.center, self.num_group // 2, 8)
            propagation = {"center1": g.center, "center1_idx": lvl2.idx,
                           "center2": lvl2.center, "center2_idx": lvl2.center_idx,
                           **self.gather_mode}
        x = self.blocks(x, pos, path="downstream", classification=True,
                        propagation=propagation)
        x = self.norm(x)
        concat_f = torch.cat([x[:, 0], x[:, 1:].amax(1)], dim=-1)
        return self.cls_head_finetune(concat_f)


@MODELS.register_module("Point_MAE_pretask_dev")
class PointMAEPretask(_UnifyCore):
    """Prompter pretraining model (``models/Point_MAE_pretask_dev.py:520-741``).

    In ``.train()`` with noise (``train_with_gaussian``) the rectify pass is
    supervised by the mean displacement of each injected noise point to its
    K=4 nearest clean points, and the P - point_num noisiest points are
    dropped (no gradient through the drop) before the completion pass:
    returns (predict_center, rebuild, noise_loss, recall). Otherwise it runs
    the completion pass alone: (predict_center, rebuild). The config's
    ``gather_idx`` and ``prompt_propagation_after`` are accepted and unused,
    as in the JAX package: no pretask pass propagates prompts."""

    def __init__(self, config: Any):
        super().__init__(to_config(config))

    def forward(self, pts: torch.Tensor, *, point_num: int = 2048,
                train_with_gaussian: bool = True):
        if not (train_with_gaussian and self.training):
            return self.complete(pts)
        B, P, _ = pts.shape
        pred_vector = self.rectify_vectors(pts)
        noise, partial = pts[:, point_num:], pts[:, :point_num]
        # supervision: mean displacement to the K=4 nearest clean points
        # (Point_MAE_pretask_dev.py:680-689)
        _, _, clean_nn = knn_points(noise, partial, 4)
        noise_vector = (clean_nn - noise[:, :, None, :]).mean(-2)
        positive = ((pred_vector[:, point_num:] - noise_vector) ** 2).sum(-1).mean()
        negative = (pred_vector[:, :point_num] ** 2).sum(-1).mean()
        noise_loss = positive + negative

        score = torch.linalg.norm(pred_vector, dim=-1)
        order = torch.argsort(-score, dim=1, stable=True)         # descending
        n_drop = P - point_num
        recall = ((order[:, :n_drop] >= point_num).float().sum(-1) / n_drop).mean()
        keep_idx = order[:, n_drop:]
        pts = torch.gather(pts, 1, keep_idx[..., None].expand(-1, -1, 3)).detach()
        predict_center, rebuild = self.complete(pts)
        return predict_center, rebuild, noise_loss, recall
