"""Baseline (non-prompted) models (counterpart of ``upp_tpu/models/baseline.py``):
``Point_MAE`` pretraining (reference ``models/Point_MAE_cp.py:239-465``) and
``PointTransformer``, the full fine-tune classifier (``Point_MAE_cp.py:468-596``).

Module names follow the reference ``.pth``: ``Point_MAE`` keeps its encoder
side under ``MAE_encoder`` (``encoder``, ``pos_embed``, ``blocks``,
``norm``) beside ``MAE_decoder``, ``decoder_pos_embed``, ``increase_dim.0``
and ``mask_token``, so ``ckpt_io``'s ``MAE_encoder.`` strip loads a pretrain
checkpoint into ``PointTransformer`` without renaming (the reference's
fine-tune recipe). ``Point_MAE``'s ``if_half: True`` runs its encoder's
convolutions and both block stacks in bf16 products with float32
accumulation (``layers.half_matmul``; ``upp_tpu/models/baseline.py:42-46``);
parameters, BatchNorm statistics, the LayerNorms, the positional
embeddings and the rebuild head stay float32.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
from torch import nn

from ..ops.chamfer import chamfer_l1, chamfer_l2
from ..ops.geometry import index_points
from ..ops.group import group_points
from ..parallel import shard
from ..utils.config import to_config
from .build import MODELS
from .layers import Encoder, PointConv, PosEmbedMLP, compute_dtype, layer_norm
from .scan_blocks import ScannedDecoderStack, ScannedEncoderStack
from .unify import ClsHead


class MaskTransformer(nn.Module):
    """The encoder side of ``Point_MAE`` (``MAE_encoder.*``): group tokenizer,
    positional embedding, the plain block stack and its LayerNorm."""

    def __init__(self, tc, cdtype: torch.dtype = torch.float32):
        super().__init__()
        self.encoder = Encoder(tc.encoder_dims, cdtype)
        self.pos_embed = PosEmbedMLP(tc.trans_dim)
        self.blocks = ScannedEncoderStack(tc.trans_dim, tc.depth, tc.num_heads,
                                          drop_path_rate=tc.drop_path_rate, plain=True,
                                          compute_dtype=cdtype)
        self.norm = layer_norm(tc.trans_dim)


@MODELS.register_module("Point_MAE")
class PointMAE(nn.Module):
    """Vanilla Point-MAE: a random ``mask_ratio`` of the groups masked per
    sample, the encoder over the visible ones, the decoder over them and the
    mask tokens, a pointwise rebuild of each masked neighbourhood, and the
    Chamfer loss (``loss: cdl2``, or ``cdl1``) against it."""

    def __init__(self, config: Any):
        super().__init__()
        cfg = to_config(config)
        tc = cfg.transformer_config
        cdtype = compute_dtype(bool(cfg.get("if_half", False)))
        self.trans_dim = tc.trans_dim
        self.num_group = cfg.num_group
        self.group_size = cfg.group_size
        self.num_mask = int(tc.mask_ratio * cfg.num_group)
        self.loss_fn = chamfer_l1 if cfg.get("loss", "cdl2") == "cdl1" else chamfer_l2
        self.MAE_encoder = MaskTransformer(tc, cdtype)
        self.decoder_pos_embed = PosEmbedMLP(tc.trans_dim)
        self.MAE_decoder = ScannedDecoderStack(tc.trans_dim, tc.decoder_depth,
                                               tc.decoder_num_heads,
                                               drop_path_rate=tc.drop_path_rate,
                                               plain=True, compute_dtype=cdtype)
        self.increase_dim = nn.Sequential(PointConv(tc.trans_dim, 3 * cfg.group_size))
        self.mask_token = nn.Parameter(torch.zeros(1, 1, tc.trans_dim))
        nn.init.trunc_normal_(self.mask_token, std=0.02)

    def rand_mask_idx(self, B: int, device: torch.device,
                      generator: Optional[torch.Generator] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """A per-sample random permutation of the groups split as the JAX
        package splits it: (visible [B, G - num_mask], masked [B,
        num_mask]), in permutation order, not sorted."""
        G = self.num_group
        perm = torch.argsort(shard.rand((B, G), generator=generator, device=device), dim=1)
        return perm[:, :G - self.num_mask], perm[:, G - self.num_mask:]

    def forward(self, pts: torch.Tensor, *, eval_features: bool = False,
                masks: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The reconstruction loss of clouds ``pts`` [B, N, 3] (a 0-d
        tensor); the mask draw and drop-path come from ``generator``
        (torch's RNG when None), or the split is ``masks`` = (visible,
        masked) group indices. With ``eval_features``: the linear-probe
        features [B, trans_dim] (``Point_MAE_cp.py:342-348,425-429``), all
        groups through the stack, the max over ``norm(x)``; the caller puts
        the model in ``.eval()`` for running BatchNorm statistics."""
        enc = self.MAE_encoder
        g = group_points(pts, self.num_group, self.group_size)
        if eval_features:
            x = enc.blocks(enc.encoder(g.neighborhood), enc.pos_embed(g.center), path="none")
            return enc.norm(x).amax(1)

        B = pts.shape[0]
        vis_idx, mask_idx = (masks if masks is not None
                             else self.rand_mask_idx(B, pts.device, generator))
        vis_center = index_points(g.center, vis_idx)
        mask_center = index_points(g.center, mask_idx)
        S = self.group_size
        mask_neigh = torch.gather(g.neighborhood, 1,
                                  mask_idx[:, :, None, None].expand(-1, -1, S, 3))
        tokens = enc.encoder(g.neighborhood, vis_idx=vis_idx)
        x_vis = enc.blocks(tokens, enc.pos_embed(vis_center), path="none",
                           generator=generator)
        x_vis = enc.norm(x_vis)

        M = mask_idx.shape[1]
        x_full = torch.cat([x_vis, self.mask_token.expand(B, M, -1)], dim=1)
        pos_full = torch.cat([self.decoder_pos_embed(vis_center),
                              self.decoder_pos_embed(mask_center)], dim=1)
        x_rec = self.MAE_decoder(x_full, pos_full, M, generator=generator)
        rebuild = self.increase_dim(x_rec).reshape(B * M, S, 3)
        return self.loss_fn(rebuild, mask_neigh.reshape(B * M, S, 3))


@MODELS.register_module("PointTransformer")
class PointTransformer(nn.Module):
    """The plain 12-block ViT classifier of the full fine-tune: tokens with
    a cls token, the plain stack, ``[x_0 ‖ max(x_1:)]`` into the head."""

    def __init__(self, config: Any):
        super().__init__()
        cfg = to_config(config)
        self.num_group = cfg.num_group
        self.group_size = cfg.group_size
        self.encoder = Encoder(cfg.encoder_dims)
        self.pos_embed = PosEmbedMLP(cfg.trans_dim)
        self.blocks = ScannedEncoderStack(cfg.trans_dim, cfg.depth, cfg.num_heads,
                                          drop_path_rate=cfg.drop_path_rate, plain=True)
        self.norm = layer_norm(cfg.trans_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.trans_dim))
        self.cls_pos = nn.Parameter(torch.zeros(1, 1, cfg.trans_dim))
        nn.init.trunc_normal_(self.cls_token, std=0.02)
        nn.init.trunc_normal_(self.cls_pos, std=0.02)
        self.cls_head_finetune = ClsHead(2 * cfg.trans_dim, cfg.cls_dim)

    def forward(self, pts: torch.Tensor, **_ignored) -> torch.Tensor:
        """Logits [B, cls_dim] of clouds ``pts`` [B, N, 3]. The classifier
        runners' prompt keywords (``completion_prompt``, ``denoise``,
        ``point_num``) are accepted and ignored, as in the JAX model."""
        g = group_points(pts, self.num_group, self.group_size)
        tokens = self.encoder(g.neighborhood)
        B = tokens.shape[0]
        x = torch.cat([self.cls_token.expand(B, -1, -1), tokens], dim=1)
        pos = torch.cat([self.cls_pos.expand(B, -1, -1), self.pos_embed(g.center)], dim=1)
        x = self.norm(self.blocks(x, pos, path="none"))
        return self.cls_head_finetune(torch.cat([x[:, 0], x[:, 1:].amax(1)], dim=-1))
