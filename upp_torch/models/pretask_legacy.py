"""The legacy prompter-pretraining model ``Point_MAE_pretask`` (counterpart
of ``upp_tpu/models/pretask_legacy.py``; reference
``models/Point_MAE_pretask.py:444-698``, the predecessor of
``Point_MAE_pretask_dev``).

What differs from the dev model (``unify.py``):

* tokens come from grouping the whole cloud; FPS then picks ``vis_num`` of
  the group centres, and the tokens of all groups are propagated onto the
  picked ones (``propagate``, k = 8), in place of re-grouping the visible
  points;
* the rectification head is named ``mask_prompter`` (the same
  architecture as ``rectify_prompter``, which this model does not have);
* the noise loss adds a binary-overlap term, ``0.6 * positive + negative +
  0.02 * bce`` with ``bce = 100 * 2 * n_drop * (1 - recall) / P``: the
  value of the reference's ``nn.BCELoss()`` between two one-hot vectors
  (torch clamps the log at -100), as the JAX package computes it;
* after the hard drop the kept points are tokenised again, then the
  completion branch of the dev model runs on the propagated tokens.

Its shared core is built in float32 whatever ``if_half`` says, as in the
JAX package.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from ..ops.fps import fps
from ..ops.group import group_points
from ..ops.knn import knn_points
from ..ops.propagate import propagate
from ..utils.config import to_config
from .build import MODELS
from .prompter import RectifyPrompter
from .unify import _UnifyCore


@MODELS.register_module("Point_MAE_pretask")
class PointMAEPretaskLegacy(_UnifyCore):
    """``forward(pts, point_num=1024, train_with_gaussian=True)``: in
    ``.train()`` with noise, (predict_center, rebuild, noise_loss, recall),
    the four-tuple of the pretask runner; otherwise (predict_center,
    rebuild)."""

    def __init__(self, config: Any):
        cfg = to_config(config)
        super().__init__(cfg)
        del self.rectify_prompter
        self.mask_prompter = RectifyPrompter(hidden_dimension=self.trans_dim)

    def _tokenize(self, pts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Group the whole cloud, FPS the centres to ``vis_num``, propagate
        every group's token onto the picked ones
        (``Point_MAE_pretask.py:617-623``)."""
        g = group_points(pts, self.num_group, self.group_size)
        tokens = self.encoder(g.neighborhood)
        vis_center, vis_idx = fps(g.center, self.vis_num)
        vis_tokens = torch.gather(tokens, 1, vis_idx[..., None].expand(-1, -1, tokens.shape[-1]))
        return vis_center, propagate(vis_center, g.center, vis_tokens, tokens, de_neighbors=8)

    def forward(self, pts: torch.Tensor, *, point_num: int = 1024,
                train_with_gaussian: bool = True):
        B, P, _ = pts.shape
        vis_center, vis_tokens = self._tokenize(pts)
        aux = None
        if train_with_gaussian and self.training:
            h = self.blocks(vis_tokens, self.pos_embed(vis_center), path="rectify")
            pred_vector = self.mask_prompter(pts, vis_center, h)
            noise, partial = pts[:, point_num:], pts[:, :point_num]
            _, _, clean_nn = knn_points(noise, partial, 4)
            noise_vector = (clean_nn - noise[:, :, None, :]).mean(-2)
            positive = ((pred_vector[:, point_num:] - noise_vector) ** 2).sum(-1).mean()
            negative = (pred_vector[:, :point_num] ** 2).sum(-1).mean()

            score = torch.linalg.norm(pred_vector, dim=-1)
            order = torch.argsort(-score, dim=1, stable=True)          # descending
            n_drop = P - point_num
            recall = ((order[:, :n_drop] >= point_num).float().sum(-1) / n_drop).mean()
            bce = 100.0 * 2.0 * n_drop * (1.0 - recall) / P
            noise_loss = 0.6 * positive + negative + 0.02 * bce

            keep_idx = order[:, n_drop:]
            pts = torch.gather(pts, 1, keep_idx[..., None].expand(-1, -1, 3)).detach()
            vis_center, vis_tokens = self._tokenize(pts)
            aux = (noise_loss, recall)

        # the completion branch of the dev model, on the propagated tokens
        predict_center, rebuild = self.complete_tokens(vis_tokens, vis_center)
        if aux is not None:
            return predict_center, rebuild, aux[0], aux[1]
        return predict_center, rebuild
