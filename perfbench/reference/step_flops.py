"""Model FLOPs of the reference's segmentation PEFT step, counted from its
shapes as ``flops.py`` counts the others (a multiply-add counts 2;
``grad`` 0, 1 or 2 as there). A CPU test holds the count to
``torch.utils.flop_counter.FlopCounterMode`` over the reference's step.

The seg head is counted as the reference computes it: its first conv over
the per-point features with the per-cloud row repeated and concatenated to
them, as upstream writes it (the port splits that product and computes the
per-cloud part once a cloud)."""

from __future__ import annotations

from typing import Dict

from . import seg
from .flops import _Shapes, _block, _complete, _encoder, _lin, _rectify, _two


def segment(m: Dict, batch: int, points: int, num_crop: int) -> int:
    """The seg PEFT step at ``batch`` clouds of ``points``: the rectify pass
    over the crop with its shell and lidar points, the completion pass,
    the downstream pass (prompts, adapters and the head trainable, so the
    backward reaches every block) and the head at all ``points``."""
    front = _Shapes(seg.front_cfg(m))
    s = _Shapes(m)
    B, C, G = batch, s.C, s.G
    rows = B * points
    f = _rectify(B, points - num_crop + seg.SHELL_NUM + seg.LIDAR_NUM, front) + _complete(B, front)
    f += _encoder(B, G, s.S, C) + _two(B * G, 3, 128, C)
    for i in range(s.depth):
        T = G + (s.pc["downstream_prompts_num"] if i < s.pc["downstream_prompts_depth"] else 0)
        f += _block(B, T, C, s.heads, G, grad=1, adapter_grad=2)
    taps = sum(i < s.depth for i in seg.TAPS) * C
    f += _lin(B, seg.LABEL_CLASSES, 64, 1) + _lin(B, 64, seg.LABEL_DIM, 2)
    f += _lin(rows, 3 + taps, seg.PROP_MLP[0], 2) + _lin(rows, *seg.PROP_MLP, 2)
    f += _lin(rows, seg.PROP_MLP[-1] + 2 * taps + seg.LABEL_DIM, seg.HEAD[0], 2)
    return f + _lin(rows, *seg.HEAD, 2) + _lin(rows, seg.HEAD[1], s.cls_dim, 2)

