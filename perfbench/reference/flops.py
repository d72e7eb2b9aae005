"""Model FLOPs of the reference model's steps, counted from their shapes:
matmul-class FLOPs, a multiply-add counting 2, forward plus the backward
autograd needs. ``grad`` of a product: 0 = forward only, 1 = the input's
gradient (a frozen weight), 2 = the input's and the weight's gradient, or
both operands of an activation product. A CPU test holds each count to
``torch.utils.flop_counter.FlopCounterMode`` over the reference's step."""

from __future__ import annotations

from typing import Dict

from .model import ADAPTER_WIDTH, HEAD_GROUP, HEAD_GROUPS, PASS_GROUP


def _lin(rows: int, i: int, o: int, grad: int = 0) -> int:
    return 2 * rows * i * o * (1 + grad)


def _two(rows, i, h, o, grad=0) -> int:
    return _lin(rows, i, h, grad) + _lin(rows, h, o, grad)


def _block(B, T, C, heads, adapter_T, grad=0, adapter_grad=0) -> int:
    """One transformer block over T tokens, an adapter over ``adapter_T``
    (0: none). ``grad``: the backward reaches the block (frozen weights:
    input gradients, activation products both operands)."""
    hd = C // heads
    lin = _lin(B * T, C, 3 * C) + _lin(B * T, C, C) + 2 * _lin(B * T, C, 4 * C)
    attn = 2 * (2 * B * heads * T * T * hd)
    total = lin * (1 + (1 if grad else 0)) + attn * (1 + (2 if grad else 0))
    if adapter_T:
        total += (_lin(B * adapter_T, C, ADAPTER_WIDTH, adapter_grad)
                  + _lin(B * adapter_T, ADAPTER_WIDTH, C, adapter_grad))
    return total


def _encoder(B, G, n, C) -> int:
    r = B * G * n
    return _lin(r, 3, 128) + _lin(r, 128, 256) + _lin(r, 512, 512) + _lin(r, 512, C)


class _Shapes:
    def __init__(self, m: Dict):
        tc = m["transformer_config"]
        self.pc = m["prompter_config"]
        self.C, self.G, self.S = tc["trans_dim"], m["num_group"], m["group_size"]
        self.heads, self.dec_heads = tc["num_heads"], tc["decoder_num_heads"]
        self.vis = self.G - int(tc["mask_ratio"] * self.G)
        self.n_mask = self.G - self.vis
        self.dec, self.depth = tc["decoder_depth"], tc["depth"]
        self.cls_dim = m.get("cls_dim")


def _rectify(B, P, s: _Shapes) -> int:
    """Rectify pass over P points, forward: tokens, blocks, the rectify
    head."""
    C, vis, pc = s.C, s.vis, s.pc
    f = _encoder(B, vis, PASS_GROUP, C) + _two(B * vis, 3, 128, C)
    np_ = pc["rectify_prompts_num"]
    for _ in range(pc["rectify_depth"]):
        f += _block(B, vis + np_, C, s.heads, vis)
    r = B * HEAD_GROUPS * HEAD_GROUP
    f += _lin(r, C, 64) + _lin(r, 64, 32) + _lin(r, 32, 12)
    f += _lin(B * vis, 12, 64) + _lin(B * vis, 64, 32)
    f += _lin(B * P, 59, 32) + _lin(B * P, 32, 32)
    f += _lin(B * P, 32, 64) + _lin(B * P, 64, 3)
    return f


def _complete(B, s: _Shapes) -> int:
    """Completion pass, forward: tokens, blocks, heads, decoder, dense
    rebuild."""
    C, vis, n_mask, pc = s.C, s.vis, s.n_mask, s.pc
    f = _encoder(B, vis, PASS_GROUP, C) + _two(B * vis, 3, 128, C)
    np_ = pc["pretask_prompts_num"]
    for _ in range(pc["pretask_depth"]):
        f += _block(B, vis + np_, C, s.heads, vis)
    f += _two(B * vis, C, C // 2, 16) + _two(B, 16 * vis, C, 3 * n_mask)
    f += _two(B * vis, C, 128, C)
    f += _two(B * vis, 3, 128, C) + _two(B * n_mask, 3, 128, C)
    for _ in range(s.dec):
        f += _block(B, vis + n_mask, C, s.dec_heads, vis + n_mask)
    return f + _lin(B * n_mask, C, 3 * s.S)


def _downstream(B, s: _Shapes, grad=0) -> int:
    """Downstream pass and head: tokens, the blocks, prompts in the first
    ones, the classification head."""
    C, G, pc = s.C, s.G, s.pc
    g2 = grad and 2
    f = _encoder(B, G, s.S, C) + _two(B * G, 3, 128, C)
    np_ = pc["downstream_prompts_num"]
    for i in range(s.depth):
        T = 1 + G + (np_ if i < pc["downstream_prompts_depth"] else 0)
        f += _block(B, T, C, s.heads, 1 + G, grad=grad, adapter_grad=g2)
    return f + _lin(B, 2 * C, 256, g2) + _lin(B, 256, 256, g2) + _lin(B, 256, s.cls_dim, g2)


def classify(m: Dict, batch: int, points: int, train: bool) -> int:
    """The robust classifier's step at ``batch`` clouds, the rectify pass
    over ``points``; ``train``: the PEFT backward (the downstream pass's
    adapters, prompts and head trainable, the prompters frozen)."""
    s = _Shapes(m)
    return (_rectify(batch, points, s) + _complete(batch, s)
            + _downstream(batch, s, 1 if train else 0))


def complete(m: Dict, batch: int) -> int:
    """The completion pass alone, forward."""
    return _complete(batch, _Shapes(m))
