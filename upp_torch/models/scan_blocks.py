"""Prompted transformer block stacks (counterpart of
``upp_tpu/models/scan_blocks.py``).

The JAX package stacks every per-block tensor and runs each pass as a
``lax.scan`` over a slice of the stack; here the stack is an
``nn.ModuleList`` of blocks and a pass is a loop over a slice of it:

  rectify    → blocks[0:rectify_depth]   (prompts + adapters)
  pretask    → blocks[0:pretask_depth]   (prompts + adapters)
  downstream → blocks[0:prompt depth]    (prompts + adapters [+ propagation])
             → blocks[prompt depth:L]    (adapters)
  decoder    → its own blocks            (pretask adapters)

All passes share the one backbone. Block ``i`` carries ``{path}_adapter``
for i below the path's adapter length and ``{path}_prompts`` [num, C] for i
below its prompt depth: the reference's per-block ``.pth`` keys. In
``.train()`` block ``i`` of a stack of depth L drops its residual branches
per sample at rate ``drop_path_rate * i / (L - 1)``
(``upp_tpu/models/scan_blocks.py:222-224``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from ..ops.propagate import inverse_distance_interp
from .blocks import PrompterConfig
from .layers import (BN_EPS, Adapter, Attention, Mlp, batch_norm_last, drop_path,
                     layer_norm)

PATHS = ("rectify", "pretask", "downstream")


class PromptedBlock(nn.Module):
    """One pre-norm transformer block with per-path prompts, adapters and the
    prompt-propagation pooling BatchNorm (``bnorm``)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float,
                 adapters: Sequence[str], prompts: Dict[str, int],
                 drop_path_rate: float = 0.0):
        super().__init__()
        self.drop_path_rate = drop_path_rate
        self.norm1 = layer_norm(dim)
        self.attn = Attention(dim, num_heads)
        self.norm2 = layer_norm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.bnorm = nn.BatchNorm1d(dim, eps=BN_EPS)
        for path in adapters:
            setattr(self, f"{path}_adapter", Adapter(dim))
        for path, num in prompts.items():
            prm = nn.Parameter(torch.empty(num, dim))
            nn.init.xavier_uniform_(prm)
            setattr(self, f"{path}_prompts", prm)

    def forward(self, x, pos, *, path: str, prompted: bool, use_adapter: bool,
                classification: bool, propagation: Optional[dict]):
        x = x + pos
        num_prompts = 0
        if prompted:
            ptok = getattr(self, f"{path}_prompts")
            num_prompts = ptok.shape[0]
            ptok = ptok[None].expand(x.shape[0], -1, -1)
            if classification:
                x = torch.cat([x[:, :1], ptok, x[:, 1:]], dim=1)
            else:
                x = torch.cat([ptok, x], dim=1)
        x = x + drop_path(self.attn(self.norm1(x)), self.drop_path_rate, self.training)
        x = x + drop_path(self.mlp(self.norm2(x)), self.drop_path_rate, self.training)
        if prompted and propagation is not None:
            x = self._propagate(x, classification, propagation)
        if prompted:
            if classification:
                x = torch.cat([x[:, :1], x[:, num_prompts + 1:]], dim=1)
            else:
                x = x[:, num_prompts:]
        if use_adapter:
            x = x + getattr(self, f"{path}_adapter")(x)
        return x

    def _propagate(self, x, classification: bool, propagation: dict):
        """Geometry-aware prompt propagation, the reference's shipped cls
        semantics (``quirk`` with ``gather_idx=False``): the kNN rows are
        gathered from the prompt-augmented body flattened to
        [B*(prompts+g), C] with offsets b*g, so sample b>0 reads the previous
        sample's rows, and ``droppath(x) + x`` doubles the features at eval.
        Released checkpoints were trained with exactly this."""
        B, _, C = x.shape
        cls_x = x[:, :1] if classification else None
        body = x[:, 1:] if classification else x
        center1 = propagation["center1"]
        g = center1.shape[1]
        tokens = body[:, -g:]
        prefix = body[:, :-g]
        n_idx = propagation["center1_idx"]                  # [B, g2, k]
        c_idx = propagation["center2_idx"]                  # [B, g2]
        g2, k = n_idx.shape[1], n_idx.shape[2]
        flat = body.reshape(-1, C)
        off = (torch.arange(B, device=x.device) * g)[:, None, None]
        neigh = flat[(n_idx + off).reshape(-1)].reshape(B, g2, k, C)
        centers = flat[(c_idx + off[:, :, 0]).reshape(-1)].reshape(B, g2, C)
        neigh = neigh + neigh
        pooled = batch_norm_last(self.bnorm, neigh).amax(2)
        centers = pooled + 0.3 * centers
        tokens = tokens + 0.3 * inverse_distance_interp(
            center1, propagation["center2"], centers, k=8, eps=1e-3)
        parts = ([cls_x] if classification else []) + [prefix, tokens]
        return torch.cat(parts, dim=1)


def block_drop_path(rate: float, i: int, depth: int) -> float:
    """Drop-path rate of block ``i``: linear from 0 to ``rate`` over the
    stack."""
    return rate * i / max(depth - 1, 1)


def run_blocks(blocks: nn.ModuleList, x, pos, *, path: str, run_depth: int,
               prompt_depth: int, adapter_len: int,
               classification: bool = False, propagation: Optional[dict] = None):
    """Run blocks[0:run_depth] as the JAX package's segments: [0,
    prompt_depth) prompted, [prompt_depth, run_depth) not. A segment uses the
    path's adapters only when they cover all of it (``adapter_len >= hi``)."""
    segments = ([(0, prompt_depth, True), (prompt_depth, run_depth, False)]
                if prompt_depth else [(0, run_depth, False)])
    for lo, hi, prompted in segments:
        use_adapter = adapter_len >= hi
        for blk in blocks[lo:hi]:
            x = blk(x, pos, path=path, prompted=prompted, use_adapter=use_adapter,
                    classification=classification, propagation=propagation)
    return x


class ScannedEncoderStack(nn.Module):
    """The shared prompted backbone (``blocks.blocks.{i}`` in the reference
    ``.pth``)."""

    def __init__(self, embed_dim: int, depth: int, num_heads: int,
                 mlp_ratio: float = 4.0, prompter: PrompterConfig = PrompterConfig(),
                 drop_path_rate: float = 0.0):
        super().__init__()
        p = prompter
        self.depth = depth
        self.run_depth = {"rectify": p.rectify_depth or depth,
                          "pretask": p.pretask_depth or depth,
                          "downstream": depth}
        self.adapter_len = {
            "rectify": p.rectify_depth if p.rectify_adapter else 0,
            "pretask": p.pretask_depth if p.pretask_adapter else 0,
            "downstream": depth if p.downstream_adapter else 0}
        self.prompt_len = {
            q: (getattr(p, f"{q}_prompts_depth") if getattr(p, f"{q}_prompts") else 0)
            for q in PATHS}
        self.blocks = nn.ModuleList(
            PromptedBlock(embed_dim, num_heads, mlp_ratio,
                          adapters=[q for q in PATHS if i < self.adapter_len[q]],
                          prompts={q: getattr(p, f"{q}_prompts_num") for q in PATHS
                                   if i < self.prompt_len[q]},
                          drop_path_rate=block_drop_path(drop_path_rate, i, depth))
            for i in range(depth))

    def forward(self, x, pos, *, path: str, classification: bool = False,
                propagation: Optional[dict] = None):
        run_depth = self.run_depth[path]
        return run_blocks(self.blocks, x, pos, path=path, run_depth=run_depth,
                          prompt_depth=min(self.prompt_len[path], run_depth),
                          adapter_len=self.adapter_len[path],
                          classification=classification, propagation=propagation)


class ScannedDecoderStack(nn.Module):
    """MAE decoder: blocks with pretask adapters, then LayerNorm over the
    last ``return_token_num`` tokens (``MAE_decoder.*`` in the reference
    ``.pth``)."""

    def __init__(self, embed_dim: int, depth: int, num_heads: int,
                 mlp_ratio: float = 4.0, drop_path_rate: float = 0.0):
        super().__init__()
        self.blocks = nn.ModuleList(
            PromptedBlock(embed_dim, num_heads, mlp_ratio, adapters=("pretask",),
                          prompts={},
                          drop_path_rate=block_drop_path(drop_path_rate, i, depth))
            for i in range(depth))
        self.norm = layer_norm(embed_dim)

    def forward(self, x, pos, return_token_num: int):
        n = len(self.blocks)
        x = run_blocks(self.blocks, x, pos, path="pretask", run_depth=n,
                       prompt_depth=0, adapter_len=n)
        return self.norm(x[:, -return_token_num:])
