"""Prompted transformer block stacks (counterpart of
``upp_tpu/models/scan_blocks.py``).

The JAX package stacks every per-block tensor and runs each pass as a
``lax.scan`` over a slice of the stack; here the stack is an
``nn.ModuleList`` of blocks and a pass is a loop over a slice of it:

  rectify    → blocks[0:rectify_depth]   (prompts + adapters)
  pretask    → blocks[0:pretask_depth]   (prompts + adapters)
  downstream → blocks[0:prompt depth]    (prompts + adapters [+ propagation])
             → blocks[prompt depth:L]    (adapters)
  none       → blocks[0:L]               (plain)
  decoder    → its own blocks            (pretask adapters, or plain)

The segmentation models also take the outputs of blocks {3, 7, 11} as
feature taps (``feature_blocks``).

All passes share the one backbone. Block ``i`` carries ``{path}_adapter``
for i below the path's adapter length and ``{path}_prompts`` [num, C] for i
below its prompt depth: the reference's per-block ``.pth`` keys. A plain
stack (``plain=True``: ``Point_MAE``, ``PointTransformer`` and the
``Point_MAE`` decoder) has blocks without prompts, adapters or ``bnorm``,
as the reference's plain blocks (``upp_tpu/models/scan_blocks.py:112-116``).
In ``.train()`` block ``i`` of a stack of depth L drops its residual
branches per sample at rate ``drop_path_rate * i / (L - 1)``
(``upp_tpu/models/scan_blocks.py:222-224``), drawn from the ``generator``
a pass is given, else from torch's RNG.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from ..ops.geometry import index_points
from ..ops.propagate import inverse_distance_interp
from ..parallel import shard
from ..parallel.dist import all_gather_rows
from .blocks import PrompterConfig
from .layers import (BN_EPS, Adapter, Attention, Mlp, batch_norm_last, drop_path,
                     layer_norm)

PATHS = ("rectify", "pretask", "downstream")


class PromptedBlock(nn.Module):
    """One pre-norm transformer block with per-path prompts, adapters and the
    prompt-propagation pooling BatchNorm (``bnorm``); a ``plain`` block has
    none of the three."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float,
                 adapters: Sequence[str] = (), prompts: Optional[Dict[str, int]] = None,
                 drop_path_rate: float = 0.0, plain: bool = False):
        super().__init__()
        prompts = prompts or {}
        if plain and (adapters or prompts):
            raise ValueError("a plain block takes no adapters and no prompts")
        self.drop_path_rate = drop_path_rate
        self.norm1 = layer_norm(dim)
        self.attn = Attention(dim, num_heads)
        self.norm2 = layer_norm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        if not plain:
            self.bnorm = nn.BatchNorm1d(dim, eps=BN_EPS)
        for path in adapters:
            setattr(self, f"{path}_adapter", Adapter(dim))
        for path, num in prompts.items():
            prm = nn.Parameter(torch.empty(num, dim))
            nn.init.xavier_uniform_(prm)
            setattr(self, f"{path}_prompts", prm)

    def forward(self, x, pos, *, path: str, prompted: bool, use_adapter: bool,
                classification: bool, propagation: Optional[dict],
                generator: Optional[torch.Generator] = None):
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
        x = x + drop_path(self.attn(self.norm1(x)), self.drop_path_rate, self.training,
                          generator)
        x = x + drop_path(self.mlp(self.norm2(x)), self.drop_path_rate, self.training,
                          generator)
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
        """Geometry-aware prompt propagation, in one of three gather modes
        (``upp_tpu/models/scan_blocks.py:391-446``):

        * the reference's shipped cls semantics (``quirk``, the default,
          with ``gather_idx`` False): the kNN rows are gathered from the
          prompt-augmented body flattened to [B*(prompts+g), C] with offsets
          b*g, so sample b>0 reads the previous sample's rows. Released
          checkpoints were trained with exactly this. In a train step
          spread over ranks the rows are the global batch's, so a cloud
          reads the rows the one-process step would, on whichever rank;
        * ``gather_idx`` True (the reference's seg config): a per-sample
          gather, still indexed into the prompt-augmented body;
        * ``quirk`` False (``propagation_semantics: clean``): a per-sample
          gather from the g group tokens alone.

        Then ``droppath(neigh) + neigh`` (features doubled in eval), the
        ``bnorm`` over all rows, a max over the k neighbours, and the
        interpolation back onto the g tokens."""
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
        quirk = propagation.get("quirk", True)
        if quirk and not propagation.get("gather_idx", False):
            flat = body.reshape(-1, C)
            first = 0                   # this shard's first cloud in the global batch
            sh = shard.current()
            if self.training and sh.is_global:
                # the flat rows span the global batch: gather every rank's
                flat = all_gather_rows(flat)
                first = sh.rank * B
            off = ((torch.arange(B, device=x.device) + first) * g)[:, None, None]
            neigh = flat[(n_idx + off).reshape(-1)].reshape(B, g2, k, C)
            centers = flat[(c_idx + off[:, :, 0]).reshape(-1)].reshape(B, g2, C)
        else:
            src = body if quirk else tokens
            neigh = index_points(src, n_idx)                 # [B, g2, k, C]
            centers = index_points(src, c_idx)               # [B, g2, C]
        neigh = drop_path(neigh, self.drop_path_rate, self.training) + neigh
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
               classification: bool = False, propagation: Optional[dict] = None,
               feature_blocks: Sequence[int] = (),
               generator: Optional[torch.Generator] = None):
    """Run blocks[0:run_depth] as the JAX package's segments: [0,
    prompt_depth) prompted, [prompt_depth, run_depth) not. A segment uses the
    path's adapters only when they cover all of it (``adapter_len >= hi``).
    Returns x, or (x, taps) with ``feature_blocks``: the output of each
    block whose index is in it, in order."""
    segments = ([(0, prompt_depth, True), (prompt_depth, run_depth, False)]
                if prompt_depth else [(0, run_depth, False)])
    taps = []
    for lo, hi, prompted in segments:
        use_adapter = adapter_len >= hi
        for i in range(lo, hi):
            x = blocks[i](x, pos, path=path, prompted=prompted, use_adapter=use_adapter,
                          classification=classification, propagation=propagation,
                          generator=generator)
            if i in feature_blocks:
                taps.append(x)
    return (x, taps) if feature_blocks else x


class ScannedEncoderStack(nn.Module):
    """The shared prompted backbone (``blocks.blocks.{i}`` in the reference
    ``.pth``); with ``plain`` the reference's plain ViT stack, whatever the
    ``prompter``."""

    def __init__(self, embed_dim: int, depth: int, num_heads: int,
                 mlp_ratio: float = 4.0, prompter: PrompterConfig = PrompterConfig(),
                 drop_path_rate: float = 0.0, plain: bool = False):
        super().__init__()
        p = PrompterConfig() if plain else prompter
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
                          drop_path_rate=block_drop_path(drop_path_rate, i, depth),
                          plain=plain)
            for i in range(depth))

    def forward(self, x, pos, *, path: str, classification: bool = False,
                propagation: Optional[dict] = None, feature_blocks: Sequence[int] = (),
                generator: Optional[torch.Generator] = None):
        """One pass along ``path`` ("none": every block, no prompts, no
        adapters, the path of ``PointTransformer_seg`` and of a plain
        stack); with ``feature_blocks`` returns (x, taps after those
        blocks)."""
        run_depth = self.run_depth.get(path, self.depth)
        return run_blocks(self.blocks, x, pos, path=path, run_depth=run_depth,
                          prompt_depth=min(self.prompt_len.get(path, 0), run_depth),
                          adapter_len=self.adapter_len.get(path, 0),
                          classification=classification, propagation=propagation,
                          feature_blocks=feature_blocks, generator=generator)


class ScannedDecoderStack(nn.Module):
    """MAE decoder: blocks with pretask adapters (plain blocks with
    ``plain``: the ``Point_MAE`` decoder, ``Point_MAE_cp.py:205-237``),
    then LayerNorm over the last ``return_token_num`` tokens (``MAE_decoder.*``
    in the reference ``.pth``)."""

    def __init__(self, embed_dim: int, depth: int, num_heads: int,
                 mlp_ratio: float = 4.0, drop_path_rate: float = 0.0,
                 plain: bool = False):
        super().__init__()
        self.blocks = nn.ModuleList(
            PromptedBlock(embed_dim, num_heads, mlp_ratio,
                          adapters=() if plain else ("pretask",),
                          drop_path_rate=block_drop_path(drop_path_rate, i, depth),
                          plain=plain)
            for i in range(depth))
        self.adapter_len = 0 if plain else depth
        self.norm = layer_norm(embed_dim)

    def forward(self, x, pos, return_token_num: int,
                generator: Optional[torch.Generator] = None):
        x = run_blocks(self.blocks, x, pos, path="pretask", run_depth=len(self.blocks),
                       prompt_depth=0, adapter_len=self.adapter_len, generator=generator)
        return self.norm(x[:, -return_token_num:])
