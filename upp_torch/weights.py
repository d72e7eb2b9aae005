"""Move the JAX package's model variables into the port's ``state_dict``.

The JAX package keeps every transformer block's tensors stacked ([L, ...])
and Dense kernels as [in, out]; the port keeps one module per block under
the reference ``.pth`` names, with torch weights [out, in] (reshaped to the
reference's Conv shapes where it has them). This is the port's own
numpy-only mapping (the one ``upp_tpu/train/torch_export.py`` derives from
its import shim):

  blocks.blocks.{i}.<mod>.<leaf>       → core/blocks/<mod_with_underscores>_<leaf>[i]
  MAE_decoder.blocks.{i}.<mod>.<leaf>  → core/MAE_decoder/blocks/...[i]
  blocks.blocks.{i}.{path}_prompts     → core/blocks/{path}_prompts[i]
  encoder.first_conv.{0,1,3}           → core/encoder/{first_conv0,first_bn,first_conv1}
  <head>.{0,2} (two-layer heads)       → core/<head>/{lin0,lin1}
  cls_head_finetune.{0,1,4,5,8}        → cls_head_finetune/{lin0,bn0,lin1,bn1,lin2}
  label_conv.{0,1,3,4}                 → label_conv/{conv0,bn0,conv1,bn1}
  propagation_0.mlp_{convs,bns}.{i}    → propagation_0/{conv,bn}{i}
  seg_head.{0,1,4,5,7}                 → seg_head/{conv0,bn0,conv1,bn1,conv2}
  ...

``core/`` is left out for a model whose JAX tree has none
(``PointTransformer_seg``, ``Point_MAE``, ``PointTransformer``), and
``Point_MAE``'s ``MAE_encoder.`` prefix has no JAX counterpart
(``MAE_encoder.blocks.blocks.{i}`` → ``blocks/...[i]``, as the reference's
checkpoint loader strips it); its ``increase_dim.0`` is
``increase_dim_conv``.

The completion models (``PoinTr``, ``AdaPoinTr``) take the JAX tree's
names (``base_model.encoder0.attn.qkv`` → ``base_model/encoder0/attn/qkv``):
no rename applies to them.

Leaves: a Linear/Conv ``weight`` is the transposed ``kernel``, a norm's
(LayerNorm, GroupNorm, BatchNorm) ``weight`` its ``scale``, ``running_mean``/``running_var`` the batch_stats
``mean``/``var``; ``num_batches_tracked`` has no JAX counterpart and is 0.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

_RENAMES = [
    (r"^encoder\.(first|second)_conv\.0$", r"encoder/\1_conv0"),
    (r"^encoder\.(first|second)_conv\.1$", r"encoder/\1_bn"),
    (r"^encoder\.(first|second)_conv\.3$", r"encoder/\1_conv1"),
    (r"^(pos_embed|decoder_pos_embed|shape_pred|coarse_pred|predict_token_generator)\.0$",
     r"\1/lin0"),
    (r"^(pos_embed|decoder_pos_embed|shape_pred|coarse_pred|predict_token_generator)\.2$",
     r"\1/lin1"),
    (r"^dense_pred\.0$", "dense_pred_conv"),
    (r"^increase_dim\.0$", "increase_dim_conv"),
    (r"^rectify_prompter\.(\w+)\.mlp_convs\.(\d+)$", r"rectify_prompter/\1/conv\2"),
    (r"^rectify_prompter\.(\w+)\.mlp_bns\.(\d+)$", r"rectify_prompter/\1/bn\2"),
    (r"^rectify_prompter\.score_head\.0$", "rectify_prompter/score0"),
    (r"^rectify_prompter\.score_head\.3$", "rectify_prompter/score1"),
    (r"^cls_head_finetune\.0$", "cls_head_finetune/lin0"),
    (r"^cls_head_finetune\.1$", "cls_head_finetune/bn0"),
    (r"^cls_head_finetune\.4$", "cls_head_finetune/lin1"),
    (r"^cls_head_finetune\.5$", "cls_head_finetune/bn1"),
    (r"^cls_head_finetune\.8$", "cls_head_finetune/lin2"),
    (r"^label_conv\.0$", "label_conv/conv0"),
    (r"^label_conv\.1$", "label_conv/bn0"),
    (r"^label_conv\.3$", "label_conv/conv1"),
    (r"^label_conv\.4$", "label_conv/bn1"),
    (r"^propagation_0\.mlp_convs\.(\d+)$", r"propagation_0/conv\1"),
    (r"^propagation_0\.mlp_bns\.(\d+)$", r"propagation_0/bn\1"),
    (r"^seg_head\.0$", "seg_head/conv0"),
    (r"^seg_head\.1$", "seg_head/bn0"),
    (r"^seg_head\.4$", "seg_head/conv1"),
    (r"^seg_head\.5$", "seg_head/bn1"),
    (r"^seg_head\.7$", "seg_head/conv2"),
]
# outside core/ (the unify models' shared submodules live under it; the
# PointTransformer_seg tree has no core/ at all)
_TOP_LEVEL = ("cls_token", "cls_pos", "cls_head_finetune", "label_conv",
              "propagation_0", "seg_head")
_BLOCK = re.compile(r"^(blocks\.blocks|MAE_decoder\.blocks)\.(\d+)\.(.+)$")
_STACKS = {"blocks.blocks": "blocks", "MAE_decoder.blocks": "MAE_decoder/blocks"}
_NORMS = (nn.LayerNorm, nn.GroupNorm, nn.modules.batchnorm._BatchNorm)


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _leaf(leaf: str, is_norm: bool) -> str:
    return {"weight": "scale" if is_norm else "kernel", "bias": "bias",
            "running_mean": "mean", "running_var": "var"}[leaf]


def state_dict_from_jax(variables: Mapping, model: nn.Module) -> Dict[str, torch.Tensor]:
    """The port ``model``'s state dict filled from JAX ``variables``
    ({"params": ..., "batch_stats": ...}, numpy or array leaves) of the same
    configuration. Raises KeyError on a tensor with no JAX counterpart."""
    params = _flatten(variables["params"])
    stats = _flatten(variables.get("batch_stats", {}) or {})
    core = "core/" if "core" in variables["params"] else ""
    norms = {name.removeprefix("MAE_encoder.") for name, m in model.named_modules()
             if isinstance(m, _NORMS)}
    out = {}
    for key, ref in model.state_dict().items():
        if key.endswith("num_batches_tracked"):
            out[key] = torch.zeros_like(ref)
            continue
        jkey = key.removeprefix("MAE_encoder.")
        mod, _, leaf = jkey.rpartition(".")
        row = None
        m = _BLOCK.match(jkey)
        if m:
            stack, row, rest = m.group(1), int(m.group(2)), m.group(3)
            base = core + _STACKS[stack]
            mod_in_block, _, leaf = rest.rpartition(".")
            if not mod_in_block:                         # {path}_prompts
                path, coll = f"{base}/{leaf}", params
            else:
                name = f"{mod_in_block.replace('.', '_')}_{_leaf(leaf, mod in norms)}"
                path = f"{base}/{name}"
                coll = stats if leaf.startswith("running_") else params
        elif not mod:                                    # bare parameters
            path = leaf if leaf in _TOP_LEVEL else f"{core}{leaf}"
            coll = params
        else:
            fpath = mod
            for pat, repl in _RENAMES:
                fpath, n = re.subn(pat, repl, fpath)
                if n:
                    break
            fpath = fpath.replace(".", "/")
            if fpath.split("/")[0] not in _TOP_LEVEL:
                fpath = f"{core}{fpath}"
            path = f"{fpath}/{_leaf(leaf, mod in norms)}"
            coll = stats if leaf.startswith("running_") else params
        if path not in coll:
            raise KeyError(f"{key}: no JAX variable {path!r}")
        val = coll[path] if row is None else coll[path][row]
        if leaf == "weight" and mod not in norms and val.ndim == 2:
            val = val.T                                  # [in, out] → [out, in]
        out[key] = torch.tensor(np.asarray(val), dtype=ref.dtype).reshape(ref.shape)
    return out
