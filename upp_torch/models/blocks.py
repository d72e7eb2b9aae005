"""Prompter configuration for the multi-path prompted transformer stacks
(counterpart of ``upp_tpu/models/blocks.py``)."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional


@dataclasses.dataclass(frozen=True)
class PrompterConfig:
    """Static prompt/adapter layout per path (cfg ``prompter_config`` node,
    e.g. ``cfgs/unify_modelnet_cls.yaml:48-64``).

    Per-path fields: ``{path}_adapter`` enables bottleneck adapters (in
    blocks [0, {path}_depth) for rectify/pretask, ALL blocks for
    downstream); ``{path}_prompts``/``_num``/``_depth`` define learnable
    prompt tokens prepended in blocks [0, {path}_prompts_depth);
    ``{path}_depth`` truncates how many blocks the pass runs."""
    rectify_adapter: bool = False
    rectify_prompts: bool = False
    rectify_prompts_num: int = 0
    rectify_prompts_depth: int = 0
    rectify_depth: int = 0
    pretask_adapter: bool = False
    pretask_prompts: bool = False
    pretask_prompts_num: int = 0
    pretask_prompts_depth: int = 0
    pretask_depth: int = 0
    downstream_adapter: bool = False
    downstream_prompts: bool = False
    downstream_prompts_num: int = 0
    downstream_prompts_depth: int = 0
    downstream_depth: int = 0

    @classmethod
    def from_cfg(cls, cfg: Optional[Dict[str, Any]]) -> "PrompterConfig":
        if cfg is None:
            return cls()
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in dict(cfg).items() if k in fields})
