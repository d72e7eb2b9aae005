"""Dataset registry (reference ``datasets/build.py:4-16``): datasets are
constructed from a ``_base_`` descriptor (``cfgs/dataset_configs/*.yaml``)
merged with per-split ``others`` (subset, bs, ...)."""

from ..utils.config import ConfigDict, to_config
from ..utils.registry import Registry

DATASETS = Registry("datasets")


def build_dataset_from_cfg(base_cfg, others=None):
    cfg = to_config(base_cfg)
    merged = ConfigDict(cfg)
    if others:
        for k, v in to_config(others).items():
            merged[k] = v
    return DATASETS.build(merged)
