"""Model registry (counterpart of ``upp_tpu/models/build.py``)."""

from ..utils.registry import Registry

MODELS = Registry("models")


def build_model_from_cfg(cfg, **kwargs):
    """Construct a model from a config node with a NAME field."""
    return MODELS.build(cfg, **kwargs)
