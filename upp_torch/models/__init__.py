from .build import MODELS, build_model_from_cfg
from . import unify  # noqa: F401  (registers Point_MAE_unify, Point_MAE_pretask_dev)
