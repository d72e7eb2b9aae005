from .build import MODELS, build_model_from_cfg
from . import unify  # noqa: F401  (registers Point_MAE_unify, Point_MAE_pretask_dev)
from . import unify_seg  # noqa: F401  (registers Point_MAE_unify_seg, PointTransformer_seg)
from . import baseline  # noqa: F401  (registers Point_MAE, PointTransformer)
from . import pretask_legacy  # noqa: F401  (registers Point_MAE_pretask)
from . import pointr  # noqa: F401  (registers PoinTr)
from . import adapointr  # noqa: F401  (registers AdaPoinTr)
