from .build import DATASETS, build_dataset_from_cfg
from . import synthetic  # noqa: F401  (registers Synthetic)
from .loader import BatchLoader
