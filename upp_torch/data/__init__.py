from .build import DATASETS, build_dataset_from_cfg
from . import modelnet  # noqa: F401
from . import shapenet55  # noqa: F401
from . import scanobjectnn  # noqa: F401
from . import partnormal  # noqa: F401
from . import fewshot  # noqa: F401
from . import synthetic  # noqa: F401  (Synthetic, SyntheticPart)
from . import projected_shapenet  # noqa: F401
from . import realsensor  # noqa: F401
from .loader import BatchLoader
