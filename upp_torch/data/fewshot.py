"""ModelNet few-shot dataset (reference
``datasets/ModelNetDatasetFewShot.py:28-71``): pickled way/shot/fold splits."""

from __future__ import annotations

import os
import pickle

import numpy as np

from .build import DATASETS
from .io import pc_normalize


@DATASETS.register_module("ModelNetFewShot")
class ModelNetFewShot:
    def __init__(self, config):
        self.root = config.DATA_PATH
        self.npoints = config.N_POINTS
        self.subset = config.subset
        self.way = config.get("way", 5)
        self.shot = config.get("shot", 10)
        self.fold = config.get("fold", 0)
        path = os.path.join(self.root, f"{self.way}way_{self.shot}shot",
                            f"{self.fold}.pkl")
        with open(path, "rb") as f:
            self.dataset = pickle.load(f)[self.subset]

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, index):
        points, label, _ = self.dataset[index]
        points = np.array(points[:, :3], np.float32)
        points[:, 0:3] = pc_normalize(points[:, 0:3])
        if self.subset == "train":
            points = points[np.random.permutation(points.shape[0])]
        return "ModelNetFewShot", "sample", (points.copy(), int(label))
