"""ScanObjectNN datasets (reference ``datasets/ScanObjectNNDataset.py:11-87``):
h5 archives of real scans; the 'hardest' split uses the augmented-rot-scale75
variants."""

from __future__ import annotations

import os

import numpy as np

from .build import DATASETS


class _ScanObjectBase:
    train_file = "training_objectdataset.h5"
    test_file = "test_objectdataset.h5"

    def __init__(self, config):
        import h5py
        self.subset = config.subset
        assert self.subset in ("train", "test")
        fname = self.train_file if self.subset == "train" else self.test_file
        with h5py.File(os.path.join(config.ROOT, fname), "r") as h5:
            self.points = np.array(h5["data"]).astype(np.float32)
            self.labels = np.array(h5["label"]).astype(int)

    def __len__(self):
        return self.points.shape[0]

    def __getitem__(self, idx):
        pts = self.points[idx]
        if self.subset == "train":
            pts = pts[np.random.permutation(pts.shape[0])]
        return "ScanObjectNN", "sample", (pts.copy(), int(self.labels[idx]))


@DATASETS.register_module("ScanObjectNN")
class ScanObjectNN(_ScanObjectBase):
    pass


@DATASETS.register_module("ScanObjectNN_hardest")
class ScanObjectNNHardest(_ScanObjectBase):
    train_file = "training_objectdataset_augmentedrot_scale75.h5"
    test_file = "test_objectdataset_augmentedrot_scale75.h5"
