"""ShapeNetPart segmentation dataset (reference
``datasets/PartNormalDataset.py:21-123``): per-point part labels in txt files,
JSON train/val/test splits, items resampled to N_POINTS with replacement.
Item shape is (point_set, cls, seg) — unlike the classification datasets."""

from __future__ import annotations

import json
import os

import numpy as np

from .build import DATASETS
from .io import pc_normalize

SEG_CLASSES = {
    "Earphone": [16, 17, 18], "Motorbike": [30, 31, 32, 33, 34, 35],
    "Rocket": [41, 42, 43], "Car": [8, 9, 10, 11], "Laptop": [28, 29],
    "Cap": [6, 7], "Skateboard": [44, 45, 46], "Mug": [36, 37],
    "Guitar": [19, 20, 21], "Bag": [4, 5], "Lamp": [24, 25, 26, 27],
    "Table": [47, 48, 49], "Airplane": [0, 1, 2, 3], "Pistol": [38, 39, 40],
    "Chair": [12, 13, 14, 15], "Knife": [22, 23],
}


@DATASETS.register_module("PartNormalDataset")
class PartNormalDataset:
    seg_classes = SEG_CLASSES

    def __init__(self, config, class_choice=None, normal_channel=False):
        self.npoints = config.N_POINTS
        self.root = config.DATA_PATH
        self.split = config.subset
        self.normal_channel = normal_channel

        catfile = os.path.join(self.root, "synsetoffset2category.txt")
        self.cat = {}
        with open(catfile, "r") as f:
            for line in f:
                ls = line.strip().split()
                self.cat[ls[0]] = ls[1]
        self.classes_original = dict(zip(self.cat, range(len(self.cat))))
        if class_choice is not None:
            self.cat = {k: v for k, v in self.cat.items() if k in class_choice}

        def _ids(name):
            with open(os.path.join(self.root, "train_test_split",
                                   f"shuffled_{name}_file_list.json")) as f:
                return {str(d.split("/")[2]) for d in json.load(f)}

        train_ids, val_ids, test_ids = _ids("train"), _ids("val"), _ids("test")
        want = {"trainval": train_ids | val_ids, "train": train_ids,
                "val": val_ids, "test": test_ids}[self.split]

        self.datapath = []
        for item in self.cat:
            dir_point = os.path.join(self.root, self.cat[item])
            for fn in sorted(os.listdir(dir_point)):
                if fn[0:-4] in want:
                    self.datapath.append((item, os.path.join(dir_point, fn)))

        self.classes = {k: self.classes_original[k] for k in self.cat}
        self._cache = {}
        self._cache_size = 20000

    def __len__(self):
        return len(self.datapath)

    def __getitem__(self, index):
        if index in self._cache:
            point_set, cls, seg = self._cache[index]
        else:
            cat, path = self.datapath[index]
            cls = np.array([self.classes[cat]], np.int32)
            data = np.loadtxt(path).astype(np.float32)
            point_set = data[:, 0:6] if self.normal_channel else data[:, 0:3]
            seg = data[:, -1].astype(np.int32)
            if len(self._cache) < self._cache_size:
                self._cache[index] = (point_set, cls, seg)
        point_set = np.array(point_set, np.float32)
        point_set[:, 0:3] = pc_normalize(point_set[:, 0:3])
        choice = np.random.choice(len(seg), self.npoints, replace=True)
        return point_set[choice], cls, seg[choice]
