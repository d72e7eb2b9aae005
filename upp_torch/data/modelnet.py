"""ModelNet40 dataset (reference ``datasets/ModelNetDataset.py:52-149``):
txt clouds FPS-downsampled once to N_POINTS and cached as a pickled .dat file
(the cache format is byte-compatible with the reference so an existing
modelnet40_*_8192pts_fps.dat drops in)."""

from __future__ import annotations

import os
import pickle

import numpy as np

from ..utils.logger import print_log
from .build import DATASETS
from .io import pc_normalize


def farthest_point_sample_np(point: np.ndarray, npoint: int) -> np.ndarray:
    """Host FPS used only for one-time cache building
    (``ModelNetDataset.py:29-49``; random start like the reference). Runs the
    native C++ sampler (upp_torch.native) when built, numpy otherwise."""
    from ..native import fps_host
    start = int(np.random.randint(0, point.shape[0]))
    idx = fps_host(point[:, :3], npoint, start=start)
    return point[idx]


@DATASETS.register_module("ModelNet")
class ModelNet:
    def __init__(self, config):
        self.root = config.DATA_PATH
        self.npoints = config.N_POINTS
        self.use_normals = bool(config.get("USE_NORMALS", False))
        self.num_category = config.NUM_CATEGORY
        self.subset = config.subset
        assert self.subset in ("train", "test")

        stem = f"modelnet{self.num_category}"
        catfile = os.path.join(self.root, f"{stem}_shape_names.txt")
        self.cat = [line.rstrip() for line in open(catfile)]
        self.classes = dict(zip(self.cat, range(len(self.cat))))

        ids = [line.rstrip() for line in
               open(os.path.join(self.root, f"{stem}_{self.subset}.txt"))]
        names = ["_".join(x.split("_")[0:-1]) for x in ids]
        self.datapath = [(names[i], os.path.join(self.root, names[i], ids[i]) + ".txt")
                         for i in range(len(ids))]

        self.save_path = os.path.join(
            self.root, f"{stem}_{self.subset}_{self.npoints}pts_fps.dat")
        if os.path.exists(self.save_path):
            print_log(f"Load processed data from {self.save_path}...", logger="ModelNet")
            with open(self.save_path, "rb") as f:
                self.list_of_points, self.list_of_labels = pickle.load(f)
        else:
            print_log(f"Processing data to {self.save_path} (first run only)...",
                      logger="ModelNet")
            self.list_of_points, self.list_of_labels = [], []
            for name, path in self.datapath:
                cls = np.array([self.classes[name]], np.int32)
                pts = np.loadtxt(path, delimiter=",").astype(np.float32)
                pts = farthest_point_sample_np(pts, self.npoints)
                self.list_of_points.append(pts)
                self.list_of_labels.append(cls)
            with open(self.save_path, "wb") as f:
                pickle.dump([self.list_of_points, self.list_of_labels], f)

    def __len__(self):
        return len(self.datapath)

    def __getitem__(self, index):
        point_set = np.array(self.list_of_points[index], np.float32)
        label = int(np.asarray(self.list_of_labels[index]).reshape(-1)[0])
        point_set[:, 0:3] = pc_normalize(point_set[:, 0:3])
        if not self.use_normals:
            point_set = point_set[:, 0:3]
        if self.subset == "train":
            perm = np.random.permutation(point_set.shape[0])
            point_set = point_set[perm]
        return "ModelNet", "sample", (point_set.copy(), label)
