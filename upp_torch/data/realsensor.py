"""Real-sensor scan dataset (reference ``datasets/RealSensorDataset.py:31-78``):
.pcd directory tree labelled by ModelNet40 class-name folders, ≤50 objects per
class, half-sphere normalisation, FPS to N_POINTS.

The reference runs CUDA FPS inside __getitem__(!); here the host FPS uses the
native C++ sampler. The reference repo is missing its ``RealSensor.yaml``
dataset descriptor (SURVEY.md §2.7) — ours ships one
(``cfgs/dataset_configs/RealSensor.yaml``)."""

from __future__ import annotations

import os

import numpy as np

from ..native import fps_host
from .build import DATASETS
from .io import IO


@DATASETS.register_module("RealSensorDataset")
class RealSensorDataset:
    def __init__(self, config):
        test_path = config.get("dataPath") or config.get("DATA_PATH")
        self.npoints = config.N_POINTS
        self.datapath = []
        for cate in sorted(os.listdir(test_path)):
            new_path = os.path.join(test_path, cate)
            for i, obj in enumerate(sorted(os.listdir(new_path))):
                if i >= 50:
                    break
                self.datapath.append([cate, os.path.join(new_path, obj)])
        catfile = config.get(
            "CLASS_NAMES",
            "data/ModelNet/modelnet40_normal_resampled/modelnet40_shape_names.txt")
        self.cat = [line.rstrip() for line in open(catfile)]
        self.classes = dict(zip(self.cat, range(len(self.cat))))

    def __len__(self):
        return len(self.datapath)

    @staticmethod
    def pc_norm(pc: np.ndarray) -> np.ndarray:
        m = np.max(np.sqrt(np.sum(pc ** 2, axis=1))) * 2
        return pc / m

    def __getitem__(self, index):
        cate, path = self.datapath[index]
        pts = IO.get(path).astype(np.float32)
        pts = self.pc_norm(pts)
        if pts.shape[0] >= self.npoints:
            idx = fps_host(pts, self.npoints)
            pts = pts[idx]
        else:
            pad = np.zeros((self.npoints - pts.shape[0], 3), np.float32)
            pts = np.concatenate([pts, pad], 0)
        return "RealSensor", "sample", (pts, int(self.classes[cate]))
