"""Projected-ShapeNet partial/complete pairs (reference
``datasets/ProjectedShapeNetDataset.py:15-82``): per-model npy pairs; returns
(partial, gt) for completion or (partial, label) for classification."""

from __future__ import annotations

import os
import random

import numpy as np

from ..utils.logger import print_log
from .build import DATASETS
from .io import IO


@DATASETS.register_module("Projected_ShapeNet")
class ProjectedShapeNetDataset:
    def __init__(self, config):
        self.data_root = config.DATA_PATH
        self.partial_points_path = config.PARTIAL_POINTS_PATH
        self.complete_points_root = config.COMPLETE_POINTS_ROOT
        self.npoints = config.N_POINTS
        self.subset = config.subset
        self.cars = bool(config.get("CARS", False))
        self.task = config.get("TASK", "classification")
        self.n_renderings = config.get("N_RENDERINGS", 1) if self.subset == "train" else 1
        list_file = os.path.join(self.data_root, f"{self.subset}.txt")
        with open(list_file, "r") as f:
            lines = [l.strip() for l in f.readlines()]

        self.file_list = []
        for line in lines:
            taxonomy_id = line.split("-")[0].split("/")[-1]
            model_id = line.split("-")[1].split(".")[0]
            if not os.path.exists(self.partial_points_path % (taxonomy_id, model_id, 0)):
                continue
            if self.cars and taxonomy_id != "02958343":
                continue
            self.file_list.append({"taxonomy_id": taxonomy_id,
                                   "model_id": model_id, "file_path": line})
        print_log(f"[Projected_ShapeNet] {len(self.file_list)} instances loaded",
                  logger="Projected_ShapeNet")
        label_set = sorted({it["taxonomy_id"] for it in self.file_list})
        self.label_map = {t: i for i, t in enumerate(label_set)}

    def __len__(self):
        return len(self.file_list)

    def __getitem__(self, idx):
        sample = self.file_list[idx]
        rand_idx = (random.randint(0, self.n_renderings - 1)
                    if self.subset == "train" else 0)
        gt = IO.get(os.path.join(self.complete_points_root,
                                 sample["file_path"])).astype(np.float32)
        partial = IO.get(self.partial_points_path %
                         (sample["taxonomy_id"], sample["model_id"],
                          rand_idx)).astype(np.float32)
        if self.task == "completion":
            return sample["taxonomy_id"], sample["model_id"], (partial, gt)
        return (sample["taxonomy_id"], sample["model_id"],
                (partial, self.label_map[sample["taxonomy_id"]]))
