"""ShapeNet55 dataset (reference ``datasets/ShapeNet55Dataset.py:9-66``):
one .npy per model listed in {train,test}.txt; labels from the sorted
taxonomy-id set."""

from __future__ import annotations

import os

import numpy as np

from ..utils.logger import print_log
from .build import DATASETS
from .io import IO, pc_normalize


@DATASETS.register_module("ShapeNet")
class ShapeNet55:
    def __init__(self, config):
        self.data_root = config.DATA_PATH
        self.pc_path = config.PC_PATH
        self.subset = config.subset
        self.npoints = config.N_POINTS
        list_file = os.path.join(self.data_root, f"{self.subset}.txt")
        with open(list_file, "r") as f:
            lines = [l.strip() for l in f.readlines()]

        self.file_list = []
        missing = 0
        for line in lines:
            taxonomy_id = line.split("-")[0]
            model_id = line.split("-")[1].split(".")[0]
            if os.path.exists(os.path.join(self.pc_path, line)):
                self.file_list.append(
                    {"taxonomy_id": taxonomy_id, "model_id": model_id,
                     "file_path": line})
            else:
                missing += 1
        print_log(f"[ShapeNet-55] {len(self.file_list)} instances loaded, "
                  f"{missing} missing", logger="ShapeNet-55")
        label_set = sorted({item["taxonomy_id"] for item in self.file_list})
        self.label_map = {t: i for i, t in enumerate(label_set)}

    def __len__(self):
        return len(self.file_list)

    def __getitem__(self, idx):
        sample = self.file_list[idx]
        data = IO.get(os.path.join(self.pc_path, sample["file_path"])).astype(np.float32)
        data = pc_normalize(data)
        return (sample["taxonomy_id"], sample["model_id"],
                (data, self.label_map[sample["taxonomy_id"]]))

    def get_batch(self, indices):
        """Collated (pts [b, N_POINTS, 3], labels [b]) via the native C++
        parallel .npy reader (native/upp_native.cpp:upp_read_npy_batch) —
        one threaded read per batch instead of b sequential ``IO.get`` calls.
        BatchLoader prefers this over per-item assembly when present."""
        samples = [self.file_list[int(i)] for i in indices]
        paths = [os.path.join(self.pc_path, s["file_path"]) for s in samples]
        if not all(p.endswith(".npy") for p in paths):
            return None   # loader falls back to per-item __getitem__
        from ..native import read_npy_batch
        pts = read_npy_batch(paths, self.npoints)
        # vectorised pc_normalize (identical per-cloud math)
        pts = pts - pts.mean(axis=1, keepdims=True)
        scale = np.sqrt((pts ** 2).sum(-1)).max(axis=1)[:, None, None]
        pts = pts / scale
        labels = np.asarray([self.label_map[s["taxonomy_id"]] for s in samples],
                            np.int32)
        return pts.astype(np.float32), labels
