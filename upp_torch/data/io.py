"""Point-cloud file readers (reference ``datasets/io.py``; a copy of
``upp_tpu/data/io.py``). open3d is not a dependency, so .pcd/.ply go through
a minimal ASCII parser."""

from __future__ import annotations

import os

import numpy as np


class IO:
    @classmethod
    def get(cls, file_path: str) -> np.ndarray:
        ext = os.path.splitext(file_path)[1]
        if ext == ".npy":
            return np.load(file_path)
        if ext in (".pcd", ".ply"):
            return cls._read_ascii_cloud(file_path)
        if ext == ".h5":
            import h5py
            with h5py.File(file_path, "r") as f:
                return f["data"][()]
        if ext == ".txt":
            return np.loadtxt(file_path)
        raise ValueError(f"Unsupported file extension: {ext}")

    @staticmethod
    def _read_ascii_cloud(file_path: str) -> np.ndarray:
        """Minimal ASCII .pcd/.ply xyz reader (uncompressed only)."""
        pts = []
        with open(file_path, "r", errors="ignore") as f:
            in_header = True
            for line in f:
                line = line.strip()
                if in_header:
                    if line.startswith(("DATA", "end_header")):
                        in_header = False
                    continue
                parts = line.split()
                if len(parts) >= 3:
                    try:
                        pts.append([float(parts[0]), float(parts[1]), float(parts[2])])
                    except ValueError:
                        pass
        return np.asarray(pts, np.float32)


def pc_normalize(pc: np.ndarray) -> np.ndarray:
    """Center + unit-sphere scale (``datasets/ModelNetDataset.py:20-25``)."""
    centroid = np.mean(pc, axis=0)
    pc = pc - centroid
    m = np.max(np.sqrt(np.sum(pc ** 2, axis=1)))
    return pc / m
