"""Synthetic procedural point-cloud datasets (a copy of ``upp_tpu/data/synthetic.py``):
``Synthetic`` (classification) and ``SyntheticPart`` (part segmentation).

Not in the reference — added for hermetic tests, smoke training, and
benchmarking without dataset downloads (the reference's registry pattern makes
this drop-in; SURVEY.md §4d). Each class is a distinct parametric surface
(sphere, cube shell, cylinder, torus, cone, ...) with deterministic per-index
sampling, so a model can genuinely learn to separate the classes."""

from __future__ import annotations

import numpy as np

from .build import DATASETS


def _sphere(rng, n):
    v = rng.standard_normal((n, 3))
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _cube(rng, n):
    pts = rng.uniform(-1, 1, (n, 3))
    face = rng.integers(0, 3, n)
    sign = rng.choice([-1.0, 1.0], n)
    pts[np.arange(n), face] = sign
    return pts


def _cylinder(rng, n):
    theta = rng.uniform(0, 2 * np.pi, n)
    z = rng.uniform(-1, 1, n)
    return np.stack([np.cos(theta), np.sin(theta), z], 1)


def _torus(rng, n, R=0.7, r=0.3):
    u = rng.uniform(0, 2 * np.pi, n)
    v = rng.uniform(0, 2 * np.pi, n)
    return np.stack([(R + r * np.cos(v)) * np.cos(u),
                     (R + r * np.cos(v)) * np.sin(u),
                     r * np.sin(v)], 1)


def _cone(rng, n):
    h = rng.uniform(0, 1, n)
    theta = rng.uniform(0, 2 * np.pi, n)
    r = 1.0 - h
    return np.stack([r * np.cos(theta), r * np.sin(theta), h * 2 - 1], 1)


def _plane(rng, n):
    xy = rng.uniform(-1, 1, (n, 2))
    return np.concatenate([xy, 0.05 * rng.standard_normal((n, 1))], 1)


_GENERATORS = [_sphere, _cube, _cylinder, _torus, _cone, _plane]


@DATASETS.register_module("Synthetic")
class SyntheticDataset:
    """config fields: N_POINTS, NUM_CATEGORY (≤ 6), SIZE, subset, seed;
    optional sensor-noise fields NOISE_OUTLIERS (int: replace that many
    surface points with shell outliers at radius U(1.05, 1.5) — the same
    regime as ``ops.corrupt.lidar_noise``/``gaussian_shell_noise``, which the
    pretask phase trains the prompter to remove) and NOISE_JITTER (float:
    N(0, σ) per-point jitter). Both deterministic per index, so a "noisy
    real-scan" eval set (à la ScanObjectNN) is reproducible."""

    def __init__(self, config):
        self.npoints = config.N_POINTS
        self.num_category = min(int(config.get("NUM_CATEGORY", 6)), len(_GENERATORS))
        self.size = int(config.get("SIZE", 256))
        self.subset = config.get("subset", "train")
        self.seed = int(config.get("seed", 0)) + (0 if self.subset == "train" else 10_000)
        self.noise_outliers = int(config.get("NOISE_OUTLIERS", 0))
        self.noise_jitter = float(config.get("NOISE_JITTER", 0.0))
        # per-index taxonomy metadata, same contract as ShapeNet-55's
        # file_list: lets process-sharded detailed eval resolve taxonomies
        # without loading payloads (runner_pretask._dataset_taxonomies)
        self.file_list = [
            {"taxonomy_id": f"cat{i % self.num_category}",
             "model_id": f"sample{i}"} for i in range(self.size)]

    def __len__(self):
        return self.size

    def __getitem__(self, index):
        label = index % self.num_category
        rng = np.random.default_rng(self.seed * 1_000_003 + index)
        pts = _GENERATORS[label](rng, self.npoints).astype(np.float32)
        pts /= np.max(np.linalg.norm(pts, axis=1))   # unit sphere
        if self.noise_jitter > 0.0:
            pts = pts + self.noise_jitter * rng.standard_normal(
                pts.shape).astype(np.float32)
        m = self.noise_outliers
        if m > 0:
            d = rng.standard_normal((m, 3)).astype(np.float32)
            d /= np.linalg.norm(d, axis=1, keepdims=True)
            r = rng.uniform(1.05, 1.5, (m, 1)).astype(np.float32)
            pts[-m:] = d * r
        return f"cat{label}", f"sample{index}", (pts, label)


@DATASETS.register_module("SyntheticPart")
class SyntheticPartDataset:
    """Procedural part-segmentation dataset with ShapeNetPart label semantics:
    items are (points, cls, seg) like PartNormalDataset; parts are z-slabs of
    the shape, labelled within the category's official part-id range."""

    CATEGORIES = ["Airplane", "Bag", "Cap", "Car"]

    def __init__(self, config):
        from .partnormal import SEG_CLASSES
        self.seg_classes = SEG_CLASSES
        self.npoints = config.N_POINTS
        self.size = int(config.get("SIZE", 64))
        self.subset = config.get("subset", "train")
        self.seed = int(config.get("seed", 0)) + (0 if "train" in self.subset else 10_000)

    def __len__(self):
        return self.size

    def __getitem__(self, index):
        cls = index % len(self.CATEGORIES)
        cat = self.CATEGORIES[cls]
        parts = self.seg_classes[cat]
        rng = np.random.default_rng(self.seed * 917 + index)
        pts = _GENERATORS[cls](rng, self.npoints).astype(np.float32)
        pts /= np.max(np.linalg.norm(pts, axis=1))
        # z-quantile slabs → per-point part labels in the category's range
        q = np.argsort(np.argsort(pts[:, 2])) / self.npoints
        seg = parts[0] + np.minimum((q * len(parts)).astype(np.int32),
                                    len(parts) - 1)
        return pts, np.array([cls], np.int32), seg.astype(np.int32)
