"""Patch-based score denoising (counterpart of ``upp_tpu/utils/denoise.py``;
reference ``utils/denoise.py``, the ScoreDenoise patch denoiser). Imported
nowhere in the main flow, kept for API parity.

The denoiser model is any object with a ``denoise_langevin_dynamics(patches,
step_size, denoise_knn, step_decay, num_steps)`` method; the patch
extraction and reassembly here run the port's FPS and kNN on the input's
device: on the card the seed FPS, the k = min(patch_size, N) patch kNN (the
large-k kernel, ``csrc/knn_select.cu``) and the re-sampling FPS over the
about ``seed_k`` x N flattened patch points (FPS variant 6 past 16384
points, ``csrc/fps.cu``).
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

from ..ops.fps import fps
from ..ops.knn import knn_points


def farthest_point_sampling(pcls: torch.Tensor, num_pnts: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sampled [B, num_pnts, 3], idx [B, num_pnts]): deterministic start at
    index 0 (the reference uses ``random_start=False``)."""
    return fps(pcls, num_pnts)


def normalize_unit_sphere_single(pcl: torch.Tensor):
    """Normalize one cloud [N, 3] into the unit sphere; returns (pcl,
    center [1, 3], scale) (``utils/denoise.py:27-46``)."""
    center = (pcl.amax(0, keepdim=True) + pcl.amin(0, keepdim=True)) / 2.0
    pcl = pcl - center
    scale = torch.sqrt((pcl ** 2).sum(1)).max()
    return pcl / scale, center, scale


@torch.no_grad()
def patch_based_denoise(model, pcl_noisy: torch.Tensor, ld_step_size: float = 0.2,
                        ld_num_steps: int = 30, patch_size: int = 1000,
                        seed_k: int = 3, denoise_knn: int = 4,
                        step_decay: float = 0.95) -> torch.Tensor:
    """Denoise one cloud [N, 3] by overlapping-patch Langevin dynamics
    (``utils/denoise.py:56-82``): FPS seeds, the patch_size nearest points
    of each seed, the model on the patches [S, K, 3], then FPS of the N
    points back out of the S * K denoised patch points."""
    N, d = pcl_noisy.shape
    cloud = pcl_noisy[None]                                    # [1, N, 3]
    n_seeds = max(int(seed_k * N / patch_size), 1)
    seeds, _ = farthest_point_sampling(cloud, n_seeds)
    k = min(patch_size, N)
    _, _, patches = knn_points(seeds, cloud, k)                # [1, S, K, 3]
    denoised = model.denoise_langevin_dynamics(
        patches[0], step_size=ld_step_size, denoise_knn=denoise_knn,
        step_decay=step_decay, num_steps=ld_num_steps)
    out, _ = farthest_point_sampling(denoised.reshape(1, -1, d).contiguous(), N)
    return out[0]


def denoise_large_pointcloud(model, pcl: np.ndarray, cluster_size: int, seed: int = 0,
                             device="cuda") -> np.ndarray:
    """KMeans-cluster a large cloud [N, 3] and denoise each cluster on
    ``device`` with ``seed_k=5`` (``utils/denoise.py:85-105``). Needs
    scikit-learn, imported here as in the JAX package."""
    from sklearn.cluster import KMeans

    n_clusters = math.ceil(pcl.shape[0] / cluster_size)
    kmeans = KMeans(n_clusters=n_clusters, random_state=seed, n_init=10).fit(pcl)
    parts: List[np.ndarray] = []
    for i in range(n_clusters):
        part = torch.as_tensor(pcl[kmeans.labels_ == i], dtype=torch.float32,
                               device=torch.device(device))
        part, center, scale = normalize_unit_sphere_single(part)
        den = patch_based_denoise(model, part, seed_k=5)
        parts.append((den * scale + center).cpu().numpy())
    return np.concatenate(parts, axis=0)
