"""The port's patch denoiser (``upp_torch/utils/denoise.py``) against the JAX
package's (``upp_tpu/utils/denoise.py``) on the CPU.

Neither package holds a denoiser network: ``model`` is any object with
``denoise_langevin_dynamics``. Both sides get the same stub, an affine map
``p * 0.9 + 0.01``. The patch kNN at k = min(patch_size, N) is XLA
``top_k`` over matmul-form distances in JAX and direct differences in the
port: near-equal neighbours of a seed may come in another order (5 of 30
rows at k = 1000 over 10000 points, the sets equal and the distances within
1.9e-6), so the patches' neighbour sets are held equal and the denoised
coordinates within 1e-5 (the stub's multiply-add may round once in XLA and
twice in PyTorch; the overlapping patches repeat points, so the final FPS
meets exact ties, which both break toward the lowest index)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upp_tpu.ops.fps import fps as j_fps
from upp_tpu.ops.knn import knn_points as j_knn_points
from upp_tpu.utils import denoise as j_denoise
from upp_torch.ops.knn import knn_points
from upp_torch.utils import denoise

TOL = dict(rtol=0, atol=1e-5)


class AffineDenoiser:
    """The stand-in for a score denoiser: every patch point moves to
    ``0.9 p + 0.01``."""

    def __init__(self, xp):
        self.xp = xp

    def denoise_langevin_dynamics(self, patches, step_size, denoise_knn, step_decay,
                                  num_steps):
        assert patches.ndim == 3 and patches.shape[-1] == 3
        return patches * 0.9 + 0.01


def _cloud(n, seed):
    return (np.random.default_rng(seed).standard_normal((n, 3)) * 0.3).astype(np.float32)


@pytest.mark.parametrize("n,patch_size", [(600, 200), (3000, 1000)])
def test_patch_based_denoise_matches_jax(n, patch_size):
    pcl = _cloud(n, n)
    want = j_denoise.patch_based_denoise(AffineDenoiser(jnp), jnp.asarray(pcl),
                                         patch_size=patch_size)
    got = denoise.patch_based_denoise(AffineDenoiser(torch), torch.from_numpy(pcl),
                                      patch_size=patch_size)
    assert got.shape == (n, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the patches: the seeds' neighbour sets equal
    seeds_j, _ = j_fps(jnp.asarray(pcl)[None], max(int(3 * n / patch_size), 1))
    seeds, _ = denoise.farthest_point_sampling(torch.from_numpy(pcl)[None], seeds_j.shape[1])
    np.testing.assert_array_equal(seeds.numpy(), np.asarray(seeds_j))
    k = min(patch_size, n)
    _, want_i, _ = j_knn_points(seeds_j, jnp.asarray(pcl)[None], k)
    _, got_i, _ = knn_points(seeds, torch.from_numpy(pcl)[None], k)
    np.testing.assert_array_equal(np.sort(got_i.numpy(), -1), np.sort(np.asarray(want_i), -1))


def test_normalize_unit_sphere_single_matches_jax():
    pcl = _cloud(500, 3) + np.float32([0.5, -1.0, 2.0])
    want = j_denoise.normalize_unit_sphere_single(jnp.asarray(pcl))
    got = denoise.normalize_unit_sphere_single(torch.from_numpy(pcl))
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=1e-6, atol=1e-7)
    assert np.isclose(np.linalg.norm(got[0].numpy(), axis=1).max(), 1.0, atol=1e-6)


def test_denoise_large_pointcloud_matches_jax():
    """Two blobs, a KMeans cluster each (scikit-learn, as in JAX), each
    denoised with seed_k = 5 in its unit sphere and mapped back."""
    pytest.importorskip("sklearn")
    pcl = np.concatenate([_cloud(300, 4) + 3.0, _cloud(260, 5) - 3.0])
    want = j_denoise.denoise_large_pointcloud(AffineDenoiser(jnp), pcl, cluster_size=300)
    got = denoise.denoise_large_pointcloud(AffineDenoiser(torch), pcl, cluster_size=300,
                                           device="cpu")
    assert got.shape == pcl.shape
    np.testing.assert_allclose(got, want, **TOL)
