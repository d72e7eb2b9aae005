"""The PyTorch port's ops (``upp_torch.ops``) against the JAX package on CPU.

The same numpy inputs from a seed go through both. On the CPU the port runs
the plain PyTorch versions of its CUDA kernels, so these tests hold the
kernels' oracles to the JAX reference: FPS index-exact against the XLA
formulation and the Pallas kernel in interpret mode, kNN index-exact against
the Pallas kernel in interpret mode (both use the difference form of the
distance). Random ops get JAX's own draws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upp_tpu.ops import corrupt as jcorrupt
from upp_tpu.ops.fps import _fps_xla
from upp_tpu.ops.fps_pallas import fps_pallas
from upp_tpu.ops.group import group_points as j_group_points
from upp_tpu.ops.knn import knn as j_knn
from upp_tpu.ops.knn_pallas import _knn_gather_fwd_impl
from upp_tpu.ops.propagate import inverse_distance_interp as j_interp
from upp_tpu.ops.propagate import propagate as j_propagate
from upp_torch.ops import corrupt, fps_cuda, knn_cuda
from upp_torch.ops.fps import fps
from upp_torch.ops.group import group_points
from upp_torch.ops.knn import knn, knn_points
from upp_torch.ops.propagate import inverse_distance_interp, propagate


def _cloud(B, N, seed):
    return np.random.default_rng(seed).standard_normal((B, N, 3)).astype(np.float32)


def _t(a):
    return torch.tensor(np.asarray(a))


def _fps_case(mode):
    """(xyz, valid, start) for FPS: plain, masked, masked with explicit start."""
    xyz = _cloud(3, 300, 0)
    if mode == "plain":
        return xyz, None, None
    valid = np.random.default_rng(1).random((3, 300)) > 0.4
    if mode == "masked":
        return xyz, valid, None
    start = np.array([np.flatnonzero(v)[5] for v in valid], np.int32)
    return xyz, valid, start


@pytest.mark.parametrize("reference", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("mode", ["plain", "masked", "start"])
def test_fps_index_exact(mode, reference):
    xyz, valid, start = _fps_case(mode)
    jv = None if valid is None else jnp.asarray(valid)
    js = None if start is None else jnp.asarray(start)
    if reference == "xla":
        want_pts, want = _fps_xla(jnp.asarray(xyz), 64, jv, js)
    else:
        want_pts, want = fps_pallas(jnp.asarray(xyz), 64, jv, interpret=True,
                                    start_idx=js)
    got_pts, got = fps(_t(xyz), 64, None if valid is None else _t(valid),
                       None if start is None else _t(start))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_pts.numpy(), np.asarray(want_pts))
    if valid is not None:
        assert np.take_along_axis(valid, got.numpy(), 1).all()


def test_fps_gradient_reaches_xyz_through_the_gather():
    xyz = _t(_cloud(2, 50, 3)).requires_grad_(True)
    sampled, idx = fps(xyz, 10)
    sampled.sum().backward()
    want = np.zeros((2, 50, 3), np.float32)
    for b in range(2):
        want[b, idx[b].numpy()] = 1.0
    np.testing.assert_array_equal(xyz.grad.numpy(), want)


@pytest.mark.parametrize("S,N,k", [(64, 300, 32), (32, 280, 16), (17, 256, 1),
                                   (40, 32, 16), (48, 64, 8)])
def test_knn_index_exact_vs_pallas_kernel(S, N, k):
    pts = _cloud(2, N, 4)
    q = np.concatenate([pts[:, :min(S, N)], _cloud(2, max(S - N, 0), 5)], 1)
    want_d, want_i, want_n = _knn_gather_fwd_impl(jnp.asarray(q), jnp.asarray(pts),
                                                  k, interpret=True)
    d, i, nbr = knn_points(_t(q), _t(pts), k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(d.numpy(), np.asarray(want_d), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(nbr.numpy(), np.asarray(want_n))
    d2, i2 = knn(_t(q), _t(pts), k)                       # the gather-free variant
    np.testing.assert_array_equal(i2.numpy(), i.numpy())
    np.testing.assert_array_equal(d2.numpy(), d.numpy())


def test_knn_against_jax_matmul_form():
    """The JAX CPU path ranks by the matmul-form distance, the port by the
    difference form: distances within 1e-5, the same neighbour set wherever
    the k-th and (k+1)-th distances are more than 1e-5 apart."""
    q, pts, k = _cloud(3, 96, 6), _cloud(3, 400, 7), 24
    want_d, want_i = j_knn(jnp.asarray(q), jnp.asarray(pts), k)
    d, i = knn(_t(q), _t(pts), k)
    np.testing.assert_allclose(d.numpy(), np.asarray(want_d), rtol=0, atol=1e-5)
    full, _ = knn(_t(q), _t(pts), k + 1)
    clear = (full[..., k] - full[..., k - 1]).numpy() > 1e-5
    assert clear.mean() > 0.9
    got = np.sort(i.numpy(), -1)[clear]
    np.testing.assert_array_equal(got, np.sort(np.asarray(want_i), -1)[clear])


def test_knn_k_above_n_repeats_the_farthest():
    q, pts = _cloud(2, 5, 8), _cloud(2, 4, 9)
    want_d, want_i = j_knn(jnp.asarray(q), jnp.asarray(pts), 7)
    d, i = knn(_t(q), _t(pts), 7)
    np.testing.assert_array_equal(i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(d.numpy(), np.asarray(want_d), rtol=0, atol=1e-5)


def test_cuda_wrappers_refuse_cpu_tensors():
    xyz = torch.zeros(1, 8, 3)
    with pytest.raises(ValueError, match="CUDA"):
        fps_cuda.fps_idx(xyz, 4)
    with pytest.raises(ValueError, match="CUDA"):
        knn_cuda.knn(xyz, xyz, 4, gather=True)


@pytest.mark.parametrize("masked", [False, True])
def test_group_points(masked):
    xyz = _cloud(2, 320, 10)
    valid = np.random.default_rng(11).random((2, 320)) > 0.3 if masked else None
    want = j_group_points(jnp.asarray(xyz), 16, 12,
                          None if valid is None else jnp.asarray(valid))
    got = group_points(_t(xyz), 16, 12, None if valid is None else _t(valid))
    np.testing.assert_array_equal(got.center_idx.numpy(), np.asarray(want.center_idx))
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    np.testing.assert_array_equal(got.center.numpy(), np.asarray(want.center))
    np.testing.assert_allclose(got.neighborhood.numpy(), np.asarray(want.neighborhood),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("S,k,eps", [(32, 16, 1e-4), (64, 8, 1e-3), (300, 6, 1e-8)])
def test_inverse_distance_interp(S, k, eps):
    """S <= 256 is the JAX package's dense-mix branch, S > 256 its gather.
    rtol 1e-4: the JAX CPU kNN computes matmul-form distances, which round
    differently (~1e-6 relative) from the port's difference form, and the
    weights 1/(d + eps) carry that difference."""
    xyz1, xyz2 = _cloud(2, 100, 12), _cloud(2, S, 13)
    feats2 = _cloud(2, S, 14).repeat(5, -1)
    want = j_interp(jnp.asarray(xyz1), jnp.asarray(xyz2), jnp.asarray(feats2), k=k, eps=eps)
    got = inverse_distance_interp(_t(xyz1), _t(xyz2), _t(feats2), k=k, eps=eps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_propagate():
    xyz1, xyz2 = _cloud(2, 32, 15), _cloud(2, 32, 16)
    p1, p2 = _cloud(2, 32, 17).repeat(4, -1), _cloud(2, 32, 18).repeat(4, -1)
    want = j_propagate(*map(jnp.asarray, (xyz1, xyz2, p1, p2)), de_neighbors=6)
    got = propagate(*map(_t, (xyz1, xyz2, p1, p2)), de_neighbors=6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("duplicates", [False, True])
def test_separate_point_cloud_fixed_viewpoint(duplicates):
    xyz = _cloud(2, 512, 19)
    if duplicates:            # exact distance ties at the crop threshold
        xyz[:, 1::2] = xyz[:, ::2]
    v = np.array([0.6, -0.48, 0.64], np.float32)
    want_p, want_c = jcorrupt.separate_point_cloud(
        jax.random.key(0), jnp.asarray(xyz), 160, sample_points=128,
        fixed_viewpoint=jnp.asarray(v))
    got_p, got_c = corrupt.separate_point_cloud(_t(xyz), 160, sample_points=128,
                                                viewpoint=_t(v))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    alone = corrupt.partial_point_cloud(_t(xyz), 160, sample_points=128, viewpoint=_t(v))
    np.testing.assert_array_equal(alone.numpy(), got_p.numpy())


def test_lidar_noise_with_jax_draws():
    pts = _cloud(2, 200, 20)
    key = jax.random.key(3)
    k1, k2 = jax.random.split(key)
    idx = jax.random.randint(k1, (48,), 0, 200)
    factor = jax.random.uniform(k2, (48,), jnp.float32, 1.2, 1.5)
    want = jcorrupt.lidar_noise(key, jnp.asarray(pts), 48, scale=1.5, low=1.2)
    got = corrupt.lidar_noise(_t(pts), 48, scale=1.5, low=1.2, idx=_t(idx),
                              factor=_t(factor))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_gaussian_shell_noise_with_jax_draws():
    key = jax.random.key(4)
    normal = jax.random.normal(key, (2, 24, 3), jnp.float32)
    want = jcorrupt.gaussian_shell_noise(key, (2, 24, 3), loc=0.0, scale=0.1,
                                         shell_radius=0.9)
    got = corrupt.gaussian_shell_noise((2, 24, 3), loc=0.0, scale=0.1,
                                       shell_radius=0.9, normal=_t(normal))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_scale_translate_and_normalize():
    pc = _cloud(3, 64, 21)
    key = jax.random.key(5)
    k1, k2 = jax.random.split(key)
    s = jax.random.uniform(k1, (3, 1, 3), jnp.float32, 2.0 / 3.0, 3.0 / 2.0)
    t = jax.random.uniform(k2, (3, 1, 3), jnp.float32, -0.2, 0.2)
    want = jcorrupt.scale_translate(key, jnp.asarray(pc))
    got = corrupt.scale_translate(_t(pc), scale=_t(s), shift=_t(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    for recenter in (False, True):
        want = jcorrupt.normalize_unit_sphere(jnp.asarray(pc), recenter=recenter)
        got = corrupt.normalize_unit_sphere(_t(pc), recenter=recenter)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
