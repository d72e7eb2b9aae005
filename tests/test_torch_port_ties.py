"""The tie rule the port's FPS and kNN kernels must honour, on the CPU.

The CUDA kernels split the work over many threads and must still pick
exactly the indices of their plain PyTorch versions (``fps_plain_idx``,
``knn_plain``), which these tests hold to the JAX package's Pallas kernels in
interpret mode. The clouds lie on a grid of multiples of 1/8 in [-1, 1] and
repeat points, so every squared distance is exact in float32 and ties are
real whatever the order of the arithmetic: the lowest index must win each
one. The last test keeps the wrappers' limits equal to the CUDA sources'."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upp_tpu.ops.fps_pallas import fps_pallas
from upp_tpu.ops.knn_pallas import _knn_gather_fwd_impl
from upp_torch.ops import fps_cuda, knn_cuda
from upp_torch.ops.fps import fps_plain_idx
from upp_torch.ops.knn import knn, knn_plain, knn_points

CSRC = Path(__file__).resolve().parents[1] / "upp_torch" / "csrc"


def _grid_cloud(B, n, distinct, seed):
    """[B, n, 3] float32: ``distinct`` grid points per cloud and n - distinct
    repeats of them, in a random order."""
    rng = np.random.default_rng(seed)
    base = rng.integers(-8, 9, size=(B, distinct, 3)).astype(np.float32) / 8
    pick = rng.integers(0, distinct, size=(B, n - distinct))
    cloud = np.concatenate([base, np.take_along_axis(base, pick[..., None], 1)], 1)
    order = rng.permuted(np.tile(np.arange(n), (B, 1)), axis=1)
    return np.take_along_axis(cloud, order[..., None], 1)


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.mark.parametrize("mode", ["plain", "masked", "start"])
@pytest.mark.parametrize("n,distinct,samples", [(512, 256, 96), (48, 20, 40)])
def test_fps_ties_index_exact_vs_pallas(mode, n, distinct, samples):
    """(48, 20, 40) samples past the distinct points: every later round is a
    tie at distance 0."""
    xyz = _grid_cloud(2, n, distinct, 0)
    valid = start = None
    if mode != "plain":
        valid = np.random.default_rng(1).random((2, n)) > 0.3
    if mode == "start":
        start = np.array([np.flatnonzero(v)[3] for v in valid], np.int32)
    _, want = fps_pallas(jnp.asarray(xyz), samples,
                         None if valid is None else jnp.asarray(valid),
                         interpret=True, start_idx=None if start is None else jnp.asarray(start))
    got = fps_plain_idx(_t(xyz), samples, None if valid is None else _t(valid),
                        None if start is None else _t(start))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("case", ["k1", "k_eq_n", "k32", "identical"])
def test_knn_ties_index_exact_vs_pallas(case):
    S, N, k, distinct = {"k1": (40, 512, 1, 128), "k_eq_n": (24, 32, 32, 12),
                         "k32": (64, 512, 32, 96), "identical": (20, 100, 16, 1)}[case]
    pts = _grid_cloud(2, N, distinct, 2)
    q = np.concatenate([pts[:, :S // 2], _grid_cloud(2, S - S // 2, S - S // 2, 3)], 1)
    want_d, want_i, want_n = _knn_gather_fwd_impl(jnp.asarray(q), jnp.asarray(pts), k,
                                                  interpret=True)
    d, i, nbr = knn_points(_t(q), _t(pts), k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(d.numpy(), np.asarray(want_d))
    np.testing.assert_array_equal(nbr.numpy(), np.asarray(want_n))
    d2, i2 = knn(_t(q), _t(pts), k)
    np.testing.assert_array_equal(i2.numpy(), i.numpy())
    np.testing.assert_array_equal(d2.numpy(), d.numpy())
    pd, pi = knn_plain(_t(q), _t(pts), k)
    np.testing.assert_array_equal(pi.numpy(), i.numpy())
    if case == "identical":
        np.testing.assert_array_equal(i.numpy(), np.broadcast_to(np.arange(k), (2, S, k)))


@pytest.mark.parametrize("source,constant,wrapper", [
    ("knn.cu", "kMaxK", knn_cuda.MAX_K), ("knn.cu", "kMaxN", knn_cuda.MAX_N),
    ("fps.cu", "kMaxN", fps_cuda.MAX_N)])
def test_wrapper_limits_equal_the_cuda_sources(source, constant, wrapper):
    text = (CSRC / source).read_text()
    found = re.findall(rf"constexpr int {constant} = (\d+);", text)
    assert found == [str(wrapper)]
