"""The port's FPS and kNN past the earlier kernels' limits, on the CPU.

The patch denoiser (``utils/denoise.py``) runs FPS over clouds of more than
16384 points (the FPS kernel's variant 6, ``csrc/fps.cu``) and a kNN of
k = 1000 over tens of thousands of points (``csrc/knn_select.cu``). On the
CPU the plain versions run; they are the oracles the kernels are held to on
the card (``chip_smoke.py`` phase 41), and here they are held to the JAX
package. The JAX kNN at k > 42 is XLA ``top_k`` over matmul-form distances
(``upp_tpu/ops/geometry.py:17-31``), which round differently from the
port's direct differences, so near-equal neighbours may come in another
order: the neighbour sets are held equal and the distances within 2e-6.
The wrappers check their limits before the device, so the limits are
tested without a card."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upp_tpu.ops.fps import fps as j_fps
from upp_tpu.ops.knn import knn_points as j_knn_points
from upp_torch.ops import fps_cuda, knn_cuda
from upp_torch.ops.fps import fps_plain_idx
from upp_torch.ops.knn import knn_plain, knn_points

CSRC = Path(__file__).resolve().parents[1] / "upp_torch" / "csrc"


def _cloud(b, n, seed):
    return np.random.default_rng(seed).standard_normal((b, n, 3)).astype(np.float32)


def test_knn_plain_at_k_1000_over_20000_matches_jax():
    pts = _cloud(1, 20000, 0)
    q = _cloud(1, 6, 1)
    want_d, want_i, want_n = j_knn_points(jnp.asarray(q), jnp.asarray(pts), 1000)
    d, i = knn_plain(torch.from_numpy(q), torch.from_numpy(pts), 1000)
    np.testing.assert_array_equal(np.sort(i.numpy(), -1), np.sort(np.asarray(want_i), -1))
    np.testing.assert_allclose(d.numpy(), np.asarray(want_d), rtol=0, atol=2e-6)
    _, _, nbr = knn_points(torch.from_numpy(q), torch.from_numpy(pts), 1000)
    np.testing.assert_array_equal(nbr.numpy(), pts[0][i.numpy()[0]][None])
    assert np.asarray(want_n).shape == nbr.shape


def test_fps_past_16384_matches_jax():
    xyz = _cloud(1, 20000, 2)
    _, want = j_fps(jnp.asarray(xyz), 512)
    got = fps_plain_idx(torch.from_numpy(xyz), 512)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("call,match", [
    (lambda: fps_cuda.fps_idx(torch.zeros(1, fps_cuda.MAX_N + 1, 3), 4), "range"),
    (lambda: knn_cuda.knn(torch.zeros(1, 4, 3), torch.zeros(1, 100, 3), 65, False), "range"),
    (lambda: knn_cuda.knn(torch.zeros(1, 4, 3), torch.zeros(1, knn_cuda.MAX_N + 1, 3), 8,
                          False), "range"),
    (lambda: knn_cuda.knn_select(torch.zeros(1, 4, 3), torch.zeros(1, 2000, 3),
                                 knn_cuda.SELECT_MAX_K + 1), "range"),
    (lambda: knn_cuda.knn_select(torch.zeros(1, 4, 3), torch.zeros(1, 100, 3), 101), "range"),
    (lambda: knn_cuda.knn_select(torch.zeros(1, 1, 3),
                                 torch.zeros(1, knn_cuda.SELECT_MAX_N + 1, 3), 8), "range"),
    (lambda: knn_cuda.knn_select(torch.zeros(1, 4, 3), torch.zeros(1, 2000, 3), 1000), "CUDA"),
])
def test_wrappers_raise_past_their_limits(call, match):
    """Past a kernel's limits the wrapper raises (no fallback), before it
    looks at the device; within them a CPU tensor is refused."""
    with pytest.raises(ValueError, match=match):
        call()


@pytest.mark.parametrize("constant,wrapper", [
    ("kMaxK", knn_cuda.SELECT_MAX_K), ("kMaxN", knn_cuda.SELECT_MAX_N),
    ("kCandidates", knn_cuda.SELECT_CANDIDATES), ("kGathered", knn_cuda.SELECT_GATHERED),
    ("kMaxStoredShare", knn_cuda.SELECT_MAX_STORED_SHARE)])
def test_select_limits_equal_the_cuda_source(constant, wrapper):
    found = re.findall(rf"constexpr int {constant} = (\d+);",
                       (CSRC / "knn_select.cu").read_text())
    assert found == [str(wrapper)]


def test_fps_limit_covers_the_denoise_resampling():
    """Variant 6 serves 2^18 points: ``denoise_large_pointcloud``'s seed_k
    = 5 re-sampling of a cluster half again its nominal 30000 points, and
    the 50K path's 150000."""
    assert fps_cuda.MAX_N == 2 ** 18 >= 5 * 45000


@pytest.mark.parametrize("k, gather", [(6, True), (6, False), (3, True)])
def test_kernel_path_repeats_the_farthest_past_n(monkeypatch, k, gather):
    """``ops.knn.KnnKernel`` asks the kernel for min(k, N) neighbours and
    repeats the farthest past N, as the JAX package and ``knn_plain`` do
    (the tiny dry-run model groups 16 neighbours among fewer points); its
    outputs and gradients equal the plain path's. The kernel wrapper is
    stood in by the plain version, as it answers for k <= N."""
    from upp_torch.ops import knn as knn_mod
    from upp_torch.ops.geometry import index_points

    def kernel(q, p, kk, g):
        assert kk <= p.shape[1]
        d, i = knn_plain(q, p, kk)
        return d, i.int(), index_points(p, i) if g else None

    monkeypatch.setattr(knn_cuda, "knn", kernel)
    q0, p0 = torch.from_numpy(_cloud(2, 5, 3)), torch.from_numpy(_cloud(2, 3, 4))
    outs, grads = [], []
    for path in ("kernel", "plain"):
        q, p = q0.clone().requires_grad_(True), p0.clone().requires_grad_(True)
        if path == "kernel":
            got = knn_mod.KnnKernel.apply(q, p, k, gather)
        else:
            d, i = knn_plain(q, p, k)
            got = (d, i, index_points(p, i)) if gather else (d, i)
        loss = (got[0] * torch.arange(k)).sum() + (got[2].sum(-1).square().sum() if gather else 0)
        loss.backward()
        outs.append(got)
        grads.append((q.grad, p.grad))
    assert outs[0][0].shape == (2, 5, k)
    for a, b in zip(outs[0], outs[1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
