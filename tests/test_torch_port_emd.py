"""The PyTorch port's EMD (``upp_torch.ops.emd``) and completion metrics
(``upp_torch.train.metrics.Metrics``) on the CPU.

The golden-value tests of ``tests/test_ops_losses.py`` (the reference's
``extensions/emd/test_emd_loss.py``) run on the port, then the port is held
to the JAX package on the same numpy clouds: ``earth_mover_distance``,
``approx_match`` and the gradients at rtol 1e-4 / atol 1e-5 (both compute
the same float32 rounds from bit-equal squared distances; the sums' order
differs), ``Metrics.get(..., require_emd=True)`` at rtol 1e-4 / atol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upp_tpu.ops import emd as jax_emd
from upp_tpu.train.metrics import Metrics as JaxMetrics
from upp_torch.ops.emd import approx_match, earth_mover_distance, match_cost
from upp_torch.train.metrics import Metrics

TOL = dict(rtol=1e-4, atol=1e-5)
P1 = np.array([[[1.7, -0.1, 0.1], [0.1, 1.2, 0.3]]], np.float32).repeat(3, 0)
P2 = np.array([[[0.3, 1.8, 0.2], [1.2, -0.2, 0.3]]], np.float32).repeat(3, 0)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_golden_two_point_matching():
    """Optimal: p1[0] <-> p2[1], p1[1] <-> p2[0]; the cost divides by n = 2."""
    d_opt = ((P1[0, 0] - P2[0, 1]) ** 2).sum() + ((P1[0, 1] - P2[0, 0]) ** 2).sum()
    cost = earth_mover_distance(torch.tensor(P1), torch.tensor(P2), reduce_mean=False)
    np.testing.assert_allclose(cost.numpy(), np.full(3, d_opt / 2), rtol=1e-3)


def test_golden_gradients():
    p1 = torch.tensor(P1, requires_grad=True)
    p2 = torch.tensor(P2, requires_grad=True)
    d = earth_mover_distance(p1, p2, reduce_mean=False)
    (d[0] / 2 + d[1] * 2 + d[2] / 3).backward()
    # the matched pairs' squared-distance gradients (the match ~ a permutation)
    w = np.array([0.5, 2.0, 1.0 / 3.0], np.float32) / 2.0
    want1 = np.stack([2 * (P1[i] - P2[i][::-1]) * w[i] for i in range(3)])
    np.testing.assert_allclose(p1.grad.numpy(), want1, rtol=1e-2, atol=1e-3)
    np.testing.assert_allclose(p2.grad.numpy(), -want1[:, ::-1], rtol=1e-2, atol=1e-3)


def test_approx_match_is_doubly_stochastic_when_square():
    m = approx_match(torch.tensor(_rand((2, 32, 3), 8)), torch.tensor(_rand((2, 32, 3), 9)))
    np.testing.assert_allclose(m.sum(1).numpy(), 1.0, atol=2e-2)
    np.testing.assert_allclose(m.sum(2).numpy(), 1.0, atol=2e-2)


def test_match_cost_backward_is_the_formula():
    a, b = _rand((1, 6, 3), 10), _rand((1, 6, 3), 11)
    m = approx_match(torch.tensor(a), torch.tensor(b))
    ta, tb = torch.tensor(a, requires_grad=True), torch.tensor(b, requires_grad=True)
    match_cost(ta, tb, m)[0].backward()
    mn = m.numpy()[0].T                                      # [n, m]
    want1 = 2 * (a[0] * mn.sum(1, keepdims=True) - mn @ b[0])
    want2 = 2 * (b[0] * mn.sum(0)[:, None] - mn.T @ a[0])
    np.testing.assert_allclose(ta.grad.numpy()[0], want1, **TOL)
    np.testing.assert_allclose(tb.grad.numpy()[0], want2, **TOL)


@pytest.mark.parametrize("shape1, shape2, seed", [((2, 32, 3), (2, 32, 3), 30),
                                                  ((2, 48, 3), (2, 24, 3), 31),
                                                  ((2, 16, 3), (2, 64, 3), 32)])
def test_fused_matches_explicit_match_path(shape1, shape2, seed):
    """The fused rounds (no match held) equal approx_match + match_cost,
    values and gradients, on uneven sizes both ways."""
    a, b = _rand(shape1, seed), _rand(shape2, seed + 100)

    def run(fused):
        x, y = torch.tensor(a, requires_grad=True), torch.tensor(b, requires_grad=True)
        if fused:
            cost = earth_mover_distance(x, y, reduce_mean=False)
        else:
            cost = match_cost(x, y, approx_match(x, y)) / x.shape[1]
        cost.sum().backward()
        return cost.detach().numpy(), x.grad.numpy(), y.grad.numpy()

    got, want = run(True), run(False)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)


def test_close_to_optimal_assignment():
    """At or above the optimal transport cost (scipy's Hungarian algorithm),
    within 2x of it on unstructured gaussian clouds (the Fan/Mo heuristic is
    loose there, ~1.6x)."""
    from scipy.optimize import linear_sum_assignment
    rng = np.random.default_rng(11)
    a = rng.standard_normal((2, 24, 3)).astype(np.float32)
    b = rng.standard_normal((2, 24, 3)).astype(np.float32)
    approx = earth_mover_distance(torch.tensor(a), torch.tensor(b), reduce_mean=False).numpy()
    for i in range(2):
        cost_mat = ((a[i][:, None, :] - b[i][None, :, :]) ** 2).sum(-1)
        r, c = linear_sum_assignment(cost_mat)
        optimal = cost_mat[r, c].sum() / 24.0
        assert optimal - 1e-4 <= approx[i] <= optimal * 2.0


@pytest.mark.parametrize("n, m, seed", [(64, 64, 0), (96, 48, 1), (40, 128, 2)])
def test_against_jax(n, m, seed):
    """EMD, the match and the gradients of a weighted sum of the per-cloud
    costs, port against JAX on the same clouds."""
    a, b = _rand((2, n, 3), seed), _rand((2, m, 3), seed + 9)
    weights = np.array([1.0, 2.0], np.float32)
    want = jax_emd.earth_mover_distance(jnp.asarray(a), jnp.asarray(b), reduce_mean=False)
    want_g = jax.grad(lambda x, y: (jax_emd.earth_mover_distance(x, y, reduce_mean=False)
                                    * weights).sum(), argnums=(0, 1))(jnp.asarray(a),
                                                                      jnp.asarray(b))
    x, y = torch.tensor(a, requires_grad=True), torch.tensor(b, requires_grad=True)
    got = earth_mover_distance(x, y, reduce_mean=False)
    (got * torch.tensor(weights)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for g, w in zip((x.grad, y.grad), want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    np.testing.assert_allclose(approx_match(torch.tensor(a), torch.tensor(b)).numpy(),
                               np.asarray(jax_emd.approx_match(jnp.asarray(a), jnp.asarray(b))),
                               **TOL)
    np.testing.assert_allclose(float(earth_mover_distance(torch.tensor(a), torch.tensor(b))),
                               float(jax_emd.earth_mover_distance(jnp.asarray(a),
                                                                  jnp.asarray(b))), **TOL)


def test_metrics_get_against_jax():
    """``Metrics.get`` with and without EMD, and ``better_than``, against the
    JAX package's table on the same clouds (a noisy copy of the ground
    truth, so the F-Score is neither 0 nor 1)."""
    gt = _rand((2, 256, 3), 20) * 0.05
    pred = gt[:, :200] + 0.004 * _rand((2, 200, 3), 21)
    got = Metrics.get(torch.tensor(pred), torch.tensor(gt), require_emd=True)
    want = JaxMetrics.get(pred, gt, require_emd=True)
    assert len(got) == len(want) == 4
    assert 0.0 < got[0] < 1.0
    np.testing.assert_allclose(got, want, **TOL)
    assert Metrics.get(torch.tensor(pred), torch.tensor(gt)) == got[:3]
    for name in Metrics.names():
        for a, b in ((1.0, 2.0), (2.0, 1.0)):
            assert Metrics.better_than(name, a, b) == JaxMetrics.better_than(name, a, b)
