"""The port's Chamfer ops and the kNN backward against the JAX package on CPU.

On the CPU the port runs the plain PyTorch version of its Chamfer kernel,
which is held index-exact against the Pallas kernel in interpret mode (both
use the difference form of the distance; distances within 1e-6, the
interpreter's own rounding). The losses are held against the JAX losses,
whose CPU path ranks by the matmul form: values at rtol 1e-5, gradients at
rtol 1e-4 / atol 1e-6. The kNN kernel's autograd Function is driven on the
CPU through a stand-in for the CUDA binding, and its backward is held
against JAX's custom VJPs of ``knn_gather`` and ``knn_idx``."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upp_tpu.ops import chamfer as jchamfer
from upp_tpu.ops.chamfer_pallas import _nn_both_impl
from upp_tpu.ops.knn_pallas import knn_gather, knn_idx
from upp_tpu.train.metrics import completion_metrics as j_completion_metrics
from upp_torch.ops import chamfer, chamfer_cuda, knn_cuda
from upp_torch.ops.geometry import index_points
from upp_torch.ops.knn import KnnKernel, knn_backward, knn_plain
from upp_torch.train.metrics import completion_metrics


def _cloud(B, N, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal((B, N, 3))).astype(np.float32)


def _t(a):
    return None if a is None else torch.tensor(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _case(kind):
    """(x, y, valid_x, valid_y) for the index tests."""
    x, y = _cloud(2, 150, 0), _cloud(2, 300, 1)
    vx = vy = None
    if kind == "masked":
        rng = np.random.default_rng(2)
        vx, vy = rng.random((2, 150)) > 0.3, rng.random((2, 300)) > 0.3
    if kind == "ties":          # duplicated points: equal distances to two slots
        y[:, 1::2] = y[:, ::2]
        x[:, 1::2] = x[:, ::2]
    if kind == "all_invalid":   # a cloud without a valid target
        vx = np.ones((2, 150), bool)
        vy = np.ones((2, 300), bool)
        vy[1] = False
    return x, y, vx, vy


@pytest.mark.parametrize("kind", ["plain", "masked", "ties", "all_invalid"])
def test_nn_both_plain_index_exact_vs_pallas_kernel(kind):
    x, y, vx, vy = _case(kind)
    want = _nn_both_impl(jnp.asarray(x), jnp.asarray(y), _j(vx), _j(vy), interpret=True)
    got = chamfer.nn_both(_t(x), _t(y), _t(vx), _t(vy))
    for g, w in zip(got[1::2], want[1::2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(got[0::2], want[0::2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)
    if vy is not None:
        assert np.take_along_axis(vy, got[1].numpy(), 1)[vy.any(1)].all()


def test_nn_both_plain_chunks_like_one_pass(monkeypatch):
    x, y = _cloud(2, 70, 3), _cloud(2, 90, 4)
    whole = chamfer.nn_both_plain(_t(x), _t(y))
    monkeypatch.setattr(chamfer, "_CHUNK_ELEMS", 2 * 90 * 8)     # chunks of 8 queries
    chunked = chamfer.nn_both_plain(_t(x), _t(y))
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)


LOSSES = {
    "l1": (jchamfer.chamfer_l1, chamfer.chamfer_l1),
    "l2": (jchamfer.chamfer_l2, chamfer.chamfer_l2),
    "l2_split": (lambda *a: sum(jchamfer.chamfer_l2_split(*a)),
                 lambda *a: sum(chamfer.chamfer_l2_split(*a))),
    "raw_d2": (lambda *a: jchamfer.chamfer_raw(*a)[1], lambda *a: chamfer.chamfer_raw(*a)[1]),
    "l1_per_sample": (lambda x, y, *_: jchamfer.chamfer_l1_per_sample(x, y).sum(),
                      lambda x, y, *_: chamfer.chamfer_l1_per_sample(x, y).sum()),
    "l2_per_sample": (lambda x, y, *_: jchamfer.chamfer_l2_per_sample(x, y).sum(),
                      lambda x, y, *_: chamfer.chamfer_l2_per_sample(x, y).sum()),
}


@pytest.mark.parametrize("loss,masked", [(name, m) for name in sorted(LOSSES)
                                          for m in (False, True)
                                          if not (m and "per_sample" in name)])
def test_chamfer_losses_and_gradients_match_jax(loss, masked):
    x, y = _cloud(2, 96, 5), _cloud(2, 200, 6, scale=0.9)
    x[:, 0] = y[:, 0]                        # a coincident pair: the eps clamp
    rng = np.random.default_rng(7)
    vx = rng.random((2, 96)) > 0.25 if masked else None
    vy = rng.random((2, 200)) > 0.25 if masked else None
    jf, tf = LOSSES[loss]
    want, (wgx, wgy) = jax.value_and_grad(
        lambda a, b: jf(a, b, _j(vx), _j(vy)), argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    tx, ty = _t(x).requires_grad_(True), _t(y).requires_grad_(True)
    got = tf(tx, ty, _t(vx), _t(vy))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(wgx), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(ty.grad.numpy(), np.asarray(wgy), rtol=1e-4, atol=1e-6)


def test_completion_metrics_match_jax():
    pred, gt = _cloud(2, 160, 8, scale=0.5), _cloud(2, 400, 9, scale=0.5)
    pred[:, :40] = gt[:, :40] + 0.003          # some pairs inside the F-score threshold
    want = j_completion_metrics(jnp.asarray(pred), jnp.asarray(gt))
    got = completion_metrics(_t(pred), _t(gt))
    assert set(got) == set(want) == {"F-Score", "CDL1", "CDL2"}
    assert 0.0 < float(want["F-Score"]) < 1.0
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5, err_msg=k)


def _stand_in_kernel(query, points, k, gather):
    """``knn_cuda.knn`` on the CPU: the plain version in the kernel's output
    format (int32 indices), refusing inputs that carry a gradient, as the
    binding does."""
    assert not (query.requires_grad or points.requires_grad)
    d, idx = knn_plain(query, points, k)
    return d, idx.int(), index_points(points, idx) if gather else None


@pytest.mark.parametrize("gather", [True, False])
def test_knn_function_backward_matches_jax_vjp(gather):
    """The Function's backward, called directly, against JAX's custom VJP on
    the same forward (the Pallas kernel in interpret mode), cotangents
    shared."""
    q, p, k = _cloud(2, 24, 10), _cloud(2, 300, 11), 6
    rng = np.random.default_rng(12)
    g_d = rng.standard_normal((2, 24, k)).astype(np.float32)
    g_nb = rng.standard_normal((2, 24, k, 3)).astype(np.float32)
    if gather:
        out, vjp = jax.vjp(lambda a, b: knn_gather(a, b, k), jnp.asarray(q), jnp.asarray(p))
        want = vjp((jnp.asarray(g_d), jnp.zeros(out[1].shape, out[1].dtype), jnp.asarray(g_nb)))
    else:
        out, vjp = jax.vjp(lambda a, b: knn_idx(a, b, k), jnp.asarray(q), jnp.asarray(p))
        want = vjp((jnp.asarray(g_d), jnp.zeros(out[1].shape, out[1].dtype)))
    d, idx = knn_plain(_t(q), _t(p), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(out[1]))
    nbr = index_points(_t(p), idx) if gather else None
    ctx = types.SimpleNamespace(saved_tensors=(_t(q), _t(p), idx, nbr))
    grads = KnnKernel.backward(ctx, _t(g_d), None, *([_t(g_nb)] if gather else []))
    assert grads[2:] == (None, None)
    for g, w in zip(grads[:2], want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("gather", [True, False])
def test_knn_function_gradients_equal_autograd_through_plain(monkeypatch, gather):
    """The Function end to end (forward through the stand-in, backward by
    autograd) against autograd through ``knn_plain``; under inference mode
    it records nothing."""
    monkeypatch.setattr(knn_cuda, "knn", _stand_in_kernel)
    q, p, k = _cloud(2, 20, 13), _cloud(2, 50, 14), 6
    rng = np.random.default_rng(15)
    g_d = torch.tensor(rng.standard_normal((2, 20, k)).astype(np.float32))
    g_nb = torch.tensor(rng.standard_normal((2, 20, k, 3)).astype(np.float32))
    grads = []
    for through_function in (True, False):
        tq, tp = _t(q).requires_grad_(True), _t(p).requires_grad_(True)
        if through_function:
            out = KnnKernel.apply(tq, tp, k, gather)
        else:
            d, idx = knn_plain(tq, tp, k)
            out = (d, idx, index_points(tp, idx))
        loss = (out[0] * g_d).sum() + ((out[2] * g_nb).sum() if gather else 0.0)
        grads.append(torch.autograd.grad(loss, (tq, tp)))
        assert out[1].dtype == torch.int64
    for g, w in zip(*grads):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-6)
    with torch.inference_mode():
        out = KnnKernel.apply(_t(q), _t(p), k, gather)
    assert len(out) == (3 if gather else 2) and not out[0].requires_grad


def test_knn_backward_scatters_repeated_neighbours():
    """A point chosen by several queries gathers all their rows."""
    q = torch.zeros(1, 3, 3)
    p = torch.tensor([[[0.0, 0.0, 0.0], [5.0, 5.0, 5.0]]])
    idx = torch.zeros(1, 3, 1, dtype=torch.long)
    g_nb = torch.ones(1, 3, 1, 3)
    _, g_p = knn_backward(q, p, idx, index_points(p, idx), torch.zeros(1, 3, 1), g_nb)
    np.testing.assert_array_equal(g_p.numpy(), [[[3.0, 3.0, 3.0], [0.0, 0.0, 0.0]]])


def test_chamfer_wrapper_refuses_cpu_tensors_and_bad_masks():
    x = torch.zeros(1, 8, 3)
    with pytest.raises(ValueError, match="CUDA"):
        chamfer_cuda.nn_both(x, x)
    with pytest.raises(ValueError, match="bool"):
        chamfer_cuda._check_mask("valid_x", torch.ones(1, 7, dtype=torch.bool), x)
