"""``if_half: True`` in the port against the JAX package on CPU: the four
models that read it (``Point_MAE_unify``, ``Point_MAE_pretask_dev``,
``Point_MAE_unify_seg``, ``Point_MAE``) run their block stacks (and
``Point_MAE`` its encoder convolutions) as bf16 products with float32
accumulation, at the small sizes of the other port tests, with the same
numpy-seeded weights moved by ``upp_torch.weights``.

Bound of every eval output: max |port - JAX| at most max |JAX bf16 - JAX
float32| on the same weights and input (the knob's own effect), and at
most 2e-2 of the output's largest magnitude. The port's products are exact
(two bf16 values multiply exactly in float32) and accumulate in float32, as
JAX's do; the two packages' float32 roundings of an operand differ in the
last bit now and then, and a bf16 cast turns that into one bf16 step (4e-3
relative), so the gap is a fraction of the knob's own and not float32's.
The classifier's three passes are held one by one on the same input
(rectify vectors, the completion pass's centres and rebuild, the downstream
pass): the forward that chains them sorts the rectify scores (the top-5%
drop) and re-samples by FPS, and such discrete choices reorder near ties
under any difference of rounding, which no bound on the arithmetic covers.
A guard holds that the knob is read: the port's bf16 output differs from
its float32 output by more than 1e-4. One ``Point_MAE`` pretrain step in
bf16 holds the JAX bf16 step's loss at rtol 1e-2 and the gradients' global
norm at rtol 2e-2."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_baseline import MAE_SMALL, N_PTS, _masks
from test_torch_port_cls_train import _jnp
from test_torch_port_model import N_NOISE, POINT_NUM, SMALL, build_pair
from test_torch_port_pretask import _grad_capture
from test_torch_port_pretask import INIT_KW as PRETASK_INIT_KW
from test_torch_port_pretask import N_IN as PRETASK_N_IN
from test_torch_port_pretask import POINT_NUM as PRETASK_POINT_NUM
from test_torch_port_pretask import TINY_PT
from test_torch_port_pretrain import PRETRAIN, _clouds, _port_pretrain_step, _state
from test_torch_port_pretrain import KEY as PRETRAIN_KEY
from test_torch_port_seg_model import P_IN, SEG_SMALL, seg_inputs
from upp_tpu.models import baseline as j_baseline
from upp_tpu.models import build_model_from_cfg as jax_build
from upp_tpu.train import runner_pretrain as j_runner_pretrain
from upp_tpu.utils.config import ConfigDict
from upp_torch.models import build_model_from_cfg
from upp_torch.models.layers import half_matmul
from upp_torch.weights import state_dict_from_jax

REL_BOUND = 2e-2
GUARD = 1e-4


def _pts(n, seed, b=2):
    return np.random.default_rng(seed).standard_normal((b, n, 3)).astype(np.float32)


def _quad(cfg, seed, **pair_kw):
    """(JAX bf16 model, JAX float32 model, variables, port bf16 model, port
    float32 model), all with one set of weights."""
    half = {**cfg, "if_half": True}
    jm16, variables, tm16 = build_pair(half, seed=seed, **pair_kw)
    jm32 = jax_build(ConfigDict.from_nested({**cfg, "if_half": False}))
    tm32 = build_model_from_cfg({**cfg, "if_half": False}).eval()
    tm32.load_state_dict(state_dict_from_jax(variables, tm32), strict=True)
    return jm16, jm32, variables, tm16, tm32


def _flat(out):
    outs = out if isinstance(out, (tuple, list)) else (out,)
    return np.concatenate([np.asarray(o, np.float64).ravel() for o in outs])


def _hold(name, jax_fn, port_fn, quad):
    """Bound and guard of one output; returns (port gap, knob gap, largest)."""
    jm16, jm32, variables, tm16, tm32 = quad
    j16, j32 = _flat(jax_fn(jm16, variables)), _flat(jax_fn(jm32, variables))
    with torch.no_grad():
        p16 = _flat([t.numpy() for t in _tuple(port_fn(tm16))])
        p32 = _flat([t.numpy() for t in _tuple(port_fn(tm32))])
    gap, knob, top = (np.abs(p16 - j16).max(), np.abs(j16 - j32).max(), np.abs(j16).max())
    assert gap <= knob, (name, gap, knob)
    assert gap <= REL_BOUND * top, (name, gap, top)
    assert np.abs(p16 - p32).max() > GUARD, (name, "if_half changed nothing")
    return gap, knob, top


def _tuple(out):
    return out if isinstance(out, (tuple, list)) else (out,)


@pytest.fixture(scope="module")
def cls_quad():
    return _quad(SMALL, 0, point_num=POINT_NUM, n_in=POINT_NUM + N_NOISE)


CLS_PASSES = {
    "downstream": (
        lambda m, v, x: m.apply(v, x, point_num=POINT_NUM, deterministic=True),
        lambda t, x: t(x, point_num=POINT_NUM)),
    "rectify": (
        lambda m, v, x: m.apply(v, x, method=lambda mm, a: mm.core.rectify_vectors(a, True)),
        lambda t, x: t.rectify_vectors(x)),
    "completion": (
        lambda m, v, x: m.apply(v, x, method=lambda mm, a: mm.core.complete(a, True)),
        lambda t, x: t.complete(x)),
}


@pytest.mark.parametrize("which", sorted(CLS_PASSES))
def test_unify_classifier_passes_in_bf16_match_jax(cls_quad, which):
    """``Point_MAE_unify``: each of the three passes over the shared
    backbone (and the completion pass's decoder) on one input."""
    jax_fn, port_fn = CLS_PASSES[which]
    x = _pts(POINT_NUM + N_NOISE, 3)
    _hold(which, lambda m, v: jax_fn(m, v, jnp.asarray(x)),
          lambda t: port_fn(t, torch.tensor(x)), cls_quad)


def test_pretask_dev_in_bf16_matches_jax():
    """``Point_MAE_pretask_dev``'s eval forward: the completion pass."""
    quad = _quad(TINY_PT, 3, point_num=PRETASK_POINT_NUM, n_in=PRETASK_N_IN,
                 **PRETASK_INIT_KW)
    x = _pts(PRETASK_POINT_NUM, 4)
    _hold("pretask_dev",
          lambda m, v: m.apply(v, jnp.asarray(x), point_num=PRETASK_POINT_NUM,
                               deterministic=True),
          lambda t: t(torch.tensor(x), point_num=PRETASK_POINT_NUM), quad)


def test_unify_seg_in_bf16_matches_jax():
    """``Point_MAE_unify_seg``'s downstream pass with the block taps, the
    propagation and the seg head (log-probabilities)."""
    quad = _quad(SEG_SMALL, 21, point_num=P_IN, n_in=P_IN, inputs=seg_inputs(),
                 completion_prompt=True, denoise=True, deterministic=True)
    rng = np.random.default_rng(5)
    pts = _pts(P_IN, 6)
    label = np.eye(16, dtype=np.float32)[rng.integers(0, 16, 2)]
    query = _pts(256, 7)
    _hold("unify_seg",
          lambda m, v: m.apply(v, jnp.asarray(pts), jnp.asarray(label), jnp.asarray(query),
                               completion_prompt=False, denoise=False, deterministic=True),
          lambda t: t(torch.tensor(pts), torch.tensor(label), torch.tensor(query),
                      completion_prompt=False, denoise=False), quad)


@pytest.fixture(scope="module")
def mae_quad():
    return _quad(MAE_SMALL, 41, point_num=None, n_in=N_PTS, deterministic=True)


def test_point_mae_in_bf16_matches_jax(mae_quad, monkeypatch):
    """``Point_MAE`` in eval: the reconstruction loss on a given group split
    (bf16 encoder convolutions, both plain stacks) and the probe
    features."""
    vis, mask = _masks(6)
    monkeypatch.setattr(j_baseline.PointMAE, "_rand_mask_idx",
                        lambda self, b: (jnp.asarray(vis), jnp.asarray(mask)))
    x = _pts(N_PTS, 5, b=4)
    masks = (torch.tensor(vis).long(), torch.tensor(mask).long())
    _hold("point_mae loss",
          lambda m, v: m.apply(v, jnp.asarray(x), deterministic=True,
                               rngs={"mask": jax.random.key(0)}),
          lambda t: t(torch.tensor(x), masks=masks), mae_quad)
    _hold("point_mae features",
          lambda m, v: m.apply(v, jnp.asarray(x), eval_features=True),
          lambda t: t(torch.tensor(x), eval_features=True), mae_quad)


def test_point_mae_pretrain_step_in_bf16_matches_jax(mae_quad):
    """One ``make_pretrain_step`` of each package in bf16 on the same
    clouds, group split and augmentation draws: loss within rtol 1e-2, the
    gradients' global norm within rtol 2e-2."""
    jm16, _, np_vars, tm16, _ = mae_quad
    vis, mask = _masks(12)
    config = ConfigDict.from_nested({**PRETRAIN, "model": {**MAE_SMALL, "if_half": True}})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_baseline.PointMAE, "_rand_mask_idx",
                   lambda self, b: (jnp.asarray(vis), jnp.asarray(mask)))
        step = j_runner_pretrain.make_pretrain_step(jm16, _grad_capture(), config)
        new_state, aux = step(_state(_jnp(np_vars)), jnp.asarray(_clouds()),
                              jax.random.key(PRETRAIN_KEY))
    j_grads = state_dict_from_jax({"params": new_state.opt_state,
                                   "batch_stats": np_vars["batch_stats"]}, tm16)
    out, grads, _ = _port_pretrain_step(tm16, (vis, mask), torch.float32)
    np.testing.assert_allclose(out["loss"].item(), float(aux["loss"]), rtol=1e-2)
    norm = np.sqrt(sum(float((g ** 2).sum()) for g in grads.values()))
    j_norm = np.sqrt(sum(float((j_grads[n].double() ** 2).sum()) for n in grads))
    np.testing.assert_allclose(norm, j_norm, rtol=2e-2)


@pytest.mark.parametrize("shape", [((5, 7, 6), (6, 4)), ((2, 3, 5, 6), (2, 3, 6, 4))])
def test_half_matmul_is_jax_bf16_einsum(shape):
    """``half_matmul`` on the CPU equals JAX's bf16 product with float32
    accumulation up to the order of the float32 sums (a weight [K, N] and a
    batched operand), and its gradients are the bf16-rounded products of
    the float32 cotangent (rtol 1e-2: one bf16 step, 7.8e-3, either way)."""
    rng = np.random.default_rng(8)
    a, b = (rng.standard_normal(s).astype(np.float32) for s in shape)

    def j_fn(a, b):
        return jnp.matmul(a.astype(jnp.bfloat16), b.astype(jnp.bfloat16),
                          preferred_element_type=jnp.float32)

    want = j_fn(jnp.asarray(a), jnp.asarray(b))
    ta, tb = torch.tensor(a, requires_grad=True), torch.tensor(b, requires_grad=True)
    got = half_matmul(ta, tb)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    g = rng.standard_normal(got.shape).astype(np.float32)
    j_ga, j_gb = jax.vjp(j_fn, jnp.asarray(a), jnp.asarray(b))[1](jnp.asarray(g))
    got.backward(torch.tensor(g))
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(j_ga), rtol=1e-2, atol=1e-6)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(j_gb), rtol=1e-2, atol=1e-6)
