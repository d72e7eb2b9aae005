"""The port's completion family (``upp_torch.models.pointr``, ``adapointr``
and ``deform_attn``) against the JAX package on the CPU, at a small size
(embed 48, depth 2, ``num_query`` 32, 640-point partial clouds, a 1024-point
ground truth), with weights moved from seeded random JAX variables by
``upp_torch.weights.state_dict_from_jax`` and loaded strictly.

Eval mode, the loss terms and the blocks run in float32 and hold at rtol =
atol = 1e-4, the bound of ``test_torch_port_model.TOL``; the blocks' input
gradients per element at rtol 1e-3 with an atol of 1e-6 plus
``GRAD_SCALE_ATOL`` of the tensor's largest.

Train mode (one forward on the BatchNorms' batch statistics, the loss
terms, every parameter's gradient, the running statistics) is compared in
float64 on both sides, at rtol = atol = 1e-6 for values and, for
gradients, rtol 1e-5 with an atol of 1e-7 of the tensor's largest (both
measured within 2.1e-9 and 9e-10). In float32 these random-weight models
are ill-conditioned: every query carries the same broadcast 1024-wide
global feature, so the rows a BatchNorm or a max-pool sees nearly coincide
(mean^2 / var up to 8.4e4 at PoinTr's ``increase_dim``; a top-2 gap of
4e-7 in AdaPoinTr's rebuild max-pool), and the port's own float32 result
sits 1.9e-4 from its float64 one. For the float64 call the JAX package's
float32 pins are lifted (its attention einsums' ``preferred_element_type``,
its BatchNorm's float32 one-pass statistics) and its FPS, kNN and Chamfer
choices go through its Pallas kernels in interpret mode, as its own kernel
tests run them on the CPU: the discrete choices are made in float32 by the
same arithmetic on both sides. The JAX AdaPoinTr's denoise draw is
replaced, for the call, by the numpy noise the port is given. In float32
the JAX CPU path ranks kNN neighbours by the matmul form of the distance,
the port by the difference form: ``test_knn_call_sites`` holds every call
site's neighbour sets on the test inputs."""

import copy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

sys.path.insert(0, str(Path(__file__).parent))

from test_torch_port_model import TOL, random_jax_variables  # noqa: E402
from upp_tpu.models import build_model_from_cfg as jax_build  # noqa: E402
from upp_tpu.models import pointr as j_pointr  # noqa: E402
from upp_tpu.models.layers import TorchBatchNorm  # noqa: E402
from upp_tpu.models import deform_attn as j_deform  # noqa: E402
from upp_tpu.models.adapointr import DynamicGraphAttention as JDynamicGraph  # noqa: E402
from upp_tpu.ops.fps import _fps_xla  # noqa: E402
from upp_tpu.ops.knn import knn as jax_knn  # noqa: E402
from upp_tpu.utils.config import ConfigDict  # noqa: E402
from upp_torch.models import adapointr, build_model_from_cfg, deform_attn, pointr  # noqa: E402
from upp_torch.ops.fps import fps_plain_idx  # noqa: E402
from upp_torch.weights import state_dict_from_jax  # noqa: E402

GRAD_SCALE_ATOL = 5e-5
TOL64 = dict(rtol=1e-6, atol=1e-6)
B, N_IN, N_GT = 2, 640, 1024
POINTR = {"NAME": "PoinTr", "trans_dim": 48, "num_pred": 512, "num_query": 32,
          "knn_layer": 1}
ADA = {"NAME": "AdaPoinTr", "num_query": 32, "num_points": 256, "decoder_type": "fc",
       "encoder_config": {"embed_dim": 48, "depth": 2},
       "decoder_config": {"embed_dim": 48, "depth": 2}}
# every local style and both combine modes (rw_deform only where no denoise
# split reaches it: the encoder)
ADA_STYLES = {"NAME": "AdaPoinTr", "num_query": 32, "num_points": 256, "decoder_type": "fc",
              "encoder_config": {"embed_dim": 48, "depth": 2,
                                 "block_style_list": ["attn-rw_deform", "graph"],
                                 "combine_style": "concat"},
              "decoder_config": {"embed_dim": 48, "depth": 3,
                                 "self_attn_block_style_list":
                                     ["attn-deform", "attn-deform_graph", "attn-graph"],
                                 "self_attn_combine_style": "onebyone",
                                 "cross_attn_block_style_list":
                                     ["attn-deform_graph", "deform", "attn-graph"],
                                 "cross_attn_combine_style": "concat"}}


class TwoPassBatchNorm(TorchBatchNorm):
    """``TorchBatchNorm`` whose train mode computes its statistics in the
    input's type with the two-pass variance (the JAX one casts to float32
    and takes E[x^2] - E[x]^2)."""

    @fnn.compact
    def __call__(self, x):
        if self.use_running_average:
            return super().__call__(x)
        feat = x.shape[-1]
        scale = self.param("scale", fnn.initializers.ones, (feat,))
        bias = self.param("bias", fnn.initializers.zeros, (feat,))
        ra_mean = self.variable("batch_stats", "mean", lambda: jnp.zeros((feat,)))
        ra_var = self.variable("batch_stats", "var", lambda: jnp.ones((feat,)))
        red = tuple(range(x.ndim - 1))
        mean, var = jnp.mean(x, axis=red), jnp.var(x, axis=red)
        n = int(np.prod([x.shape[d] for d in red]))
        if not self.is_initializing():
            ra_mean.value = self.momentum * ra_mean.value + (1.0 - self.momentum) * mean
            ra_var.value = (self.momentum * ra_var.value
                            + (1.0 - self.momentum) * var * (n / max(n - 1, 1)))
        return (x - mean) * jax.lax.rsqrt(var + self.epsilon) * scale + bias


@pytest.fixture
def jax_float64(monkeypatch):
    """The JAX package in float64 for a test (see the module docstring),
    its Pallas kernels forced (interpret mode on the CPU)."""
    einsum = jnp.einsum

    def einsum64(*args, preferred_element_type=None, **kw):
        if (preferred_element_type == jnp.float32 and "precision" not in kw
                and any(getattr(a, "dtype", None) == jnp.float64 for a in args[1:])):
            preferred_element_type = None
        return einsum(*args, preferred_element_type=preferred_element_type, **kw)

    monkeypatch.setattr(jnp, "einsum", einsum64)
    monkeypatch.setattr(j_pointr, "TorchBatchNorm", TwoPassBatchNorm)
    monkeypatch.setenv("UPP_FORCE_PALLAS_KNN", "1")
    monkeypatch.setenv("UPP_FORCE_PALLAS_CHAMFER", "1")
    jax.clear_caches()
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)
        jax.clear_caches()


def _pts(seed, b=B, n=N_IN):
    return np.random.default_rng(seed).standard_normal((b, n, 3)).astype(np.float32)


def _build(cfg, seed):
    """(JAX model, seeded random variables, the port model holding them).
    The coarse head's last layer is scaled by 0.1, so the predicted centres
    lie at the input cloud's scale, as a trained model's do: at the random
    weights' own scale they land ~14 units out, where every key of a
    centre's kNN is nearly equidistant and the two packages' float32
    rounding of the centres (1e-5) swaps the k-th and (k+1)-th neighbour."""
    jm = jax_build(ConfigDict.from_nested(cfg))
    variables = random_jax_variables(jm, None, N_IN, seed, inputs=(jnp.zeros((B, N_IN, 3)),),
                                     deterministic=False)
    base = variables["params"]["base_model"]
    head = base["coarse_pred1"] if "coarse_pred1" in base else base["coarse_pred"]["lin1"]
    for leaf in ("kernel", "bias"):
        head[leaf] = head[leaf] * np.float32(0.1)
    tm = build_model_from_cfg(cfg).eval()
    tm.load_state_dict(state_dict_from_jax(variables, tm), strict=True)
    return jm, variables, tm


@pytest.fixture(scope="module")
def pointr_pair():
    return _build(POINTR, 0)


@pytest.fixture(scope="module")
def ada_pair():
    return _build(ADA, 1)


@pytest.fixture(scope="module")
def styles_pair():
    return _build(ADA_STYLES, 2)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def _jax_train(jm, variables, pts, gt, noise=None):
    """The JAX model's train-mode (outputs, updated batch_stats, loss
    terms, gradients of the terms' sum wrt params), jitted, its denoise draw
    replaced by ``noise`` while it is traced."""
    def loss(params, pts, gt):
        out, new = jm.apply({**variables, "params": params}, pts,
                            deterministic=False, rngs={"denoise": jax.random.key(0)},
                            mutable=["batch_stats"])
        if isinstance(out, tuple) and len(out) == 4:
            terms = jm.apply({**variables, "params": params}, out, gt, method="get_loss")
        else:
            terms = jm.get_loss(out, gt)
        return terms[0] + terms[1], (out, new["batch_stats"], terms)

    def fixed(key, shape, dtype=jnp.float32):
        assert tuple(shape) == noise.shape, shape
        return jnp.asarray(noise, dtype)

    orig = jax.random.normal
    jax.random.normal = fixed
    try:
        (_, (out, stats, terms)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            variables["params"], jnp.asarray(pts), jnp.asarray(gt))
    finally:
        jax.random.normal = orig
    return out, stats, terms, grads


def _check_grads(model, variables, grads):
    """Every parameter's gradient against JAX's, moved into the port's
    layout by the weight mapping (float64). A tensor whose JAX gradient
    stays below 1e-6 of the largest is zero in exact arithmetic (a bias
    before a train-mode BatchNorm, or one whose constant shift a later
    BatchNorm removes; the query ranking, which only orders): the port's
    must stay below that too (no gradient counts as 0)."""
    want = state_dict_from_jax({"params": grads,
                                "batch_stats": variables.get("batch_stats", {})}, model)
    top = max(float(np.abs(w.numpy()).max()) for w in want.values())
    for name, p in model.named_parameters():
        g = np.zeros(p.shape) if p.grad is None else p.grad.numpy()
        w = want[name].numpy()
        scale = float(np.abs(w).max())
        if scale < 1e-6 * top:
            assert float(np.abs(g).max()) < 1e-6 * top, name
            continue
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7 * scale, err_msg=name)


def _train_run(tm, variables, pts, gt, noise=None):
    """A float64 copy of the port model in train mode, after one forward
    (outputs and loss terms returned) and the backward of the terms' sum."""
    model = copy.deepcopy(tm).double().train()
    model.load_state_dict(state_dict_from_jax(variables, model), strict=True)
    kw = {} if noise is None else {"denoise_noise": torch.tensor(noise)}
    out = model(torch.tensor(pts), **kw)
    terms = model.get_loss(out, torch.tensor(gt))
    (terms[0] + terms[1]).backward()
    return model, out, terms


def _to64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def _check_running_stats(model, new_stats):
    """The running statistics after one train-mode forward equal JAX's."""
    stats = {k: v for k, v in model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    assert stats
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(dict(new_stats))[0]}
    for key, val in stats.items():
        mod, _, leaf = key.rpartition(".")
        path = mod.replace(".", "/") + ("/mean" if leaf == "running_mean" else "/var")
        np.testing.assert_allclose(val.numpy(), flat[path], **TOL64, err_msg=key)


def test_fps_past_the_cloud_matches_jax():
    """The grouper asks FPS for 512 samples whatever N is: past N the JAX
    loop keeps choosing index 0 (every distance is 0, argmax takes the
    first), and so does ``fps_plain_idx``."""
    xyz = _pts(3, n=300)
    want = np.asarray(_fps_xla(jnp.asarray(xyz), 512)[1])
    got = fps_plain_idx(torch.tensor(xyz), 512).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[:, 300:] == 0).all()


def test_weights_cover_every_jax_variable(pointr_pair, ada_pair, styles_pair):
    """``state_dict_from_jax`` fills every port tensor from a distinct JAX
    leaf and leaves no JAX leaf out (the element counts agree)."""
    for _, variables, tm in (pointr_pair, ada_pair, styles_pair):
        n_port = sum(v.numel() for k, v in tm.state_dict().items()
                     if not k.endswith("num_batches_tracked"))
        n_jax = sum(np.asarray(x).size for x in jax.tree_util.tree_leaves(variables))
        assert n_port == n_jax
        assert set(state_dict_from_jax(variables, tm)) == set(tm.state_dict())


def test_pointr_eval_and_loss(pointr_pair):
    jm, variables, tm = pointr_pair
    pts, gt = _pts(4), _pts(5, n=N_GT)
    want = jax.jit(lambda v, x: jm.apply(v, x, deterministic=True))(variables, jnp.asarray(pts))
    with torch.no_grad():
        got = tm(torch.tensor(pts))
    assert got[0].shape == (B, 64, 3) and got[1].shape == (B, 32 * 16 + N_IN, 3)
    for g, w in zip(got, want):
        _close(g, w)
    with torch.no_grad():
        terms = tm.get_loss(got, torch.tensor(gt))
    for g, w in zip(terms, jm.get_loss(want, jnp.asarray(gt))):
        _close(g, w)


def test_pointr_train_step_gradients(pointr_pair, jax_float64):
    """One train-mode forward (batch statistics), the two loss terms, the
    gradient of their sum for every parameter, the running statistics."""
    jm, variables, tm = pointr_pair
    variables = _to64(variables)
    pts, gt = _pts(6).astype(np.float64), _pts(7, n=N_GT).astype(np.float64)
    want, new_stats, terms_w, grads = _jax_train(jm, variables, pts, gt)
    model, out, terms = _train_run(tm, variables, pts, gt)
    for g, w in zip(out + terms, tuple(want) + tuple(terms_w)):
        _close(g, w, TOL64)
    _check_grads(model, variables, grads)
    _check_running_stats(model, new_stats)


@pytest.mark.parametrize("which", ["ada", "styles"])
def test_adapointr_eval(which, ada_pair, styles_pair):
    """Eval outputs (coarse, rebuild) in float32."""
    jm, variables, tm = ada_pair if which == "ada" else styles_pair
    pts = _pts(8)
    want = jax.jit(lambda v, x: jm.apply(v, x, deterministic=True))(variables, jnp.asarray(pts))
    with torch.no_grad():
        got = tm(torch.tensor(pts))
    assert got[0].shape == (B, 32, 3) and got[1].shape == (B, 256, 3)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("which", ["ada", "styles"])
def test_adapointr_train_step_gradients(which, ada_pair, styles_pair, jax_float64):
    """Train outputs (pred_coarse, denoised_coarse, denoised_fine, pred_fine)
    from the same denoise draw, the loss terms, every parameter's gradient,
    the running statistics. ``styles`` runs every local block style
    (rw_deform, deform, deform_graph, graph) in both combine modes, with the
    denoise split in the decoder; each deform block's offset MLP gets a
    gradient."""
    jm, variables, tm = ada_pair if which == "ada" else styles_pair
    variables = _to64(variables)
    pts, gt = _pts(8).astype(np.float64), _pts(9, n=N_GT).astype(np.float64)
    noise = np.random.default_rng(10).standard_normal((B, 64, 3))
    want, new_stats, terms_w, grads = _jax_train(jm, variables, pts, gt, noise)
    model, out, terms = _train_run(tm, variables, pts, gt, noise)
    assert [tuple(o.shape) for o in out] == [(B, 32, 3), (B, 64, 3), (B, 64 * 8, 3),
                                             (B, 32 * 8, 3)]
    for g, w in zip(out + terms, tuple(want) + tuple(terms_w)):
        _close(g, w, TOL64)
    _check_grads(model, variables, grads)
    _check_running_stats(model, new_stats)
    if which == "styles":
        moved = [n for n, p in model.named_parameters()
                 if "linear_offset" in n and p.grad is not None and p.grad.abs().sum() > 0]
        assert len(moved) == 5 * 5     # 5 deform blocks x (lin0 w, b, norm w, b, lin1 w)


def test_adapointr_draws_its_own_denoise_noise(ada_pair):
    """Without ``denoise_noise`` the draw comes from the generator: the same
    seed gives the same outputs, another seed other denoise queries."""
    _, _, tm = ada_pair
    pts = torch.tensor(_pts(11))
    tm.train()
    try:
        with torch.no_grad():
            a = tm(pts, generator=torch.Generator().manual_seed(1))
            b = tm(pts, generator=torch.Generator().manual_seed(1))
            c = tm(pts, generator=torch.Generator().manual_seed(2))
    finally:
        tm.eval()
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert torch.equal(a[0], c[0]) and not torch.equal(a[1], c[1])


def _block_vars(module, seed, *args, **kw):
    shapes = jax.eval_shape(lambda: module.init(jax.random.key(0), *args, **kw))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = str(path[-1].key)
        if name == "scale":
            a = 1.0 + 0.1 * rng.standard_normal(leaf.shape)
        elif name == "kernel":
            a = rng.standard_normal(leaf.shape) / np.sqrt(leaf.shape[-2])
        else:
            a = 0.1 * rng.standard_normal(leaf.shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, dict(shapes))


DIM, HEADS, NQ, NV = 48, 6, 40, 56


@pytest.mark.parametrize("block, cross, denoise", [
    ("rw_deform", False, None),
    ("deform", False, None), ("deform", False, 8), ("deform", True, None),
    ("deform_graph", False, None), ("deform_graph", False, 8), ("deform_graph", True, None),
    ("graph", False, 8),
])
def test_block_against_jax(block, cross, denoise):
    """Each deformable block (and the graph block's denoise split) against
    its JAX module: outputs, and the gradients to its inputs."""
    q_pos = _pts(21, n=NQ)
    q = np.random.default_rng(22).standard_normal((B, NQ, DIM)).astype(np.float32)
    v = np.random.default_rng(23).standard_normal((B, NV, DIM)).astype(np.float32)
    v_pos = _pts(24, n=NV)
    jmod, tmod = {
        "rw_deform": (j_deform.DeformableLocalAttention(DIM, HEADS),
                      deform_attn.DeformableLocalAttention(DIM, HEADS)),
        "deform": (j_deform.DeformableLocalCrossAttention(DIM, HEADS),
                   deform_attn.DeformableLocalCrossAttention(DIM, HEADS)),
        "deform_graph": (j_deform.DeformableGraphAttention(DIM),
                         deform_attn.DeformableGraphAttention(DIM)),
        "graph": (JDynamicGraph(DIM), adapointr.DynamicGraphAttention(DIM)),
    }[block]
    kw = {"v": v, "v_pos": v_pos} if cross else {}
    if denoise:
        kw["denoise_length"] = denoise
    args = (q, q_pos)
    variables = _block_vars(jmod, 25, *map(jnp.asarray, args),
                            **{k: (jnp.asarray(x) if isinstance(x, np.ndarray) else x)
                               for k, x in kw.items()})
    tmod.load_state_dict(state_dict_from_jax(variables, tmod), strict=True)

    static = {k: x for k, x in kw.items() if not isinstance(x, np.ndarray)}

    def jloss(q, q_pos, arrays, variables):
        out = jmod.apply(variables, q, q_pos, **arrays, **static)
        return (out * out).sum(), out

    arrays = {k: jnp.asarray(x) for k, x in kw.items() if isinstance(x, np.ndarray)}
    (_, want), jgrads = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        jnp.asarray(q), jnp.asarray(q_pos), arrays, variables)
    tq = torch.tensor(q, requires_grad=True)
    tp = torch.tensor(q_pos, requires_grad=True)
    tkw = {k: (torch.tensor(x) if isinstance(x, np.ndarray) else x) for k, x in kw.items()}
    got = tmod(tq, tp, **tkw)
    (got * got).sum().backward()
    _close(got, want)
    for t, w in zip((tq, tp), jgrads):
        # positions that only choose neighbours get no gradient (JAX: zeros)
        g = torch.zeros_like(t) if t.grad is None else t.grad
        scale = float(np.abs(np.asarray(w)).max())
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3,
                                   atol=1e-6 + GRAD_SCALE_ATOL * scale)


def test_three_interpolate_and_masked_knn_ties():
    """Ties go to the lowest index, as ``lax.top_k``: positions on a grid
    with repeats, the 3-NN weights and the denoise-masked kNN indices."""
    rng = np.random.default_rng(30)
    v_pos = (rng.integers(-2, 3, (B, 24, 3)) / 2.0).astype(np.float32)
    v_pos[:, 12:] = v_pos[:, :12]
    q_pos = (rng.integers(-2, 3, (B, 16, 3)) / 2.0).astype(np.float32)
    v = rng.standard_normal((B, 24, 8)).astype(np.float32)
    want = j_deform.three_interpolate(jnp.asarray(q_pos), jnp.asarray(v_pos), jnp.asarray(v))
    got = deform_attn.three_interpolate(torch.tensor(q_pos), torch.tensor(v_pos),
                                        torch.tensor(v))
    _close(got, want)
    pos = np.concatenate([q_pos, v_pos], 1)
    want_i = j_deform._knn_idx(jnp.asarray(pos), jnp.asarray(pos), 6, denoise_length=10)
    got_i = deform_attn._knn_idx(torch.tensor(pos), torch.tensor(pos), 6, denoise_length=10)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


def test_knn_call_sites(pointr_pair, styles_pair, monkeypatch):
    """Every kNN call of the two models' train-mode forward and loss on the
    test inputs picks the neighbours (as sets) that the JAX package's knn
    picks on the same arrays."""
    from upp_torch.ops import knn as knn_mod
    calls = []
    orig = knn_mod.knn

    def recording(query, points, k):
        out = orig(query, points, k)
        calls.append((query.detach().numpy(), points.detach().numpy(), k, out[1].numpy()))
        return out

    for mod in (pointr, adapointr, deform_attn):
        monkeypatch.setattr(mod, "knn", recording)
    pts, gt = _pts(12), _pts(13, n=N_GT)
    noise = np.random.default_rng(14).standard_normal((B, 64, 3)).astype(np.float32)
    with torch.no_grad():
        for (_, _, tm), kw in ((pointr_pair, {}),
                               (styles_pair, {"denoise_noise": torch.tensor(noise)})):
            tm.train()
            try:
                out = tm(torch.tensor(pts), **kw)
                if kw:
                    tm.get_loss(out, torch.tensor(gt))
            finally:
                tm.eval()
    assert len(calls) >= 12
    for query, points, k, idx in calls:
        want = np.asarray(jax_knn(jnp.asarray(query), jnp.asarray(points), k)[1])
        np.testing.assert_array_equal(np.sort(idx, -1), np.sort(want, -1),
                                      err_msg=f"kNN k={k} {query.shape} -> {points.shape}")


def test_style_keys_reach_the_blocks():
    """The config's style lists and combine modes select the blocks (as
    ``tests/test_deform_attn.py::test_adapointr_config_style_keys_reach_blocks``
    holds the JAX model to)."""
    tm = build_model_from_cfg(ADA_STYLES)
    names = {n for n, _ in tm.named_modules()}
    enc0, dec0, dec1 = (tm.base_model.encoder0, tm.base_model.decoder0,
                        tm.base_model.decoder1)
    assert isinstance(enc0.local_attn, deform_attn.DeformableLocalAttention)
    assert "base_model.encoder0.merge_map" in names
    assert "base_model.encoder1.merge_map" not in names           # plain graph block
    assert "base_model.encoder1.attn" not in names
    assert isinstance(dec0.local_self_attn, deform_attn.DeformableLocalCrossAttention)
    assert "base_model.decoder0.norm3" in names                   # onebyone self
    assert "base_model.decoder0.self_attn_merge_map" not in names
    assert isinstance(dec0.local_cross_attn, deform_attn.DeformableGraphAttention)
    assert "base_model.decoder0.cross_attn_merge_map" in names    # concat cross
    assert isinstance(dec1.local_cross_attn, deform_attn.DeformableLocalCrossAttention)
    assert "base_model.decoder1.cross_attn" not in names          # 'deform' alone
    assert isinstance(dec1.local_self_attn, deform_attn.DeformableGraphAttention)
    with pytest.raises(ValueError):
        adapointr.CrossAttnBlock(DIM, HEADS, cross_style="attn-rw_deform")
    with pytest.raises(ValueError):
        adapointr.SelfAttnBlock(DIM, HEADS, block_style="attn-conv")
