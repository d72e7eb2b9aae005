"""The legacy prompter-pretraining model ``Point_MAE_pretask``
(``upp_torch.models.pretask_legacy``) against the JAX package on the CPU,
at the size of ``test_torch_port_pretask.py`` (trans_dim 48, depth 3, 64
groups of 8, 128 points plus 52 outliers, batch 2), with weights moved
from seeded random JAX variables by ``upp_torch.weights.state_dict_from_jax``.

The JAX package's ``torch_export``/``torch_ckpt`` know no ``mask_prompter``
key, so the mapping is held by the element count (every JAX leaf used
once) and by forward parity, not by the exporter.

The eval forward holds in float32 at rtol = atol = 1e-4
(``test_torch_port_model.TOL``). Train mode (the noise branch on batch
statistics, the hard drop, the re-tokenised completion branch; the four
loss terms of the pretask step, three Chamfer-L1 terms and the noise loss;
the gradient of their sum for every parameter; the running statistics) is
compared in float64 on both sides, as ``test_torch_port_completion.py``
holds train mode: its ``jax_float64`` fixture lifts the attention einsums'
float32 pins and forces the JAX kNN and Chamfer through their Pallas
kernels in interpret mode, and here the unify core's float32 block and
encoder types and its BatchNorm's float32 statistics are lifted too (a
``jnp`` whose ``float32`` is float64 in ``upp_tpu.models.unify`` and
``upp_tpu.models.layers``, a float64 ``Encoder``). Dropout is off on both
sides, drop-path rate 0. Values hold at rtol = atol = 1e-6, gradients at
rtol 1e-5 with an atol of ``GRAD_SCALE_ATOL`` of each tensor's largest:
the tokens' propagation (k = 8, eps 1e-8) and the mask-token propagation
(k = 6) weigh by inverse kNN distances, which both packages take from the
kNN in float32 (the kernels' arithmetic) and normalise in float32 in
their own order of summation, so about 1e-7 of float32 rounding reaches
every gradient (measured: 1.04e-6 of a tensor's largest at most).
``test_torch_port_completion.py`` holds 1e-7, its models having no such
weights."""

import copy
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_completion import TOL64, _to64, jax_float64  # noqa: F401
from test_torch_port_model import TOL, build_pair
from test_torch_port_pretask import (CONFIG, N_IN, POINT_NUM, REPO, TINY_PT, _noisy_input,
                                     jax_without_dropout, no_dropout)  # noqa: F401
from upp_tpu.models import layers as j_layers
from upp_tpu.models import unify as j_unify
from upp_tpu.ops.chamfer import chamfer_l1 as j_chamfer_l1
from upp_torch.ops.chamfer import chamfer_l1
from upp_torch.weights import state_dict_from_jax

LEGACY = {**TINY_PT, "NAME": "Point_MAE_pretask"}
GRAD_SCALE_ATOL = 5e-6
INIT_KW = dict(train_with_gaussian=True, deterministic=False)


@pytest.fixture(scope="module")
def pair():
    return build_pair(LEGACY, POINT_NUM, N_IN, seed=13, **INIT_KW)


class _Jnp64:
    """``jax.numpy`` with ``float32`` meaning float64."""
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.fixture
def unify_float64(jax_float64, jax_without_dropout, monkeypatch):  # noqa: F811
    monkeypatch.setattr(j_unify, "jnp", _Jnp64())
    monkeypatch.setattr(j_layers, "jnp", _Jnp64())
    monkeypatch.setattr(j_unify, "Encoder",
                        functools.partial(j_layers.Encoder, compute_dtype=jnp.float64))


def test_weights_cover_every_jax_variable(pair):
    """Every port tensor comes from a distinct JAX leaf and no JAX leaf is
    left out (the element counts agree); the head is ``mask_prompter.*``
    beside the core, and there is no ``rectify_prompter``."""
    _, variables, tm = pair
    n_port = sum(v.numel() for k, v in tm.state_dict().items()
                 if not k.endswith("num_batches_tracked"))
    assert n_port == sum(np.asarray(x).size for x in jax.tree_util.tree_leaves(variables))
    keys = set(state_dict_from_jax(variables, tm))
    assert keys == set(tm.state_dict())
    assert "mask_prompter.score_head.3.weight" in keys and "mask_prompter" in variables["params"]
    assert not [k for k in keys if k.startswith("rectify_prompter")]


def test_eval_forward_matches_jax(pair):
    jm, variables, tm = pair
    pts = _noisy_input(5)[:, :POINT_NUM]
    want = jm.apply(variables, jnp.asarray(pts), point_num=POINT_NUM, deterministic=True)
    with torch.no_grad():
        got = tm.eval()(torch.tensor(pts), point_num=POINT_NUM)
    assert got[0].shape == (2, 32, 3) and got[1].shape == (2, 32 * 8, 3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def _terms(out, partial, crop, gt, cd):
    """The pretask step's four loss terms (``runner_pretask``: coarse and
    dense rebuild against the crop, partial + rebuild against the whole
    cloud, the noise loss)."""
    center, rebuild, noise_loss, _ = out
    cat = jnp.concatenate if cd is j_chamfer_l1 else torch.cat
    return (cd(center, crop), cd(rebuild, crop), cd(cat([partial, rebuild], 1), gt),
            noise_loss)


def test_train_step_matches_jax_in_float64(pair, unify_float64):
    """One train-mode forward with noise, the four loss terms, every
    parameter's gradient of their sum, the recall and the running
    statistics."""
    jm, variables, tm = pair
    variables = _to64(variables)
    pts = _noisy_input(6).astype(np.float64)
    rng = np.random.default_rng(7)
    crop = rng.standard_normal((2, 64, 3))
    gt = rng.standard_normal((2, 256, 3))

    def loss(params):
        out, new = jm.apply({**variables, "params": params}, jnp.asarray(pts),
                            point_num=POINT_NUM, deterministic=False,
                            mutable=["batch_stats"])
        terms = _terms(out, jnp.asarray(pts[:, :POINT_NUM]), jnp.asarray(crop),
                       jnp.asarray(gt), j_chamfer_l1)
        return sum(terms), (out, terms, new["batch_stats"])

    (_, (w_out, w_terms, new_stats)), grads = jax.jit(
        jax.value_and_grad(loss, has_aux=True))(variables["params"])
    model = no_dropout(copy.deepcopy(tm).double()).train()
    model.load_state_dict(state_dict_from_jax(variables, model), strict=True)
    out = model(torch.tensor(pts), point_num=POINT_NUM)
    terms = _terms(out, torch.tensor(pts[:, :POINT_NUM]), torch.tensor(crop),
                   torch.tensor(gt), chamfer_l1)
    sum(terms).backward()
    for g, w in zip(tuple(out) + terms, tuple(w_out) + tuple(w_terms)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL64)
    assert 0.0 < float(out[3]) < 1.0
    want = state_dict_from_jax({"params": grads, "batch_stats": variables["batch_stats"]},
                               model)
    top = max(float(np.abs(w.numpy()).max()) for w in want.values())
    for name, p in model.named_parameters():
        g = np.zeros(p.shape) if p.grad is None else p.grad.numpy()   # unused: 0
        w, scale = want[name].numpy(), float(np.abs(want[name].numpy()).max())
        if scale < 1e-6 * top:       # zero in exact arithmetic (a bias before a BatchNorm)
            assert float(np.abs(g).max()) < 1e-6 * top, name
            continue
        np.testing.assert_allclose(g, w, rtol=1e-5,
                                   atol=GRAD_SCALE_ATOL * scale, err_msg=name)
    want = state_dict_from_jax({"params": variables["params"], "batch_stats": new_stats}, model)
    running = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert running
    for k in running:
        np.testing.assert_allclose(model.state_dict()[k].numpy(), want[k].numpy(), **TOL64,
                                   err_msg=k)


def test_cli_trains_and_tests_on_cpu(tmp_path, monkeypatch):
    """``python -m upp_torch.main`` trains the legacy model through the
    pretask runner for one epoch (the four-tuple of its train mode) and
    ``--test`` evaluates it; its checkpoint holds ``mask_prompter.*``."""
    import yaml
    from upp_torch.main import main
    monkeypatch.chdir(tmp_path)
    paths = {}
    for name in ("legacy_train", "legacy_test"):
        cfg = yaml.safe_load(open(REPO / "cfgs/pretask_synthetic.yaml"))
        for split in ("train", "val", "test"):
            cfg["dataset"][split]["_base_"] = CONFIG["dataset"][split]["_base_"]
        cfg.update(model=LEGACY, npoints=POINT_NUM, total_bs=2, max_epoch=0)
        paths[name] = tmp_path / f"{name}.yaml"
        paths[name].write_text(yaml.safe_dump(cfg))
    best = main(["--config", str(paths["legacy_train"]), "--device", "cpu"])
    assert np.isfinite(best.cd)
    (last,) = tmp_path.glob("experiments/legacy_train/**/ckpt-last.pth")
    saved = torch.load(last, map_location="cpu", weights_only=True)["base_model"]
    assert "mask_prompter.score_head.0.weight" in saved
    assert not [k for k in saved if k.startswith("rectify_prompter")]
    cd = main(["--test", "--config", str(paths["legacy_test"]), "--device", "cpu",
               "--ckpts", str(last)])
    assert np.isfinite(cd.cd)
    (log,) = tmp_path.glob("experiments/legacy_test/**/legacy_test.log")
    text = log.read_text()
    assert "TEST RESULTS" in text and "missing_keys" not in text


def test_legacy_model_is_built_by_name():
    """``runner_cls.init_model`` builds ``Point_MAE_pretask`` from a config
    that names it (the port refused it before it had it)."""
    from upp_torch.train import runner_cls
    from upp_torch.utils.config import ConfigDict
    config = ConfigDict.from_nested({"model": LEGACY})
    model = runner_cls.init_model(types.SimpleNamespace(seed=0), config, torch.device("cpu"))
    assert type(model).__name__ == "PointMAEPretaskLegacy"
