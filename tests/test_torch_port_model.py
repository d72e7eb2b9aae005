"""The PyTorch port's model (``upp_torch.models``) against the JAX package on
CPU, at a small size, with weights moved by ``upp_torch.weights``.

The JAX variables are random numbers from a seed in the shape of the JAX
model's variables (random BatchNorm statistics too); the same variables go
into the port through ``state_dict_from_jax``. Batch 2, because the
reference's propagation gather makes sample 1 read sample 0's rows. Every
comparison holds at rtol = atol = 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upp_tpu.models import build_model_from_cfg as jax_build
from upp_tpu.train.torch_export import export_torch_state_dict
from upp_tpu.utils.config import ConfigDict
from upp_torch.models import build_model_from_cfg
from upp_torch.ops.group import group_points
from upp_torch.weights import state_dict_from_jax

SMALL = {
    "NAME": "Point_MAE_unify",
    "transformer_config": {
        "mask_ratio": 0.5, "mask_type": "rand", "trans_dim": 48,
        "encoder_dims": 48, "depth": 4, "drop_path_rate": 0.1,
        "num_heads": 4, "decoder_depth": 2, "decoder_num_heads": 4},
    "cls_dim": 5, "group_size": 16, "num_group": 64,
    "prompter_config": {
        "rectify_adapter": True, "rectify_prompts": True,
        "rectify_prompts_num": 2, "rectify_prompts_depth": 2, "rectify_depth": 2,
        "pretask_adapter": True, "pretask_prompts": True,
        "pretask_prompts_num": 2, "pretask_prompts_depth": 3, "pretask_depth": 3,
        "downstream_adapter": True, "downstream_prompts": True,
        "downstream_prompts_num": 3, "downstream_prompts_depth": 2,
        "downstream_depth": 4},
    "gather_idx": False, "prompt_propagation_after": True,
}
POINT_NUM = 256
N_NOISE = 24
TOL = dict(rtol=1e-4, atol=1e-4)


def random_jax_variables(jax_model, point_num, n_in, seed, inputs=None, **init_kw):
    """Seeded random numbers in the shape of ``jax_model``'s variables:
    kernels ~ N(0, 1/fan_in), norm scales ~ 1, running variances in
    [0.5, 1.5], everything else ~ N(0, 0.1). ``init_kw`` are the keyword
    arguments of the model call that creates every variable (the
    classifier's three-pass call by default), ``inputs`` its positional
    arrays (zero clouds [2, n_in, 3] by default); ``point_num`` None leaves
    that keyword out (``Point_MAE`` takes none)."""
    rngs = {"params": jax.random.key(0), "dropout": jax.random.key(1),
            "droppath": jax.random.key(2), "mask": jax.random.key(3)}
    kw = init_kw or dict(completion_prompt=True, denoise=True, deterministic=True)
    if point_num is not None:
        kw = {**kw, "point_num": point_num}
    inputs = (jnp.zeros((2, n_in, 3)),) if inputs is None else inputs
    shapes = jax.eval_shape(lambda: jax_model.init(rngs, *inputs, **kw))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = str(path[-1].key)
        if name.endswith("var"):
            a = rng.uniform(0.5, 1.5, leaf.shape)
        elif name.endswith("scale"):
            a = 1.0 + 0.1 * rng.standard_normal(leaf.shape)
        elif name.endswith("kernel"):
            a = rng.standard_normal(leaf.shape) / np.sqrt(leaf.shape[-2])
        else:
            a = 0.1 * rng.standard_normal(leaf.shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, dict(shapes))


def build_pair(model_cfg, point_num, n_in, seed=0, inputs=None, **init_kw):
    """(JAX model, its variables, the port model holding the same weights)."""
    jm = jax_build(ConfigDict.from_nested(model_cfg))
    variables = random_jax_variables(jm, point_num, n_in, seed, inputs, **init_kw)
    tm = build_model_from_cfg(model_cfg).eval()
    tm.load_state_dict(state_dict_from_jax(variables, tm), strict=True)
    return jm, variables, tm


@pytest.fixture(scope="module")
def pair():
    return build_pair(SMALL, POINT_NUM, POINT_NUM + N_NOISE)


def _pts(n, seed, b=2):
    return np.random.default_rng(seed).standard_normal((b, n, 3)).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_weights_match_torch_export(pair):
    """``state_dict_from_jax`` equals the JAX package's template-driven
    exporter key for key and value for value."""
    _, variables, tm = pair
    mine = state_dict_from_jax(variables, tm)
    theirs, report = export_torch_state_dict(variables, template=tm)
    assert report["missing"] == []
    assert all(k.endswith("num_batches_tracked") for k in report["synthesized"])
    assert set(mine) == set(theirs) == set(tm.state_dict())
    for k, v in mine.items():
        np.testing.assert_array_equal(v.numpy(), theirs[k], err_msg=k)
    tm.load_state_dict({k: torch.tensor(v) for k, v in theirs.items()}, strict=True)


def test_encoder(pair):
    jm, variables, tm = pair
    x = _pts(64 * 16, 1).reshape(2, 64, 16, 3)
    want = jm.apply(variables, jnp.asarray(x),
                    method=lambda m, x: m.core.encoder(x, use_running_average=True))
    with torch.no_grad():
        _close(tm.encoder(torch.tensor(x)), want)


@pytest.mark.parametrize("path", ["rectify", "pretask", "downstream"])
def test_prompted_blocks_per_path(pair, path):
    """Each path's pass through the shared backbone: its prompted blocks
    (with propagation on the downstream path) and the blocks after them."""
    jm, variables, tm = pair
    rng = np.random.default_rng(2)
    cls = path == "downstream"
    g = 64 if cls else 32
    x = rng.standard_normal((2, g + cls, 48)).astype(np.float32)
    pos = rng.standard_normal((2, g + cls, 48)).astype(np.float32)
    t_prop = j_prop = None
    if cls:
        center1 = torch.tensor(_pts(64, 3))
        lvl2 = group_points(center1, 32, 8)
        t_prop = {"center1": center1, "center1_idx": lvl2.idx,
                  "center2": lvl2.center, "center2_idx": lvl2.center_idx}
        j_prop = {k: jnp.asarray(v.numpy()) for k, v in t_prop.items()}
        j_prop.update(gather_idx=False, quirk=True)
    want = jm.apply(variables, jnp.asarray(x), jnp.asarray(pos), method=lambda m, x, p: m.core.blocks(
        x, p, path=path, classification=cls, propagation=j_prop, deterministic=True))
    with torch.no_grad():
        got = tm.blocks(torch.tensor(x), torch.tensor(pos), path=path,
                        classification=cls, propagation=t_prop)
    _close(got, want)


def test_rectify_prompter(pair):
    jm, variables, tm = pair
    x = _pts(POINT_NUM + N_NOISE, 4)
    center1 = x[:, :32] * 0.9
    feats = np.random.default_rng(5).standard_normal((2, 32, 48)).astype(np.float32)
    want = jm.apply(variables, *map(jnp.asarray, (x, center1, feats)),
                    method=lambda m, a, b, c: m.core.rectify_prompter(a, b, c, deterministic=True))
    with torch.no_grad():
        _close(tm.rectify_prompter(*map(torch.tensor, (x, center1, feats))), want)


def test_unify_core_complete(pair):
    jm, variables, tm = pair
    pts = _pts(243, 6)
    want_c, want_r = jm.apply(variables, jnp.asarray(pts),
                              method=lambda m, p: m.core.complete(p, True))
    with torch.no_grad():
        got_c, got_r = tm.complete(torch.tensor(pts))
    _close(got_c, want_c)
    _close(got_r, want_r)


@pytest.mark.parametrize("mode", ["downstream", "denoise", "three_pass"])
def test_point_mae_unify_forward(pair, mode):
    jm, variables, tm = pair
    denoise = mode != "downstream"
    completion = mode == "three_pass"
    pts = _pts(POINT_NUM + (N_NOISE if denoise else 0), 7)
    want = jm.apply(variables, jnp.asarray(pts), completion_prompt=completion,
                    denoise=denoise, point_num=POINT_NUM, deterministic=True)
    with torch.no_grad():
        got = tm(torch.tensor(pts), completion_prompt=completion, denoise=denoise,
                 point_num=POINT_NUM)
    _close(got, want)
    assert np.array_equal(got.argmax(-1).numpy(), np.asarray(want).argmax(-1))


def test_training_mode_and_other_propagations_are_refused(pair):
    """Train mode and the ``gather_idx: True`` / ``clean`` propagations run
    (their parity is in ``test_torch_port_cls_train.py``); an unknown
    ``propagation_semantics`` is still refused."""
    _, _, tm = pair
    state0 = {k: v.clone() for k, v in tm.state_dict().items()}
    tm.train()
    try:
        logits = tm(torch.tensor(_pts(POINT_NUM, 8)), point_num=POINT_NUM)
        logits.sum().backward()
        assert tm.cls_head_finetune[0].weight.grad is not None
    finally:
        tm.zero_grad(set_to_none=True)
        tm.load_state_dict(state0)
        tm.eval()
    assert logits.shape == (2, SMALL["cls_dim"]) and torch.isfinite(logits).all()
    for change in ({"gather_idx": True}, {"propagation_semantics": "clean"}):
        with torch.no_grad():
            out = build_model_from_cfg({**SMALL, **change}).eval()(
                torch.tensor(_pts(POINT_NUM, 8)), point_num=POINT_NUM)
        assert torch.isfinite(out).all()
    with pytest.raises(ValueError, match="propagation_semantics"):
        build_model_from_cfg({**SMALL, "propagation_semantics": "quirky"})
