"""The port's classification model in train mode against the JAX package
on CPU, at a small size: ``PointMAEUnify`` in train mode in all three
propagation modes (logits and every updated BatchNorm running statistic),
and the propagation's BatchNorm on batch statistics. One train step of each
package is compared in ``test_torch_port_cls_step.py``.

Train mode is compared with dropout off on both sides and drop-path rate 0
(the two packages draw from different generators). Forward values hold at
rtol = atol = 1e-4. Batch 4, not 2 (the reference's propagation gather
makes sample b read sample b-1's rows at any batch): at batch 2 the JAX
package's one-pass BatchNorm variance (E[x^2] - E[x]^2) in the head's train
mode sits 2.3e-4 from a float64 run, the port's 3.7e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_model import SMALL, TOL, build_pair
from test_torch_port_pretask import jax_without_dropout, no_dropout  # noqa: F401
from upp_torch.models.layers import batch_norm_last
from upp_torch.weights import state_dict_from_jax

NPOINTS = 256
N_IN = NPOINTS + 72
B = 4
SMALL_TRAIN = {**SMALL, "transformer_config": {**SMALL["transformer_config"],
                                               "drop_path_rate": 0.0}}
MODES = {"reference": {},
         "gather_idx": {"gather_idx": True},
         "clean": {"propagation_semantics": "clean"}}
@pytest.fixture(scope="module", params=list(MODES))
def mode_pair(request):
    return build_pair({**SMALL_TRAIN, **MODES[request.param]}, NPOINTS, N_IN, seed=4)


@pytest.fixture(scope="module")
def pair():
    return build_pair(SMALL_TRAIN, NPOINTS, N_IN, seed=5)


def _noisy_input(seed):
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((B, NPOINTS, 3)).astype(np.float32) * 0.5
    noise = rng.standard_normal((B, 72, 3)).astype(np.float32) * 1.4
    return np.concatenate([pts, noise], 1)


def _running(state):
    return [k for k in state if k.endswith(("running_mean", "running_var"))]


def test_train_forward_matches_jax(mode_pair, jax_without_dropout):
    """Logits of one train-mode three-pass forward and every running
    statistic it updates: the encoder's once per pass, in order, the
    prompter's, the head's and the propagation's ``bnorm``."""
    jm, variables, tm = mode_pair
    pts = _noisy_input(6)
    want, mut = jm.apply(_jnp(variables), jnp.asarray(pts), completion_prompt=True, denoise=True,
                         point_num=NPOINTS, deterministic=False, mutable=["batch_stats"],
                         rngs={"dropout": jax.random.key(9), "droppath": jax.random.key(8)})
    state0 = {k: v.clone() for k, v in tm.state_dict().items()}
    no_dropout(tm).train()
    try:
        with torch.no_grad():
            got = tm(torch.tensor(pts), completion_prompt=True, denoise=True,
                     point_num=NPOINTS)
        after = {k: v.clone() for k, v in tm.state_dict().items()}
    finally:
        tm.load_state_dict(state0)
        tm.eval()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want_stats = state_dict_from_jax({"params": variables["params"],
                                      "batch_stats": mut["batch_stats"]}, tm)
    running = _running(after)
    moved = [k for k in running if not torch.equal(after[k], state0[k])]
    assert any("bnorm" in k for k in moved) and any("cls_head_finetune" in k for k in moved)
    assert any("encoder" in k for k in moved) and any("rectify_prompter" in k for k in moved)
    for k in running:
        np.testing.assert_allclose(after[k].numpy(), want_stats[k].numpy(), err_msg=k, **TOL)


def test_propagation_bnorm_folds_the_unbiased_variance(pair):
    """In ``.train()`` the propagation's ``bnorm`` normalises with the
    batch's biased variance and folds the unbiased one into its running
    average (momentum 0.1), as torch's BatchNorm and the JAX package's
    ``_propagate`` (``scan_blocks.py:450-463``) do."""
    _, _, tm = pair
    bn = tm.blocks.blocks[0].bnorm
    state0 = {k: v.clone() for k, v in bn.state_dict().items()}
    x = torch.tensor(np.random.default_rng(7).standard_normal((2, 32, 8, 48)),
                     dtype=torch.float32)
    flat = x.reshape(-1, 48)
    bn.train()
    try:
        y = batch_norm_last(bn, x)
        mean, var = flat.mean(0), flat.var(0, unbiased=False)
        n = flat.shape[0]
        torch.testing.assert_close(bn.running_mean, 0.9 * state0["running_mean"] + 0.1 * mean)
        torch.testing.assert_close(bn.running_var,
                                   0.9 * state0["running_var"] + 0.1 * var * n / (n - 1))
        want = (flat - mean) / torch.sqrt(var + 1e-5) * bn.weight + bn.bias
        torch.testing.assert_close(y.reshape(-1, 48), want.detach(), rtol=1e-5, atol=1e-5)
    finally:
        bn.load_state_dict(state0)
        bn.eval()


def _jnp(variables):
    """The variables as JAX arrays (the stacked BatchNorm statistics are
    updated with ``.at``)."""
    return jax.tree_util.tree_map(jnp.asarray, variables)
