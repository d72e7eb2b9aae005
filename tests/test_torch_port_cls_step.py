"""One ``make_train_step`` of the port and of the JAX package on CPU, at a
small size, on the same clouds, labels and JAX draws, with the PEFT and the
joint trainable sets: loss, accuracy and every trainable gradient (the
model, batch and dropout-off setting of ``test_torch_port_cls_train.py``).

The JAX train step runs op by op (``jax.disable_jit``): jitted, its
train-mode rectification scores sit 8.7e-5 from a float64 run (op by op
1.6e-5, the port 7.0e-6), which reorders near-tied scores at the top-5%
drop and so changes which points the later passes see.

Gradients are held to JAX's alone, per element, per tensor (relative
norm, so a small tensor cannot hide under the whole) and as a whole, for
the port's float32 step and for its float64 step alike. JAX's float32
gradients are themselves 1.1e-4 to 1.6e-4 (per tensor, relative norm) from
the port's float64 step at this size, above the per-element 5e-5 of the
tensor's largest gradient of ``test_torch_port_pretask.py``. PEFT set: per element rtol 1e-3
with an atol of 1e-6 plus 2e-4 of the tensor's largest gradient, 5e-4 per
tensor, 1e-4 as a whole. Joint set: the gradients cross the
input-coordinate gradients of three passes, where float32 rounding costs
the port up to 1.3e-3 of a rectify prompter tensor's norm against JAX
(measured at this size): per element rtol 1e-2 with an atol of 1e-6 plus
5e-3 of the tensor's largest gradient, 5e-3 per tensor, 2e-3 as a whole. A
gradient that is exactly zero (a bias right before a train-mode BatchNorm)
or vanishing (below 1e-6 of the largest, in the float64 step) is held at
noise level in both packages."""

import copy
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from test_torch_port_cls_train import B, N_IN, NPOINTS, SMALL_TRAIN, _jnp
from test_torch_port_model import TOL, build_pair
from test_torch_port_pretask import GRAD_SCALE_ATOL, _grad_capture, no_dropout
from test_torch_port_slice import _jax_draws, _synthetic
from upp_tpu.models import scan_blocks as j_scan_blocks
from upp_tpu.train.runner_cls import make_train_step as j_make_train_step
from upp_tpu.train.state import TrainState
from upp_tpu.utils.config import ConfigDict
from upp_torch.train import optim, runner_cls
from upp_torch.train.runner_cls import JOINT_PEFT_LIST, PEFT_LIST
from upp_torch.weights import state_dict_from_jax

CONFIG = {
    "optimizer": {"type": "AdamW", "kwargs": {"lr": 5e-4, "weight_decay": 0.05}},
    "scheduler": {"type": "CosLR", "kwargs": {"epochs": 4, "initial_epochs": 1}},
    "dataset": {split: {"_base_": {"NAME": "Synthetic", "N_POINTS": 1024,
                                   "NUM_CATEGORY": 5, "SIZE": 4},
                        "others": {"subset": "train"}} for split in ("train", "val", "test")},
    "npoints": NPOINTS, "noisy_train": True,
    "data_augmentation": "scale-translate",
}
ARGS = types.SimpleNamespace(noise=True, noise_type=["gaussian_noise", "lidar_noise"],
                             incomplete_cropping=True, normalize=False, seed=0)


@pytest.fixture(scope="module")
def pair():
    return build_pair(SMALL_TRAIN, NPOINTS, N_IN, seed=5)


AUG = "scale-translate"
LABELS = np.array([3, 1, 0, 4], np.int32)
# per stage: per-element atol 1e-6 + scale x the tensor's largest gradient,
# per-element rtol, the relative bound on each tensor's norm and on the
# whole (see the module docstring)
GRAD_TOL = {"peft": dict(scale=4 * GRAD_SCALE_ATOL, rtol=1e-3, tensor=5e-4, glob=1e-4),
            "joint": dict(scale=5e-3, rtol=1e-2, tensor=5e-3, glob=2e-3)}


@pytest.fixture(scope="module")
def jax_step(pair):
    """(gradients of every parameter, loss/acc) of one ``upp_tpu`` train
    step, run op by op with dropout off; the trainable set does not enter
    the gradients, so both stages share it."""
    jm, variables, tm = pair
    config = ConfigDict.from_nested({**CONFIG, "data_augmentation": AUG})
    variables = _jnp(variables)
    state = TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                       opt_state=_grad_capture().init(variables["params"]),
                       step=jnp.zeros((), jnp.int32))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, deterministic=None, rng=None: x)
        mp.setattr(j_scan_blocks, "_dropout", lambda x, rate, rng, deterministic, salt=0: x)
        step = j_make_train_step(jm, _grad_capture(), config, ARGS)
        with jax.disable_jit():
            new_state, aux = step(state, jnp.asarray(_synthetic(1024, B, subset="train")),
                                  jnp.asarray(LABELS), jax.random.key(31))
    grads = state_dict_from_jax({"params": new_state.opt_state,
                                 "batch_stats": variables["batch_stats"]}, tm)
    return grads, {k: float(v) for k, v in aux.items()}


def _port_step(tm, stage, dtype):
    """(loss/acc, gradients) of one port train step in ``dtype`` on the
    draws of the JAX step (JAX's key splits: ``fold_in(step)``, split 3,
    then ``corrupt_batch``'s split 4), from ``tm``'s weights."""
    model = copy.deepcopy(tm).to(dtype)
    config = ConfigDict.from_nested({**CONFIG, "data_augmentation": AUG})
    k_pipe = jax.random.split(jax.random.fold_in(jax.random.key(31), 0), 3)[0]
    draws = _jax_draws(k_pipe, B, NPOINTS, AUG)
    draws = type(draws)(**{k: v.to(dtype) if torch.is_tensor(v) and v.is_floating_point()
                           else v for k, v in vars(draws).items()})
    optim.set_trainable(no_dropout(model), PEFT_LIST if stage == "peft" else JOINT_PEFT_LIST)
    opt = optim.build_optimizer(config, model, steps_per_epoch=1)
    out = runner_cls.make_train_step(model, opt, config, ARGS)(
        torch.tensor(_synthetic(1024, B, subset="train"), dtype=dtype), torch.tensor(LABELS),
        draws)
    grads = {n: p.grad.double() for n, p in model.named_parameters() if p.grad is not None}
    return out, grads, {n for n, p in model.named_parameters() if p.requires_grad}


def _global(a, b, names):
    num = sum(float(((a[n] - b[n]) ** 2).sum()) for n in names)
    return np.sqrt(num / sum(float((b[n] ** 2).sum()) for n in names))


@pytest.mark.parametrize("stage", ["peft", "joint"])
def test_train_step_matches_jax(pair, jax_step, stage):
    """One step of each package's ``make_train_step`` on the same clouds,
    labels and draws: loss, accuracy and every trainable gradient, with the
    PEFT set and with the joint set (whose gradients cross the completion
    and rectify passes and the kNN backward). The port's float32 and
    float64 steps are each held to JAX's gradients."""
    _, _, tm = pair
    j_grads, aux = jax_step
    out, grads, trainable = _port_step(tm, stage, torch.float32)
    _, exact, _ = _port_step(tm, stage, torch.float64)
    np.testing.assert_allclose(out["loss"].item(), aux["loss"], **TOL)
    assert out["acc"].item() == aux["acc"]
    # every trainable tensor the step reaches has a gradient; the unused
    # ones (bnorm of blocks that do not propagate, the decoder's) have none
    assert set(grads) == set(exact) <= trainable and len(grads) > 10
    unused = trainable - set(grads)
    assert all("bnorm" in n for n in unused), sorted(unused)
    assert all(float(j_grads[n].abs().max()) == 0.0 for n in unused)
    if stage == "joint":
        assert any(n.startswith("rectify_prompter") for n in grads)
        assert not any(n.startswith("cls_head_finetune") for n in trainable)
    j_grads = {n: j_grads[n].double() for n in grads}
    top = max(float(g.abs().max()) for g in exact.values())
    # exactly zero (a bias right before a train-mode BatchNorm) or vanishing:
    # both packages hold float32 noise there
    zero = {n for n in grads if float(exact[n].abs().max()) <= 1e-6 * top}
    assert zero and all(n.endswith(".bias") for n in zero), sorted(zero)
    for n in zero:
        assert max(float(grads[n].abs().max()), float(j_grads[n].abs().max())) < 1e-5 * top, n
    tol = GRAD_TOL[stage]
    names = sorted(set(grads) - zero)
    for port in (grads, exact):
        for n in names:
            g, w = port[n].numpy(), j_grads[n].numpy()
            bound = tol["rtol"] * np.abs(w) + 1e-6 + tol["scale"] * np.abs(w).max()
            assert (np.abs(g - w) <= bound).all(), (n, float(np.abs(g - w).max()))
            rel = np.linalg.norm(g - w) / np.linalg.norm(w)
            assert rel < tol["tensor"], (n, rel)
        assert _global(port, j_grads, names) < tol["glob"]


def test_train_step_draws_from_its_seeded_generator(pair):
    """Without draws the step is seeded by ``args.seed + 777`` and the
    optimizer's count of calls: two fresh steps from the same weights give
    the same loss, and a step resumed from the model and optimizer state
    after one step gives the loss of the uninterrupted run's second step
    (JAX's ``fold_in(key, state.step)``)."""
    _, _, tm = pair
    config = ConfigDict.from_nested({**CONFIG, "data_augmentation": "hflip"})
    clouds = torch.tensor(_synthetic(1024, B, subset="train"))
    labels = torch.tensor([0, 4, 2, 1])
    state0 = {k: v.clone() for k, v in tm.state_dict().items()}

    def fresh(model_state, opt_state=None):
        tm.load_state_dict(model_state)
        optim.set_trainable(no_dropout(tm), PEFT_LIST)
        opt = optim.build_optimizer(config, tm, steps_per_epoch=1)
        if opt_state is not None:
            opt.load_state_dict(opt_state)
        return opt, runner_cls.make_train_step(tm, opt, config, ARGS)

    try:
        opt, step = fresh(state0)
        first = step(clouds, labels)["loss"]
        after = ({k: v.clone() for k, v in tm.state_dict().items()},
                 copy.deepcopy(opt.state_dict()))
        second = step(clouds, labels)["loss"]
        again = fresh(state0)[1](clouds, labels)["loss"]
        resumed = fresh(*after)[1](clouds, labels)["loss"]
    finally:
        tm.load_state_dict(state0)
        tm.eval()
        for p in tm.parameters():
            p.requires_grad_(True)
            p.grad = None
    assert torch.isfinite(first) and torch.equal(first, again)
    assert torch.equal(second, resumed) and not torch.equal(first, second)
