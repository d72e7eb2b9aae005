"""One segmentation train step of the port (``runner_seg.make_seg_train_step``)
and of the JAX package on CPU, at a small size (trans_dim 48, depth 12, 256
points, batch 4), on the same ``SyntheticPart`` clouds, categories and part
labels and on the JAX step's draws, dropout and drop-path off: the UPP PEFT
step (augmentation, raw 25% crop, +24 shell and +64 lidar points, rectify,
completion and downstream passes, NLL) and the full fine-tune step of
``PointTransformer_seg``. Loss, accuracy and every trainable gradient.

The JAX UPP step runs op by op (``jax.disable_jit``), as the classification
step's test does, because the jitted step's rectification scores can
reorder near ties at the top-5% drop. Gradients are held to JAX's alone,
for the port's float32 and float64 steps alike, per element (rtol 1e-2,
atol 1e-6 plus a share of the tensor's largest gradient), per tensor (by
relative norm) and as a whole. The bounds come from float32 rounding, as
measured at this size on the CPU: the UPP step's 12-block backward is
conditioned worse than the classification step's. JAX's own
float32 gradients, jitted and op by op, differ by up to 2.4e-3 of a
tensor's norm; JAX's op by op sits up to 4.0e-3 from the port's float64
step (1.0e-3 as a whole, 1.1e-2 of a tensor's largest element beyond the
rtol), and the port's float32 step up to 8.0e-4 from its float64 one. So
the UPP step is held at 2e-2 of the largest element, 1e-2 per tensor and
3e-3 as a whole. The fine-tune step is conditioned like the classification
step (JAX within 1.9e-4 per tensor, 1.2e-4 as a whole, 3.8e-4 of the
largest element): 1e-3, 5e-4 and 3e-4. A gradient that vanishes (below
1e-6 of the largest, in the float64 step) is held at noise level."""

import copy
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from test_torch_port_cls_train import _jnp
from test_torch_port_model import TOL
from test_torch_port_pretask import _grad_capture, no_dropout
from test_torch_port_seg_model import N_FULL, PT_SMALL, SEG_SMALL, seg_pair
from test_torch_port_slice import _t, jax_aug_draws
from upp_tpu.models import scan_blocks as j_scan_blocks
from upp_tpu.train.runner_seg import make_seg_train_step as j_make_seg_train_step
from upp_tpu.train.state import TrainState
from upp_tpu.utils.config import ConfigDict
from upp_torch.data import build_dataset_from_cfg
from upp_torch.train import optim, runner_seg
from upp_torch.train.pipeline import CorruptDraws
from upp_torch.weights import state_dict_from_jax

B = 4
AUG = "scale-translate"
NO_DROP_PATH = {"drop_path_rate": 0.0}
MODELS = {"peft": {**SEG_SMALL, **NO_DROP_PATH, "transformer_config": {
              **SEG_SMALL["transformer_config"], **NO_DROP_PATH}},
          "finetune": {**PT_SMALL, **NO_DROP_PATH}}
CONFIG = {
    "optimizer": {"type": "AdamW", "kwargs": {"lr": 2e-4, "weight_decay": 0.05}},
    "scheduler": {"type": "CosLR", "kwargs": {"epochs": 4, "initial_epochs": 1}},
    "dataset": {split: {"_base_": {"NAME": "SyntheticPart", "N_POINTS": N_FULL, "SIZE": B},
                        "others": {"subset": "train"}} for split in ("train", "val", "test")},
    "npoints": N_FULL, "noisy_train": True, "data_augmentation": AUG,
}
ARGS = types.SimpleNamespace(seed=0, deviation=0.1, noise_radius=0.8)
KEY = 31
GRAD_TOL = {"peft": dict(scale=2e-2, rtol=1e-2, tensor=1e-2, glob=3e-3),
            "finetune": dict(scale=1e-3, rtol=1e-2, tensor=5e-4, glob=3e-4)}


def seg_batch():
    """(clouds [B, N, 3], categories [B], part labels [B, N]) of
    ``SyntheticPart``'s training split."""
    ds = build_dataset_from_cfg(CONFIG["dataset"]["train"]["_base_"], {"subset": "train"})
    items = [ds[i] for i in range(B)]
    return (np.stack([it[0] for it in items]),
            np.array([int(it[1][0]) for it in items], np.int32),
            np.stack([it[2] for it in items]))


def jax_seg_draws(key, step=0):
    """The random numbers of ``upp_tpu``'s seg train step (its key splits:
    ``fold_in(step)``, split 6) as the port's ``CorruptDraws``."""
    ks = jax.random.split(jax.random.fold_in(key, step), 6)
    v = jnp.stack([jax.random.normal(k, (3,), jnp.float32) for k in jax.random.split(ks[1], B)])
    k1, k2 = jax.random.split(ks[3])
    p = N_FULL - N_FULL // 4 + runner_seg.GAUSSIAN_NUM
    return CorruptDraws(
        viewpoints=_t(v / jnp.linalg.norm(v, axis=-1, keepdims=True)),
        shell_normal=_t(jax.random.normal(ks[2], (B, runner_seg.GAUSSIAN_NUM, 3), jnp.float32)),
        lidar_idx=_t(jax.random.randint(k1, (runner_seg.LIDAR_NUM,), 0, p)),
        lidar_factor=_t(jax.random.uniform(k2, (runner_seg.LIDAR_NUM,), jnp.float32, 1.2, 1.5)),
        **jax_aug_draws(ks[0], AUG, B, N_FULL))


def jax_stage(name):
    """(stage, port model, JAX gradients of every parameter as the port's
    state dict, JAX loss/acc) of one ``upp_tpu`` seg train step with
    dropout off: op by op for the UPP model, jitted for the fine-tune."""
    jm, np_vars, tm = seg_pair(MODELS[name], 24)
    config = ConfigDict.from_nested({**CONFIG, "model": MODELS[name]})
    variables = _jnp(np_vars)
    state = TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                       opt_state=_grad_capture().init(variables["params"]),
                       step=jnp.zeros((), jnp.int32))
    pts, cls, seg = map(jnp.asarray, seg_batch())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, deterministic=None, rng=None: x)
        mp.setattr(j_scan_blocks, "_dropout", lambda x, rate, rng, deterministic, salt=0: x)
        step = j_make_seg_train_step(jm, _grad_capture(), config, ARGS, unify=name == "peft")
        if name == "peft":
            with jax.disable_jit():
                new_state, aux = step(state, pts, cls, seg, jax.random.key(KEY))
        else:
            new_state, aux = step(state, pts, cls, seg, jax.random.key(KEY))
    # the jitted step donates the state: read the statistics from numpy
    grads = state_dict_from_jax({"params": new_state.opt_state,
                                 "batch_stats": np_vars["batch_stats"]}, tm)
    return name, tm, grads, {k: float(v) for k, v in aux.items()}


@pytest.fixture(scope="module", params=list(MODELS))
def stage(request):
    return jax_stage(request.param)


def _port_step(name, tm, dtype):
    """(loss/acc, gradients, trainable names) of one port seg train step in
    ``dtype`` on the JAX step's draws, from ``tm``'s weights."""
    model = no_dropout(copy.deepcopy(tm).to(dtype))
    config = ConfigDict.from_nested({**CONFIG, "model": MODELS[name]})
    draws = jax_seg_draws(jax.random.key(KEY))
    draws = CorruptDraws(**{k: v.to(dtype) if torch.is_tensor(v) and v.is_floating_point()
                            else v for k, v in vars(draws).items()})
    optim.set_trainable(model, runner_seg.SEG_PEFT_LIST if name == "peft" else None)
    opt = optim.build_optimizer(config, model, steps_per_epoch=1)
    pts, cls, seg = seg_batch()
    out = runner_seg.make_seg_train_step(model, opt, config, ARGS, unify=name == "peft")(
        torch.tensor(pts, dtype=dtype), torch.tensor(cls), torch.tensor(seg), draws)
    grads = {n: p.grad.double() for n, p in model.named_parameters() if p.grad is not None}
    return out, grads, {n for n, p in model.named_parameters() if p.requires_grad}


def _global(a, b, names):
    num = sum(float(((a[n] - b[n]) ** 2).sum()) for n in names)
    return np.sqrt(num / sum(float((b[n] ** 2).sum()) for n in names))


def test_seg_train_step_matches_jax(stage):
    """One step of each package's seg train step on the same batch and
    draws: loss, accuracy and every trainable gradient (``SEG_PEFT_LIST``
    for the UPP model, every parameter for the fine-tune)."""
    name, tm, j_grads, aux = stage
    out, grads, trainable = _port_step(name, tm, torch.float32)
    _, exact, _ = _port_step(name, tm, torch.float64)
    np.testing.assert_allclose(out["loss"].item(), aux["loss"], **TOL)
    np.testing.assert_allclose(out["acc"].item(), aux["acc"], rtol=0, atol=100 / (B * N_FULL))
    assert set(grads) == set(exact) <= trainable and len(grads) > 10
    unused = trainable - set(grads)
    assert all(float(j_grads[n].abs().max()) == 0.0 for n in unused), sorted(unused)
    if name == "peft":
        assert {n.split(".")[0] for n in grads} >= {"label_conv", "propagation_0", "seg_head"}
        assert any("downstream_prompts" in n for n in grads)
    j_grads = {n: j_grads[n].double() for n in grads}
    top = max(float(g.abs().max()) for g in exact.values())
    zero = {n for n in grads if float(exact[n].abs().max()) <= 1e-6 * top}
    for n in zero:
        assert max(float(grads[n].abs().max()), float(j_grads[n].abs().max())) < 1e-5 * top, n
    names = sorted(set(grads) - zero)
    tol = GRAD_TOL[name]
    for port in (grads, exact):
        for n in names:
            g, w = port[n].numpy(), j_grads[n].numpy()
            bound = tol["rtol"] * np.abs(w) + 1e-6 + tol["scale"] * np.abs(w).max()
            assert (np.abs(g - w) <= bound).all(), (n, float(np.abs(g - w).max()))
            rel = np.linalg.norm(g - w) / np.linalg.norm(w)
            assert rel < tol["tensor"], (n, rel)
        assert _global(port, j_grads, names) < tol["glob"]
