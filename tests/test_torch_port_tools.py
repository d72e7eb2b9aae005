"""The port's smaller tools against the JAX package on the CPU:
``AdapterSuper``/``AdapterSuperF`` (weights moved by
``upp_torch.weights``, outputs at rtol = atol = 1e-4), the visualisation
runner ``runner_vis.test_net`` (the clouds it saves are FPS outputs, so
equal to JAX's bit for bit), the ``Adam`` and ``SGD`` optimizers against
the JAX package's optax chains over three steps on the same gradients
(1e-6: float32 rounding of a few operations a step), and the kNN kernel's
k limit in its wrapper and source."""

import re
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_port_baseline import MAE_SMALL
from test_torch_port_model import TOL
from upp_tpu.models import adapter_super as j_adapter_super
from upp_tpu.train import optim as j_optim
from upp_tpu.train import runner_vis as j_runner_vis
from upp_tpu.utils.config import ConfigDict as JConfigDict
from upp_torch.models import adapter_super
from upp_torch.ops import knn_cuda
from upp_torch.train import optim, runner_vis
from upp_torch.utils.config import ConfigDict
from upp_torch.weights import state_dict_from_jax

CSRC = Path(__file__).resolve().parent.parent / "upp_torch" / "csrc"
DIM, RED = 48, 24


@pytest.mark.parametrize("sample", [None, 16])
@pytest.mark.parametrize("name", ["AdapterSuper", "AdapterSuperF"])
def test_adapter_super_matches_jax(name, sample):
    """Eval output with every bottleneck channel and with the first 16;
    ``AdapterSuper`` also with a separate ``identity``."""
    jm = getattr(j_adapter_super, name)(DIM, RED)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, DIM)).astype(np.float32)
    ident = rng.standard_normal((2, 5, DIM)).astype(np.float32)
    variables = jm.init(jax.random.key(0), jnp.asarray(x))
    variables = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(np.float32),
        variables)                                    # biases off their 1e-6 init
    tm = getattr(adapter_super, name)(DIM, RED).eval()
    tm.load_state_dict(state_dict_from_jax(variables, tm), strict=True)
    calls = [({}, {})]
    if name == "AdapterSuper":
        calls.append(({"identity": jnp.asarray(ident)}, {"identity": torch.tensor(ident)}))
    for j_kw, t_kw in calls:
        want = jm.apply(variables, jnp.asarray(x), sample_embed_dim=sample, **j_kw)
        with torch.no_grad():
            got = tm(torch.tensor(x), sample_embed_dim=sample, **t_kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


VIS_CONFIG = {
    "model": MAE_SMALL, "npoints": 128,
    "dataset": {"test": {"_base_": {"NAME": "Synthetic", "N_POINTS": 512, "NUM_CATEGORY": 4,
                                    "SIZE": 3},
                         "others": {"subset": "test"}}},
}


def test_runner_vis_writes_jax_clouds(tmp_path):
    """``test_net`` with 2 items: the same ``input-XXX.npy`` files as the
    JAX runner, bit for bit, and a finite CD line each."""
    common = dict(seed=0, ckpts=None, log_name="vis_test")
    j_args = types.SimpleNamespace(experiment_path=str(tmp_path / "jax"), **common)
    j_runner_vis.test_net(j_args, JConfigDict.from_nested(VIS_CONFIG), max_items=2)
    t_args = types.SimpleNamespace(experiment_path=str(tmp_path / "port"), device="cpu",
                                   **common)
    assert runner_vis.test_net(t_args, ConfigDict.from_nested(VIS_CONFIG), max_items=2) == 2
    names = sorted(p.name for p in (tmp_path / "port" / "vis").glob("*.npy"))
    assert names == ["input-000.npy", "input-001.npy"]
    for n in names:
        got = np.load(tmp_path / "port" / "vis" / n)
        assert got.shape == (128, 3)
        np.testing.assert_array_equal(got, np.load(tmp_path / "jax" / "vis" / n))


SCHED = {"type": "CosLR", "kwargs": {"epochs": 3, "initial_epochs": 1}}
OPTIMIZERS = {"Adam": {"lr": 0.01},
              "SGD": {"lr": 0.05, "momentum": 0.8}}


@pytest.mark.parametrize("kind", sorted(OPTIMIZERS))
def test_adam_and_sgd_match_optax(kind):
    """Three steps with the gradient clip active (norm 1.0 of gradients of
    norm about 4), a frozen tensor left as it is, the schedule moving each
    step: every parameter within 1e-6 of the JAX chain's."""
    cfg = {"optimizer": {"type": kind, "kwargs": OPTIMIZERS[kind]}, "scheduler": SCHED,
           "grad_norm_clip": 1.0}
    rng = np.random.default_rng(11)
    shapes = {"body": {"kernel": (6, 5), "bias": (5,)}, "head": {"kernel": (5, 3), "bias": (3,)}}
    params = {m: {k: rng.standard_normal(s).astype(np.float32) for k, s in leaves.items()}
              for m, leaves in shapes.items()}
    model = torch.nn.ModuleDict({"body": torch.nn.Linear(6, 5), "head": torch.nn.Linear(5, 3)})
    with torch.no_grad():
        for m in shapes:
            model[m].weight.copy_(torch.tensor(params[m]["kernel"].T))
            model[m].bias.copy_(torch.tensor(params[m]["bias"]))
    peft = ["head", "body.bias"]
    optim.set_trainable(model, peft)
    opt = optim.build_optimizer(ConfigDict.from_nested(cfg), model, steps_per_epoch=1)
    tx, _, _ = j_optim.build_optimizer(JConfigDict.from_nested(cfg), params, 1,
                                       peft_list=["head", "body/bias"])
    j_params = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(j_params)
    for _ in range(3):
        grads = {m: {k: rng.standard_normal(s).astype(np.float32) for k, s in leaves.items()}
                 for m, leaves in shapes.items()}
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        opt.zero_grad()
        for m in shapes:
            for leaf, attr in (("kernel", "weight"), ("bias", "bias")):
                p = getattr(model[m], attr)
                if p.requires_grad:
                    g = grads[m][leaf]
                    p.grad = torch.tensor(g.T if leaf == "kernel" else g)
        opt.step()
    for m in shapes:
        np.testing.assert_allclose(model[m].weight.detach().numpy(),
                                   np.asarray(j_params[m]["kernel"]).T, rtol=0, atol=1e-6)
        np.testing.assert_allclose(model[m].bias.detach().numpy(),
                                   np.asarray(j_params[m]["bias"]), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(model["body"].weight.detach().numpy(),
                                  params["body"]["kernel"].T)         # frozen


def test_knn_wrapper_takes_k_up_to_64():
    """The wrapper's ``MAX_K`` is the kernel source's ``kMaxK``: 64, two
    kept keys a lane of the query's warp."""
    found = re.findall(r"constexpr int kMaxK = (\d+);", (CSRC / "knn.cu").read_text())
    assert found == [str(knn_cuda.MAX_K)] and knn_cuda.MAX_K == 64
