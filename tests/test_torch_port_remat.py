"""``remat_blocks: True`` in the port (``models/scan_blocks.py::remat_block``):
each block recomputed in the backward, on the CPU.

One cls train step (``runner_cls.make_train_step``, batch 4, depth 4,
width 48, drop-path 0.1, adapter dropout and the prompt propagation on) of
a model with and of one without ``remat_blocks`` from the same weights and
seed: every gradient, every parameter after the update and every BatchNorm
running statistic bit-equal, in the PEFT and the joint stage. The
recomputation must redraw the forward's drop-path and dropout masks from
the train step's generator (which ``torch.utils.checkpoint`` does not
restore), update ``bnorm``'s running statistics once, and see the step's
global batch. Both steps run with ``torch.use_deterministic_algorithms``:
without it two identical steps of the model without remat already differ
in the last bits (the CPU's multithreaded accumulating index ops). The
port's step without remat is held to the JAX package's
in ``test_torch_port_cls_step.py``; here the train-mode forward with remat
(and its backward) is held to the JAX model built with ``remat_blocks:
True`` at the bounds of ``test_torch_port_cls_train.py``."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_cls_step import ARGS, CONFIG, LABELS
from test_torch_port_cls_train import B, N_IN, NPOINTS, SMALL_TRAIN, _jnp, _noisy_input
from test_torch_port_model import SMALL, TOL, build_pair
from test_torch_port_pretask import jax_without_dropout, no_dropout  # noqa: F401
from test_torch_port_slice import _synthetic
from upp_torch.models import build_model_from_cfg
from upp_torch.models.scan_blocks import PromptedBlock
from upp_torch.train import optim, runner_cls
from upp_torch.train.runner_cls import JOINT_PEFT_LIST, PEFT_LIST
from upp_torch.utils.config import ConfigDict
from upp_torch.weights import state_dict_from_jax


def _step(model, stage):
    """(block forwards run, gradients, state after) of one train step."""
    config = ConfigDict.from_nested({**CONFIG, "data_augmentation": "scale-translate"})
    optim.set_trainable(model, PEFT_LIST if stage == "peft" else JOINT_PEFT_LIST)
    opt = optim.build_optimizer(config, model, steps_per_epoch=1)
    calls = [0]
    forward = PromptedBlock.forward

    def counted(self, *a, **kw):
        calls[0] += 1
        return forward(self, *a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PromptedBlock, "forward", counted)
        out = runner_cls.make_train_step(model, opt, config, ARGS)(
            torch.tensor(_synthetic(1024, B, subset="train")), torch.tensor(LABELS))
    grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    return calls[0], out, grads, {k: v.clone() for k, v in model.state_dict().items()}


@pytest.fixture
def deterministic():
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


@pytest.mark.parametrize("stage", ["peft", "joint"])
def test_remat_step_is_bit_equal(stage, deterministic):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(3)
        plain = build_model_from_cfg(SMALL)
    remat = build_model_from_cfg({**SMALL, "remat_blocks": True})
    remat.load_state_dict(plain.state_dict())
    before = {k: v.clone() for k, v in plain.state_dict().items()}
    n_plain, out_p, grads_p, state_p = _step(plain, stage)
    n_remat, out_r, grads_r, state_r = _step(remat, stage)
    assert n_remat > n_plain           # the blocks ran again in the backward
    assert torch.equal(out_p["loss"], out_r["loss"])
    assert grads_p.keys() == grads_r.keys() and len(grads_p) > 10
    for k in grads_p:
        assert torch.equal(grads_p[k], grads_r[k]), k
    moved = [k for k in state_p if k.endswith("running_mean")
             and not torch.equal(state_p[k], before[k])]
    assert any("bnorm" in k for k in moved)
    for k in state_p:
        assert torch.equal(state_p[k], state_r[k]), k


def test_remat_train_forward_and_backward_match_jax(jax_without_dropout):
    """Logits and every running statistic of a train-mode three-pass
    forward with remat (gradients on, so the blocks are checkpointed),
    against the JAX model with ``remat_blocks: True``; after the backward,
    which recomputes every block, the running statistics still equal
    JAX's (moved once)."""
    cfg = {**SMALL_TRAIN, "remat_blocks": True}
    jm, variables, _ = build_pair(cfg, NPOINTS, N_IN, seed=4)
    assert jm.config["remat_blocks"]
    tm = build_model_from_cfg(cfg)
    tm.load_state_dict(state_dict_from_jax(variables, tm), strict=True)
    pts = _noisy_input(6)
    want, mut = jm.apply(_jnp(variables), jnp.asarray(pts), completion_prompt=True,
                         denoise=True, point_num=NPOINTS, deterministic=False,
                         mutable=["batch_stats"],
                         rngs={"dropout": jax.random.key(9), "droppath": jax.random.key(8)})
    want_stats = state_dict_from_jax({"params": variables["params"],
                                      "batch_stats": mut["batch_stats"]}, tm)
    no_dropout(tm).train()
    got = tm(torch.tensor(pts), completion_prompt=True, denoise=True, point_num=NPOINTS)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    got.square().sum().backward()
    grads = [p.grad for p in tm.parameters() if p.grad is not None]
    assert grads and all(torch.isfinite(g).all() for g in grads)
    after = tm.state_dict()
    running = [k for k in after if k.endswith(("running_mean", "running_var"))]
    assert any("bnorm" in k for k in running)
    for k in running:
        np.testing.assert_allclose(after[k].numpy(), want_stats[k].numpy(), err_msg=k, **TOL)


def test_remat_needs_no_state_dict_change():
    plain = build_model_from_cfg(SMALL)
    remat = build_model_from_cfg(copy.deepcopy({**SMALL, "remat_blocks": True}))
    assert plain.state_dict().keys() == remat.state_dict().keys()
    assert remat.blocks.remat and remat.MAE_decoder.remat and not plain.blocks.remat
