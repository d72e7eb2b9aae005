"""Tensor parallelism of the port on the CPU (``upp_torch/parallel/tensor.py``):
the split against the JAX package's ``tp_shardings``, and two gloo ranks in
one model group (dp1 x tp2; ``tests/torch_dist_worker.py``, case ``tp``)
against one process. The cls model of ``tests/test_torch_port_dist.py``
(``trans_dim`` 48, 4 heads, 4 + 2 blocks), 4 clouds of 512 points.

(a) The split tensors are those ``tp_shardings`` shards: every block
    stack's qkv and fc1 column parallel, proj and fc2 row parallel,
    everything else replicated (tensors matched to JAX leaves through
    ``upp_torch/weights.py``); each rank holds half of each, by whole heads.
(b) The cls PEFT step, then the joint step after the switch on the live
    optimizer, and apart a Nesterov SGD step with every parameter trainable
    (the split tensors train; the clip of 0.5 takes their squares from both
    ranks), equal one process in float64: loss and accuracy rtol 1e-9,
    every gradient and the whole state (parameters and BatchNorm running
    statistics) gathered whole, atol 1e-9 / rtol 1e-9; the ranks agree (the
    replicated tensors' gradients are averaged over the model ranks too:
    on the card their atomic adds may round apart).
(c) The gathered state dict loads with ``strict=True`` into a one-process
    model."""

import jax
import numpy as np
import pytest
import torch

import torch_dist_worker as worker
from test_torch_port_dist import CLS_ARGS, CLS_CONFIG, CLS_MODEL, _synthetic, one_thread, run_ranks
from test_torch_port_model import POINT_NUM, N_NOISE, build_pair
from upp_tpu.parallel.mesh import make_mesh, tp_shardings
from upp_torch.models import build_model_from_cfg
from upp_torch.parallel import tensor
from upp_torch.weights import state_dict_from_jax

WORLD = 2


def test_split_matches_jax_tp_shardings():
    """(a) Column, row or replicated, tensor by tensor."""
    _, variables, tm = build_pair(CLS_MODEL, POINT_NUM, POINT_NUM + N_NOISE)
    specs = tp_shardings(make_mesh(jax.devices()[:WORLD], model_parallel=WORLD),
                         variables["params"])
    kind = {(None, None, "model"): 1.0, (None, "model", None): 2.0}   # column, row
    codes = jax.tree.map(lambda s, leaf: np.full(leaf.shape, kind.get(tuple(s.spec), 0.0),
                                                 np.float32), specs, variables["params"])
    mapped = state_dict_from_jax({"params": codes, "batch_stats": variables["batch_stats"]}, tm)
    splits = tensor.split_params(tm)
    names = [n for n, _ in tm.named_parameters()]
    port = {n: {0: 1.0, 1: 2.0}[splits[n][0]] if n in splits else 0.0 for n in names}
    assert port == {n: float(mapped[n].flatten()[0]) for n in names}
    assert sum(v == 1.0 for v in port.values()) == sum(v == 2.0 for v in port.values()) == 2 * 6
    print(f"[tp split] {len(splits)} of {len(names)} tensors split (qkv/fc1 column, proj/fc2 "
          "row), as tp_shardings")


def _jobs():
    clouds, labels = _synthetic(4)
    tp = {"config": CLS_CONFIG, "args": CLS_ARGS, "clouds": clouds, "labels": labels}
    # every parameter trainable, the split tensors too, under a clip that
    # acts; Nesterov SGD: AdamW's first update of an element whose gradient
    # is near its epsilon (1e-8) moves by up to lr/eps times a rounding
    # difference of that gradient
    full = {**tp, "stages": ("full",), "config": {
        **CLS_CONFIG, "grad_norm_clip": 0.5,
        "optimizer": {"type": "SGD", "kwargs": {"lr": 0.01, "momentum": 0.9}}}}
    return {"cases": ["tp", "tp_full"], "tp": tp, "tp_full": full}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the jobs, each rank's results of both cases, stage by stage)."""
    tmp = tmp_path_factory.mktemp("tp")
    job = _jobs()
    return job, [{**r["tp"], **r["tp_full"]} for r in run_ranks(tmp, job)]


@pytest.fixture(scope="module")
def one_process(runs):
    with one_thread():
        return {**worker.case_cls(runs[0]["tp"]), **worker.case_cls(runs[0]["tp_full"])}


def test_each_rank_holds_whole_heads(runs):
    """(a) Half of each split tensor a rank."""
    _, results = runs
    model = build_model_from_cfg(CLS_MODEL)
    whole = {n: tuple(p.shape) for n, p in model.named_parameters()}
    splits = tensor.split_params(model)
    for res in results:
        for n, shape in res["shapes"].items():
            want = list(whole[n])
            if n in splits:
                want[splits[n][0]] //= WORLD
            assert list(shape) == want, n
    head = "blocks.blocks.0.attn.qkv.weight"
    assert results[0]["shapes"][head] == (3 * 48 // WORLD, 48)


@pytest.mark.parametrize("stage", ["peft", "joint", "full"])
def test_tensor_parallel_step_equals_one_process(runs, one_process, stage):
    """(b) Float64, gathered whole."""
    _, results = runs
    got, ref = results[0][stage], one_process[stage]
    for other in results[1:]:
        o = other[stage]
        assert o["loss"] == got["loss"]
        for part in ("state", "grads"):
            assert o[part].keys() == got[part].keys()
            assert all(torch.equal(o[part][k], got[part][k]) for k in got[part]), part
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-9, atol=0)
    assert got["acc"] == pytest.approx(ref["acc"], rel=1e-9)
    assert got["grads"].keys() == ref["grads"].keys() and len(ref["grads"]) > 10
    for name, g in ref["grads"].items():
        np.testing.assert_allclose(got["grads"][name].numpy(), g.numpy(), rtol=1e-9, atol=1e-9,
                                   err_msg=name)
    assert got["state"].keys() == ref["state"].keys()
    for name, v in ref["state"].items():
        if v.is_floating_point():
            np.testing.assert_allclose(got["state"][name].numpy(), v.numpy(), rtol=1e-9,
                                       atol=1e-9, err_msg=name)
        else:
            assert torch.equal(got["state"][name], v), name
    assert any("running_mean" in k for k in ref["state"])
    counts = got["counts"]
    assert counts["tp"] > 0
    # the replicated tensors' mean over both ranks (one data rank: no mean
    # of the split ones); the full step's clip sums the split squares
    assert counts["gradients"] == 1 + (stage == "full")
    print(f"[tp {stage} step, dp1 x tp2] loss {abs(got['loss'] - ref['loss']):.3g} from one "
          f"process, gradients {max(float((got['grads'][n] - g).abs().max()) for n, g in ref['grads'].items()):.3g}, "
          f"state {max(float((got['state'][n] - v).abs().max()) for n, v in ref['state'].items() if v.is_floating_point()):.3g}; "
          f"collectives {counts}")


def test_gathered_state_loads_into_one_process(runs, one_process):
    """(c) ``strict=True``; the one-process state after both steps."""
    _, results = runs
    state = results[0]["full"]["state"]
    with worker.default_dtype(torch.float64):
        model = build_model_from_cfg(CLS_MODEL)
    model.load_state_dict(state, strict=True)
    for k, v in model.state_dict().items():
        assert torch.equal(v, state[k]), k
    assert state.keys() == one_process["full"]["state"].keys()
