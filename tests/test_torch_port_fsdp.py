"""ZeRO-3 (``fsdp: true``) of the port on the CPU: the placement rule
against the JAX package's ``fsdp_shardings``, and two gloo ranks
(``tests/torch_dist_worker.py``, cases ``fsdp`` and ``fsdp_runner``)
against the replicated two-rank step and one process. Small sizes:
``Point_MAE`` at ``trans_dim`` 48 (3 + 2 blocks), 4 clouds of 512 points
a step, 2 a rank.

(a) The rule, on the four-leaf tree of ``tests/test_dist.py`` (the same
    dimension sharded, over 2 and 8 ranks) and on ``Point_MAE``'s tree at
    ``min_size`` 256, 512 and 4096 (the same tensors sharded, the same
    element count a rank; the JAX package stacks each block stack's
    tensors, so a per-block bias of 192 elements is sharded where its stack
    [3, 192] reaches ``min_size``); tensors are matched to JAX leaves
    through ``upp_torch/weights.py``.
(b) Between steps each rank holds its block of every sharded parameter and
    of its AdamW moments (the counts are printed).
(c) Two sharded steps, with a clip of 0.5 that acts, equal the replicated
    two-rank steps and one process in float64: losses rtol 1e-9, the whole
    state (parameters, running statistics, moments) atol 1e-9 / rtol
    1e-9; the ranks' gathered states are equal bit for bit.
(d) The checkpoint of a sharded run is the one-process ``.pth``: it loads
    with ``strict=True`` into a one-process model and optimizer; a resume
    shards it again and the next step equals the uninterrupted run's.
(e) The probe's features on gathered parameters equal the replicated
    model's; the blocks come back after.
(f) ``runner_pretrain.run_net`` with ``fsdp: true``: epoch 0, then
    ``--resume`` through epoch 1 with its SVM probe."""

import copy

import jax
import numpy as np
import pytest
import torch

import torch_dist_worker as worker
from test_torch_port_baseline import MAE_SMALL, mae_pair
from test_torch_port_dist import WORLD, _synthetic, one_thread, run_ranks
from upp_tpu.parallel.mesh import fsdp_shardings, make_mesh
from upp_torch.models import build_model_from_cfg
from upp_torch.parallel import fsdp
from upp_torch.weights import state_dict_from_jax

MIN_SIZE = 256
SYNTH = {"NAME": "Synthetic", "N_POINTS": 512, "NUM_CATEGORY": 5, "SIZE": 8}
CONFIG = {"optimizer": {"type": "AdamW", "kwargs": {"lr": 1e-3, "weight_decay": 0.05}},
          "scheduler": {"type": "CosLR", "kwargs": {"epochs": 4, "initial_epochs": 1}},
          "npoints": 128, "data_augmentation": "scale-translate", "grad_norm_clip": 0.5,
          "model": {**MAE_SMALL, "transformer_config": {**MAE_SMALL["transformer_config"],
                                                        "drop_path_rate": 0.1}}}


@pytest.mark.parametrize("world", [2, 8])
def test_placement_rule_equals_jax_on_the_four_leaf_tree(world):
    """(a) The same dimension, or none, for each leaf."""
    tree = {"small": (4, 4), "odd": (129, 201), "big": (48, 512), "bias": (4096,)}
    mesh = make_mesh(jax.devices()[:world])
    specs = fsdp_shardings(mesh, {k: np.zeros(s) for k, s in tree.items()}, min_size=1024)
    for k, shape in tree.items():
        spec = tuple(specs[k].spec)
        want = spec.index("data") if "data" in spec else None
        assert fsdp.shard_dim(shape, world, 1024) == want, k


@pytest.mark.parametrize("min_size", [256, 512, 4096])
def test_placement_rule_equals_jax_on_point_mae(min_size):
    """(a) The same tensors sharded and the same element count a rank."""
    _, variables, tm = mae_pair()
    specs = fsdp_shardings(make_mesh(jax.devices()[:WORLD]), variables["params"],
                           min_size=min_size)
    # each JAX leaf filled with 1 where sharded, moved onto the port's names
    codes = jax.tree.map(lambda s, leaf: np.full(leaf.shape, float("data" in tuple(s.spec)),
                                                 np.float32),
                         specs, variables["params"])
    mapped = state_dict_from_jax({"params": codes, "batch_stats": variables["batch_stats"]}, tm)
    plan = fsdp.placement(tm, WORLD, min_size)
    params = dict(tm.named_parameters())
    jax_sharded = {n for n in params if mapped[n].flatten()[0] == 1}
    port_sharded = {n for n, d in plan.items() if d is not None}
    assert port_sharded == jax_sharded
    per_rank = sum(p.numel() // (WORLD if n in port_sharded else 1) for n, p in params.items())
    jax_per_rank = sum(int(np.prod(leaf.shape)) // (WORLD if "data" in tuple(s.spec) else 1)
                       for s, leaf in zip(jax.tree.leaves(specs),
                                          jax.tree.leaves(variables["params"])))
    assert per_rank == jax_per_rank
    stacked = "MAE_encoder.blocks.blocks.0.mlp.fc1.bias"
    assert (stacked in port_sharded) == (3 * params[stacked].numel() >= min_size)
    print(f"[fsdp placement, min_size {min_size}] {len(port_sharded)} of {len(params)} tensors "
          f"sharded, {per_rank} of {sum(p.numel() for p in params.values())} elements a rank, "
          "as JAX")


def _job(tmp):
    rng = np.random.default_rng(5)
    steps = [_synthetic(4)[0], rng.permutation(_synthetic(4)[0], axis=1)]
    return {"cases": ["fsdp", "fsdp_runner"],
            "fsdp": {"config": CONFIG, "model": CONFIG["model"], "seed": 7, "steps": steps,
                     "min_size": MIN_SIZE, "dir": str(tmp / "ckpt"), "probe_data": SYNTH,
                     "npoints": 128},
            "fsdp_runner": {"dir": str(tmp / "runner"), "config": {
                **CONFIG, "fsdp": True, "max_epoch": 0,
                "dataset": {s: {"_base_": SYNTH, "others": {"subset": "train", "bs": 2}}
                            for s in ("train", "extra_train", "val")}}}}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(the job, each rank's results by case) of one two-rank run."""
    tmp = tmp_path_factory.mktemp("fsdp")
    job = _job(tmp)
    return job, run_ranks(tmp, job)


@pytest.fixture(scope="module")
def runs(ranks):
    """(the job, each rank's ``fsdp`` case)."""
    job, results = ranks
    return job, [r["fsdp"] for r in results]


@pytest.fixture(scope="module")
def one_process(runs, tmp_path_factory):
    job = copy.deepcopy(runs[0]["fsdp"])
    job["dir"] = str(tmp_path_factory.mktemp("fsdp_one") / "ckpt")
    with one_thread():
        return worker.case_fsdp(job)


def _close(a, b, what):
    assert a.keys() == b.keys(), what
    for k in a:
        if torch.is_tensor(a[k]) and a[k].is_floating_point():
            np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=1e-9, atol=1e-9,
                                       err_msg=f"{what} {k}")
        else:
            assert (torch.equal(a[k], b[k]) if torch.is_tensor(a[k]) else a[k] == b[k]), (what, k)


def _moments(opt_state):
    return {f"{i}.{k}": v for i, st in opt_state["state"].items() for k, v in st.items()}


def test_each_rank_holds_only_its_blocks(runs):
    """(b) Parameters and moments: the blocks of the sharded tensors, the
    replicated ones whole."""
    _, results = runs
    model = build_model_from_cfg(CONFIG["model"])
    plan = fsdp.placement(model, WORLD, MIN_SIZE)
    whole = sum(p.numel() for p in model.parameters())
    mine = sum(p.numel() // (WORLD if plan[n] is not None else 1)
               for n, p in model.named_parameters())
    for r, res in enumerate(results):
        params, moments = res["fsdp"]["counts"]
        print(f"[fsdp rank {r}] {params} parameter elements and {moments} AdamW moment "
              f"elements (replicated: {res['replicated']['counts'][0]} and "
              f"{res['replicated']['counts'][1]}); "
              f"{sum(d is not None for d in plan.values())} of {len(plan)} tensors sharded")
        assert params == mine < whole and moments == 2 * mine
        assert res["replicated"]["counts"] == (whole, 2 * whole)
        assert res["fsdp"]["collectives"]["fsdp"] > 0


@pytest.mark.parametrize("ref", ["replicated", "one process"])
def test_sharded_steps_equal_replicated_and_one_process(runs, one_process, ref):
    """(c) Two steps, float64, the clip on."""
    _, results = runs
    got = results[0]["fsdp"]
    want = results[0]["replicated"] if ref == "replicated" else one_process["fsdp"]
    for other in results[1:]:
        assert other["fsdp"]["loss"] == got["loss"]
        for a, b in zip(other["fsdp"]["state"], got["state"]):
            assert all(torch.equal(a[k], b[k]) for k in a)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-9, atol=0)
    for i in range(len(got["state"])):
        _close(got["state"][i], want["state"][i], f"step {i} state")
        _close(_moments(got["opt"][i]), _moments(want["opt"][i]), f"step {i} moments")
    print(f"[fsdp 2 steps vs {ref}] losses {got['loss']} vs {want['loss']}; state "
          f"{max(float((got['state'][-1][k] - v).abs().max()) for k, v in want['state'][-1].items() if v.is_floating_point()):.3g}")


def test_the_clip_acts(runs):
    """(c) The clip of 0.5 changes the step: the global norm the sharded
    ranks compute is the one that scales."""
    job = copy.deepcopy(runs[0]["fsdp"])
    job["steps"] = job["steps"][:1]
    loose = copy.deepcopy(job)
    loose["config"]["grad_norm_clip"] = None
    with one_thread():
        clipped = worker.case_fsdp({**job, "dir": job["dir"] + "_a"})["replicated"]
        free = worker.case_fsdp({**loose, "dir": job["dir"] + "_b"})["replicated"]
    key = "MAE_encoder.blocks.blocks.0.attn.qkv.weight"
    assert not torch.allclose(clipped["state"][0][key], free["state"][0][key], rtol=0, atol=1e-9)


def test_checkpoint_is_one_process_and_resumes(ranks):
    """(d) ``strict=True`` into one process; the resume continues the run."""
    job, results = ranks
    from upp_torch.train import optim
    from upp_torch.utils.config import ConfigDict
    saved = torch.load(f"{job['fsdp']['dir']}/ckpt-last.pth", weights_only=True)
    with worker.default_dtype(torch.float64):
        model = build_model_from_cfg(CONFIG["model"])
        model.load_state_dict(saved["base_model"], strict=True)
        opt = optim.build_optimizer(ConfigDict.from_nested(CONFIG), model, 1)
        opt.load_state_dict(saved["optimizer"])
    got = results[0]["fsdp"]["fsdp"]
    _close(dict(saved["base_model"]), got["state"][-1], "checkpoint")
    _close(_moments(saved["optimizer"]), _moments(got["opt"][-1]), "checkpoint moments")
    assert got["start_epoch"] == 1 and saved["epoch"] == 0
    state, opt_state = got["resumed_state"]
    _close(state, got["state"][-1], "resumed")
    _close(_moments(opt_state), _moments(got["opt"][-1]), "resumed moments")
    for a, b in zip(got["next"], got["resumed_next"]):
        if isinstance(a, float):
            assert a == b
        else:
            _close(_moments(a) if "state" in a else a, _moments(b) if "state" in b else b,
                   "next step")


def test_probe_features_on_gathered_parameters(runs):
    """(e) Each rank featurises its shard with the whole parameters."""
    _, results = runs
    model = build_model_from_cfg(CONFIG["model"])
    whole = sum(p.numel() for p in model.parameters())
    for res in results:
        got, want = res["fsdp"], res["replicated"]
        assert got["blocks_gathered"] == whole and got["blocks_after"] == got["counts"][0]
        np.testing.assert_array_equal(got["probe"][1], want["probe"][1])
        np.testing.assert_allclose(got["probe"][0], want["probe"][0], rtol=1e-9, atol=1e-9)


def test_runner_shards_resumes_and_probes(ranks):
    """(f) ``fsdp: true`` in the pretrain runner over two ranks."""
    job, results = ranks
    lines = results[0]["fsdp_runner"]["lines"]
    assert any("[fsdp] ZeRO-3 over 2 ranks" in ln for ln in lines)
    assert any("[RESUME] restored ckpt @ epoch 0" in ln for ln in lines)
    assert sum("[Training] EPOCH: 1" in ln for ln in lines) == 1
    assert not any("[Training] EPOCH: 0" in ln for ln in lines[lines.index(
        next(ln for ln in lines if "[RESUME]" in ln)):])
    acc = results[0]["fsdp_runner"]["accs"][1]
    assert 0.0 <= acc <= 100.0 and results[1]["fsdp_runner"]["accs"][1] == acc
    saved = torch.load(f"{job['fsdp_runner']['dir']}/ckpt-last.pth", weights_only=True)
    assert saved["epoch"] == 1
    build_model_from_cfg(CONFIG["model"]).load_state_dict(saved["base_model"], strict=True)
