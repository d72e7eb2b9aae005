"""The port's classification runner against the JAX package on CPU, at a
small size: the PEFT and joint trainable sets, AdamW with gradient
accumulation across the joint switch, ``--ckpts`` (a reference-keyed
``.pth`` and the port's own pretask ``ckpt-best.pth``), ``test_vote`` with
the JAX package's draws, the cross-entropy metric, and the CLI: train with
the joint switch, write ``ckpt-best.pth``/``ckpt-last.pth``, resume, and
``--test --vote --ckpts``."""

import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from test_torch_port_model import SMALL, TOL, build_pair, random_jax_variables
from upp_tpu.data import BatchLoader as JBatchLoader
from upp_tpu.data import build_dataset_from_cfg as j_build_dataset
from upp_tpu.ops.corrupt import scale_translate as j_scale_translate
from upp_tpu.train import optim as joptim
from upp_tpu.train.ckpt_io import load_weights as j_load_weights
from upp_tpu.train.metrics import cross_entropy_loss_acc as j_cross_entropy
from upp_tpu.train.pipeline import point_all_for
from upp_tpu.train.pipeline import subsample_fps_random as j_subsample
from upp_tpu.train.runner_cls import test_vote as j_test_vote
from upp_tpu.train.state import TrainState
from upp_tpu.utils.config import ConfigDict
from upp_torch.data import BatchLoader, build_dataset_from_cfg
from upp_torch.models import build_model_from_cfg
from upp_torch.train import checkpoint as ckpt
from upp_torch.train import ckpt_io, optim, runner_cls, runner_pretask
from upp_torch.train.metrics import AccMetric, cross_entropy_loss_acc
from upp_torch.train.pipeline import CorruptDraws
from upp_torch.train.runner_cls import JOINT_PEFT_LIST, PEFT_LIST
from upp_torch.utils.config import cfg_from_yaml_file
from upp_torch.weights import state_dict_from_jax

REPO = Path(__file__).resolve().parent.parent
NPOINTS = 256
CONFIG = {
    "optimizer": {"type": "AdamW", "kwargs": {"lr": 1e-3, "weight_decay": 0.05}},
    "scheduler": {"type": "CosLR", "kwargs": {"epochs": 4, "initial_epochs": 1}},
    "npoints": NPOINTS,
}


@pytest.fixture(scope="module")
def pair():
    return build_pair(SMALL, NPOINTS, NPOINTS + 72, seed=6)


def _port_state(tm, params, variables):
    return state_dict_from_jax({"params": params, "batch_stats": variables["batch_stats"]}, tm)


def test_trainable_sets_match_jax(pair):
    """``PEFT_LIST`` and ``JOINT_PEFT_LIST`` select the same number of
    parameters in both packages; the joint set leaves out the head, the
    propagation's ``bnorm`` and the cls tokens."""
    _, variables, tm = pair
    params = variables["params"]
    try:
        for peft in (PEFT_LIST, JOINT_PEFT_LIST):
            optim.set_trainable(tm, peft)
            assert optim.count_params(tm) == joptim.count_params(
                params, joptim.trainable_mask(params, peft))
        assert not any(p.requires_grad for n, p in tm.named_parameters()
                       if n.startswith(("cls_head_finetune", "cls_token", "cls_pos"))
                       or ".bnorm." in n)
    finally:
        optim.set_trainable(tm, None)


def test_cross_entropy_loss_acc_matches_jax():
    rng = np.random.default_rng(12)
    logits = rng.standard_normal((6, 5)).astype(np.float32) * 3
    labels = np.array([0, 4, 2, 2, 1, 3], np.int32)
    w_loss, w_acc = j_cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    loss, acc = cross_entropy_loss_acc(torch.tensor(logits), torch.tensor(labels))
    np.testing.assert_allclose(loss.item(), float(w_loss), rtol=1e-6)
    assert acc.item() == float(w_acc)
    assert AccMetric(50.0).better_than(AccMetric(40.0))
    assert not AccMetric(50.0).better_than(AccMetric(50.0))


@pytest.mark.parametrize("k", [1, 3, 4])
def test_adamw_accumulation_matches_jax_across_the_joint_switch(pair, k):
    """``step_per_update`` k against ``build_optimizer`` +
    ``accumulate_every``: 6 calls, the PEFT set for the first 3, then the
    joint set. The switch falls on a real step's boundary at k = 1 and 3,
    and in the middle of an accumulation at k = 4, whose real step (the 4th
    call) leaves the head, frozen by the switch, bit-unchanged. Micro-step
    gradients are summed, the clip and AdamW run on the sum every k-th call,
    the schedule and the Adam counts advance on real steps only. JAX gets
    the gradients the port has: none for a parameter frozen at that call.
    rtol 1e-6 with atol 5e-8, as ``test_adamw_matches_masked_adamw_across_stage2``."""
    _, variables, tm = pair
    config = ConfigDict.from_nested({**CONFIG, "step_per_update": k, "grad_norm_clip": 1.0})
    params = variables["params"]
    rng = np.random.default_rng(40)
    grads = [jax.tree_util.tree_map(
        lambda x: rng.standard_normal(np.shape(x)).astype(np.float32), params)
        for _ in range(6)]
    sets = [PEFT_LIST if i < 3 else JOINT_PEFT_LIST for i in range(6)]

    for i, (g, peft) in enumerate(zip(grads, sets)):
        if i in (0, 3):
            tx, _, mask = joptim.build_optimizer(config, params, 2, peft_list=peft)
            opt_state = tx.init(params) if i == 0 else opt_state
        g = jax.tree_util.tree_map(lambda m, x: x if m else np.zeros_like(x), mask, g)
        updates, opt_state = tx.update(g, opt_state, params)
        params = optax.apply_updates(params, updates)

    state0 = {n: v.clone() for n, v in tm.state_dict().items()}
    steps = []
    try:
        optim.set_trainable(tm, PEFT_LIST)
        opt = optim.build_optimizer(config, tm, steps_per_epoch=2)
        for g, peft in zip(grads, sets):
            optim.set_trainable(tm, peft)
            mapped = _port_state(tm, g, variables)
            opt.zero_grad()
            for n, p in tm.named_parameters():
                if p.requires_grad:                  # backward sums into .grad
                    p.grad = mapped[n].clone() if p.grad is None else p.grad + mapped[n]
            opt.step()
            steps.append(opt.num_steps)
        got = {n: v.clone() for n, v in tm.state_dict().items()}
    finally:
        tm.load_state_dict(state0)
        optim.set_trainable(tm, None)
        tm.zero_grad(set_to_none=True)
    assert steps == [(i + 1) // k for i in range(6)]
    want = _port_state(tm, params, variables)
    moved = 0
    for n, _ in tm.named_parameters():
        np.testing.assert_allclose(got[n].numpy(), want[n].numpy(), rtol=1e-6, atol=5e-8,
                                   err_msg=n)
        moved += not torch.equal(got[n], state0[n])
    assert 20 < moved < len(list(tm.parameters()))
    head = [n for n, _ in tm.named_parameters() if n.startswith("cls_head_finetune")]
    assert head and all(torch.equal(got[n], state0[n]) for n in head) == (k == 4)


def test_unfrozen_tensors_sum_fewer_gradients_than_jax_full_tree(pair):
    """The accepted difference (``optim.py``): ``step_per_update`` k = 4,
    the PEFT set for calls 0-2, the joint set from call 3, the real step at
    call 3; JAX's ``accumulate_every`` gets full-tree gradients at every
    call, the port its own (none for a parameter frozen at that call). No
    clip, so no tensor sees another's gradients. The tensors the switch
    unfreezes differ from JAX's (it sums calls 0-3, the port call 3 alone);
    every other tensor equals JAX's at rtol 1e-6, atol 5e-8, and the head,
    frozen by the switch, is bit-unchanged in both."""
    _, variables, tm = pair
    config = ConfigDict.from_nested({**CONFIG, "step_per_update": 4})
    params = variables["params"]
    rng = np.random.default_rng(41)
    grads = [jax.tree_util.tree_map(
        lambda x: rng.standard_normal(np.shape(x)).astype(np.float32), params)
        for _ in range(4)]
    sets = [PEFT_LIST] * 3 + [JOINT_PEFT_LIST]
    tx, _, _ = joptim.build_optimizer(config, params, 2, peft_list=PEFT_LIST)
    opt_state = tx.init(params)
    for i, g in enumerate(grads):
        if i == 3:
            tx, _, _ = joptim.build_optimizer(config, params, 2, peft_list=JOINT_PEFT_LIST)
        updates, opt_state = tx.update(g, opt_state, params)
        params = optax.apply_updates(params, updates)

    state0 = {n: v.clone() for n, v in tm.state_dict().items()}
    try:
        opt = optim.build_optimizer(config, tm, steps_per_epoch=2)
        for g, peft in zip(grads, sets):
            optim.set_trainable(tm, peft)
            mapped = _port_state(tm, g, variables)
            opt.zero_grad()
            for n, p in tm.named_parameters():
                if p.requires_grad:
                    p.grad = mapped[n].clone() if p.grad is None else p.grad + mapped[n]
            opt.step()
        assert opt.num_steps == 1
        got = {n: v.clone() for n, v in tm.state_dict().items()}
    finally:
        tm.load_state_dict(state0)
        optim.set_trainable(tm, None)
        tm.zero_grad(set_to_none=True)
    want = _port_state(tm, params, variables)
    names = [n for n, _ in tm.named_parameters()]
    unfrozen = {n for n in names if optim.peft_detect(n, JOINT_PEFT_LIST)
                and not optim.peft_detect(n, PEFT_LIST)}
    differ = {n for n in names if not np.allclose(got[n].numpy(), want[n].numpy(),
                                                  rtol=1e-6, atol=5e-8)}
    assert unfrozen and differ == unfrozen
    head = [n for n in names if n.startswith("cls_head_finetune")]
    assert head and all(torch.equal(got[n], state0[n]) for n in head)
    assert all(not torch.equal(got[n], state0[n]) for n in unfrozen)


FETCH_STEPS = 40


def test_divergence_is_logged_within_the_fetch_lag(pair, tmp_path, monkeypatch):
    """``run_net`` fetches a step's metrics ``FETCH_LAG`` (16) steps after
    its dispatch: a loss that turns NaN at step 3 of a 40-step epoch is
    logged as ``[DIVERGED]`` before step 20 is dispatched (counted by the
    dispatched steps, not by time), and the epoch's other losses average."""
    dispatched, logged = [], []

    def fake_train_step(model, optimizer, config, args):
        def step(pts, label):
            dispatched.append(len(dispatched))
            bad = len(dispatched) == 4
            return {"loss": torch.tensor(float("nan") if bad else 1.0), "acc": torch.tensor(50.0)}
        return step

    def record(msg, logger=None):
        logged.append((msg, len(dispatched)))

    monkeypatch.setattr(runner_cls, "make_train_step", fake_train_step)
    monkeypatch.setattr(runner_cls, "validate", lambda *a, **k: AccMetric(0.0))
    monkeypatch.setattr(runner_cls, "print_log", record)
    base = {"NAME": "Synthetic", "N_POINTS": 64, "NUM_CATEGORY": 5, "SIZE": FETCH_STEPS}
    config = ConfigDict.from_nested({
        **CONFIG, "model": SMALL, "max_epoch": 0,
        "dataset": {s: {"_base_": base, "others": {"subset": s, "bs": 1}}
                    for s in ("train", "val")}})
    args = types.SimpleNamespace(seed=0, device="cpu", experiment_path=str(tmp_path))
    runner_cls.run_net(args, config)
    assert len(dispatched) == FETCH_STEPS
    (when,) = [n for msg, n in logged if "[DIVERGED]" in msg and "step 3:" in msg]
    assert when <= 20 and runner_cls.FETCH_LAG == 16
    (epoch,) = [msg for msg, _ in logged if msg.startswith("[Training] EPOCH: 0")]
    assert "nan" in epoch


def test_resume_of_a_checkpoint_without_a_step_count(pair, tmp_path):
    """An optimizer state saved without ``num_steps`` (the layout before
    the count was saved) resumes at start_epoch x steps_per_epoch real
    steps, so the schedule does not restart its warm-up; a saved count is
    taken as it is."""
    _, _, tm = pair
    config = ConfigDict.from_nested(CONFIG)
    opt = optim.build_optimizer(config, tm, steps_per_epoch=5)
    opt.num_steps = 7
    ckpt.save_checkpoint(tm, opt, 2, "ckpt-last", str(tmp_path))
    ckpt.wait_for_pending_saves()          # the write is asynchronous
    saved = torch.load(tmp_path / "ckpt-last.pth", map_location="cpu", weights_only=True)
    assert saved["optimizer"]["num_steps"] == 7
    for with_count, want in ((True, 7), (False, 15)):
        if not with_count:
            del saved["optimizer"]["num_steps"]
            torch.save(saved, tmp_path / "ckpt-last.pth")
        fresh = optim.build_optimizer(config, tm, steps_per_epoch=5)
        assert ckpt.resume_checkpoint(tm, fresh, str(tmp_path), steps_per_epoch=5)[0] == 3
        assert fresh.num_steps == want and fresh.calls == want


def test_ckpts_reference_keys_load_as_in_jax(pair, tmp_path):
    """A ``.pth`` with the reference's layout (``base_model``, keys under
    ``module.``) loads into the port and, through
    ``upp_tpu.train.ckpt_io.load_weights``, into the JAX variables: equal
    weights, nothing missing or unexpected."""
    jm, variables, tm = pair
    other = random_jax_variables(jm, NPOINTS, NPOINTS + 72, seed=9)
    source = state_dict_from_jax(other, tm)
    path = tmp_path / "ref.pth"
    torch.save({"base_model": {f"module.{k}": v for k, v in source.items()}, "epoch": 3},
               path)
    j_vars, j_missing, j_unexpected = j_load_weights(variables, str(path))
    assert j_missing == [] and j_unexpected == []
    want = state_dict_from_jax(j_vars, tm)

    fresh = build_model_from_cfg(SMALL)
    missing, unexpected = ckpt_io.load_weights(fresh, str(path))
    assert missing == [] and unexpected == []
    for k, v in fresh.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            torch.testing.assert_close(v, want[k], rtol=0, atol=0, msg=k)
            torch.testing.assert_close(v, source[k], rtol=0, atol=0, msg=k)


def test_ckpts_report_unknown_and_misshapen_keys(pair, tmp_path):
    """A key the model lacks and one whose shape differs (a 40-class head
    into a 5-class model) are unexpected, never fatal; the keys they leave
    unfilled are missing; ``model.`` and ``MAE_encoder.`` prefixes go."""
    _, _, tm = pair
    state = {f"MAE_encoder.{k}": v.clone() for k, v in tm.state_dict().items()}
    state["MAE_encoder.cls_head_finetune.8.weight"] = torch.zeros(40, 256)
    state["MAE_encoder.increase_dim.0.weight"] = torch.zeros(3, 3)
    path = tmp_path / "odd.pth"
    torch.save({"model": state}, path)
    fresh = build_model_from_cfg(SMALL)
    missing, unexpected = ckpt_io.load_weights(fresh, str(path))
    assert missing == ["cls_head_finetune.8.weight"]
    assert sorted(unexpected) == [
        "cls_head_finetune.8.weight (shape (40, 256) vs model (5, 256))",
        "increase_dim.0.weight"]
    torch.testing.assert_close(fresh.cls_token, tm.cls_token, rtol=0, atol=0)


def _pretask_cfg():
    cfg = yaml.safe_load(open(REPO / "cfgs/pretask_synthetic.yaml"))
    base = {"NAME": "Synthetic", "N_POINTS": 1024, "NUM_CATEGORY": 5, "SIZE": 2}
    for split in ("train", "val", "test"):
        cfg["dataset"][split]["_base_"] = base
        cfg["dataset"][split]["others"]["bs"] = 2
    prompter = {k: v for k, v in SMALL["prompter_config"].items()
                if not k.startswith("downstream")}
    cfg.update(model={**SMALL, "NAME": "Point_MAE_pretask_dev", "prompter_config": prompter},
               npoints=128, max_epoch=0)
    return ConfigDict.from_nested(cfg)


def test_pretask_ckpt_best_loads_into_the_classifier(tmp_path):
    """The two-phase workflow: the port's pretask runner writes
    ``ckpt-best.pth``; ``--ckpts`` loads it into ``PointMAEUnify``. What the
    pretask model lacks (the cls tokens and head, the downstream prompts and
    adapters) is missing, nothing is unexpected, and the shared tensors
    carry over."""
    args = types.SimpleNamespace(seed=0, device="cpu", experiment_path=str(tmp_path),
                                 noise=True, noise_type=["gaussian_noise", "lidar_noise"])
    runner_pretask.run_net(args, _pretask_cfg())
    path = tmp_path / "ckpt-best.pth"
    saved = torch.load(path, map_location="cpu", weights_only=True)["base_model"]

    config = ConfigDict.from_nested({"model": SMALL})
    model = runner_cls.init_model(types.SimpleNamespace(seed=1, ckpts=str(path)), config,
                                  torch.device("cpu"))
    fresh = build_model_from_cfg(SMALL)
    missing, unexpected = ckpt_io.load_weights(fresh, str(path))
    assert unexpected == []
    assert set(missing) == set(fresh.state_dict()) - set(saved)
    assert {k.split(".")[0] for k in missing} == {"cls_token", "cls_pos",
                                                  "cls_head_finetune", "blocks"}
    assert all("downstream" in k for k in missing if k.startswith("blocks."))
    for k, v in saved.items():
        torch.testing.assert_close(model.state_dict()[k], v, rtol=0, atol=0, msg=k)


def test_test_vote_matches_jax(pair):
    """``test_vote`` with the JAX package's draws (its keys: ``fold_in`` of
    the vote's running index, split into the FPS-column pick and the
    scale-translate) gives the JAX function's accuracy, and every vote's
    logits match JAX's at rtol = atol = 1e-4."""
    jm, variables, tm = pair
    base = {"NAME": "Synthetic", "N_POINTS": 1024, "NUM_CATEGORY": 5, "SIZE": 6}
    config = ConfigDict.from_nested({"npoints": NPOINTS})
    args = types.SimpleNamespace(seed=2)
    times, bs = 3, 3
    state = TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                       opt_state=None, step=0)
    want_acc = j_test_vote(jm, state,
                           JBatchLoader(j_build_dataset(base, {"subset": "test"}), bs),
                           config, args, times=times)

    rng = jax.random.key(args.seed + 4242)
    point_all = point_all_for(NPOINTS, 1024)
    draws, want_logits = [], []
    loader = BatchLoader(build_dataset_from_cfg(base, {"subset": "test"}), bs)
    vote = 0
    for pts, _ in loader:
        for _ in range(times):
            vote += 1
            k1, k2 = jax.random.split(jax.random.fold_in(rng, vote))
            a1, a2 = jax.random.split(k2)
            draws.append(CorruptDraws(
                choice=torch.tensor(np.asarray(jax.random.permutation(k1, point_all)[:NPOINTS])),
                aug_scale=torch.tensor(np.asarray(
                    jax.random.uniform(a1, (bs, 1, 3), jnp.float32, 2 / 3, 3 / 2))),
                aug_shift=torch.tensor(np.asarray(
                    jax.random.uniform(a2, (bs, 1, 3), jnp.float32, -0.2, 0.2)))))
            points = j_scale_translate(k2, j_subsample(k1, jnp.asarray(pts), NPOINTS))
            want_logits.append(np.asarray(jm.apply(variables, points, deterministic=True)))

    got_logits = []
    hook = tm.register_forward_hook(lambda m, i, o: got_logits.append(o.numpy().copy()))
    try:
        acc = runner_cls.test_vote(tm, loader, config, args, torch.device("cpu"),
                                   times=times, draws=draws)
    finally:
        hook.remove()
    assert len(got_logits) == len(want_logits) == 2 * times
    for got, want in zip(got_logits, want_logits):
        np.testing.assert_allclose(got, want, **TOL)
    assert acc == want_acc


def _small_yaml(tmp_path, name, max_epoch):
    """4 training clouds (2 steps of 2), 10 validation and test clouds."""
    cfg = yaml.safe_load(open(REPO / "cfgs/unify_synthetic_cls.yaml"))
    for split in ("train", "val", "test"):
        cfg["dataset"][split]["_base_"] = {"NAME": "Synthetic", "N_POINTS": 1024,
                                           "NUM_CATEGORY": 5,
                                           "SIZE": 4 if split == "train" else 10}
    cfg.update(model=SMALL, npoints=NPOINTS, total_bs=2, max_epoch=max_epoch)
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def test_cli_trains_resumes_and_votes_on_cpu(tmp_path, monkeypatch):
    """``--peft_model`` training for epochs 0 and 1 with the joint switch
    after epoch 0 writes ``ckpt-best.pth`` and ``ckpt-last.pth``; a resumed
    run continues at epoch 2 in the joint set with the Adam moments and the
    step count restored; ``--test --vote --ckpts`` evaluates the result."""
    monkeypatch.chdir(tmp_path)
    from upp_torch.main import main
    best = main(["--peft_model", "--config", str(_small_yaml(tmp_path, "small_cls", 1)),
                 "--device", "cpu", "--joint_optimization", "0"])
    assert isinstance(best, AccMetric) and 0.0 < best.acc <= 100.0
    (run,) = tmp_path.glob("experiments/small_cls/plain-network/peft-retrain/*")
    saved = torch.load(run / "ckpt-last.pth", map_location="cpu", weights_only=True)
    assert set(saved) == {"base_model", "optimizer", "epoch", "metrics"}
    assert saved["epoch"] == 1 and saved["optimizer"]["num_steps"] == 4
    assert (run / "ckpt-best.pth").exists()
    log = (run / "small_cls.log").read_text()
    assert "[joint optimization] switching trainable set" in log and "EPOCH: 1" in log

    config = cfg_from_yaml_file(str(_small_yaml(tmp_path, "small_cls", 2)))
    for split in ("train", "val", "test"):
        config.dataset[split].others.bs = 2
    args = types.SimpleNamespace(seed=0, device="cpu", experiment_path=str(run), resume=True,
                                 peft_model=True, joint_optimization=0, log_name="small_cls")
    runner_cls.run_net(args, config)
    resumed = torch.load(run / "ckpt-last.pth", map_location="cpu", weights_only=True)
    assert resumed["epoch"] == 2 and resumed["optimizer"]["num_steps"] == 6
    head = [k for k in saved["base_model"] if k.startswith("cls_head_finetune.")
            and not k.endswith(("running_mean", "running_var", "num_batches_tracked"))]
    assert head and all(torch.equal(saved["base_model"][k], resumed["base_model"][k])
                        for k in head)                 # frozen in the joint set
    assert not torch.equal(saved["base_model"]["coarse_pred.0.weight"],
                           resumed["base_model"]["coarse_pred.0.weight"])

    acc = main(["--test", "--vote", "--peft_model", "--device", "cpu",
                "--config", str(_small_yaml(tmp_path, "small_cls_test", 1)),
                "--ckpts", str(run / "ckpt-best.pth")])
    assert 0.0 <= acc <= 100.0
    (test_log,) = tmp_path.glob("experiments/small_cls_test/ckpt-best/**/small_cls_test.log")
    text = test_log.read_text()
    assert "[TEST_VOTE] acc =" in text and "missing_keys" not in text


def test_unported_models_and_tasks_raise():
    """A model name that no package registers is refused by name."""
    config = cfg_from_yaml_file(str(REPO / "cfgs/finetune_modelnet_cls.yaml"))
    config.model.NAME = "Point_MAE_unregistered"
    with pytest.raises(NotImplementedError, match="Point_MAE_unregistered"):
        runner_cls.init_model(types.SimpleNamespace(seed=0), config, torch.device("cpu"))
