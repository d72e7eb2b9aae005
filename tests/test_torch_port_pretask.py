"""The port's pretask slice against the JAX package on CPU, at a small size:
``PointMAEPretask`` (train-mode noise branch and eval), one pretask train
step with JAX's draws, the trainable and decay sets, the schedule, AdamW
across the stage-2 switch, the eval step, the weight mapping, and the CLI.

Train mode is compared with dropout off on both sides and drop-path rate 0
(the two packages draw from different generators); BatchNorm runs on batch
statistics. Forward values hold at rtol = atol = 1e-4 (the classifier
tests' bound). Gradients hold per element at rtol 1e-3 with an atol of 1e-6
plus ``GRAD_SCALE_ATOL`` of the tensor's largest gradient (an element that
cancels to near zero keeps the float32 rounding of the tensor's largest
terms; the loss is O(1e3) here), and as a whole within 1e-4 relative
(global norm of the difference). The JAX CPU path ranks kNN and Chamfer
neighbours by the matmul form of the distance, the port by the difference
form, and the two round differently."""

import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml
from flax import linen as fnn

from test_torch_port_model import TOL, build_pair
from upp_tpu.models import scan_blocks as j_scan_blocks
from upp_tpu.train import optim as joptim
from upp_tpu.train.runner_pretask import make_pretask_eval_step as j_make_eval_step
from upp_tpu.train.runner_pretask import make_pretask_train_step as j_make_train_step
from upp_tpu.train.state import TrainState
from upp_tpu.train.torch_export import export_torch_state_dict
from upp_tpu.utils.config import ConfigDict
from upp_torch.data import build_dataset_from_cfg
from upp_torch.train import optim, runner_pretask
from upp_torch.train.runner_pretask import (GAUSSIAN_NUM, LIDAR_NUM, PRETASK_PEFT_LIST,
                                            PRETASK_STAGE2_LIST, PretaskDraws)
from upp_torch.utils.config import cfg_from_yaml_file
from upp_torch.weights import state_dict_from_jax

REPO = Path(__file__).resolve().parent.parent
TINY_PT = {
    "NAME": "Point_MAE_pretask_dev",
    "transformer_config": {
        "mask_ratio": 0.5, "mask_type": "rand", "trans_dim": 48,
        "encoder_dims": 48, "depth": 3, "drop_path_rate": 0.0,
        "num_heads": 4, "decoder_depth": 2, "decoder_num_heads": 4},
    "group_size": 8, "num_group": 64,
    "prompter_config": {
        "rectify_adapter": True, "rectify_prompts": True,
        "rectify_prompts_num": 2, "rectify_prompts_depth": 2, "rectify_depth": 2,
        "pretask_adapter": True, "pretask_prompts": True,
        "pretask_prompts_num": 2, "pretask_prompts_depth": 3, "pretask_depth": 3},
    "gather_idx": True, "prompt_propagation_after": True,
}
POINT_NUM = 128
N_IN = POINT_NUM + GAUSSIAN_NUM + LIDAR_NUM
N_GT = 1024                     # num_crop in [153, 512]: both halves hold >= 128
B = 2
GRAD_SCALE_ATOL = 5e-5
INIT_KW = dict(train_with_gaussian=True, deterministic=False)
CONFIG = {
    "optimizer": {"type": "AdamW", "kwargs": {"lr": 1e-3, "weight_decay": 0.05}},
    "scheduler": {"type": "CosLR", "kwargs": {"epochs": 4, "initial_epochs": 1}},
    "dataset": {split: {"_base_": {"NAME": "Synthetic", "N_POINTS": N_GT,
                                   "NUM_CATEGORY": 6, "SIZE": 4},
                        "others": {"subset": "train"}} for split in ("train", "val", "test")},
    "npoints": POINT_NUM, "data_augmentation": "scale-translate",
}


@pytest.fixture(scope="module")
def pair():
    return build_pair(TINY_PT, POINT_NUM, N_IN, seed=3, **INIT_KW)


def no_dropout(model):
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return model


@pytest.fixture
def jax_without_dropout(monkeypatch):
    monkeypatch.setattr(fnn.Dropout, "__call__",
                        lambda self, x, deterministic=None, rng=None: x)
    monkeypatch.setattr(j_scan_blocks, "_dropout",
                        lambda x, rate, rng, deterministic, salt=0: x)


def _gt(size=B, subset="train"):
    ds = build_dataset_from_cfg(CONFIG["dataset"]["train"]["_base_"], {"subset": subset})
    return np.stack([ds[i][2][0] for i in range(size)]).astype(np.float32)


def _noisy_input(seed):
    """A partial cloud followed by shell-like and lidar-like outliers."""
    rng = np.random.default_rng(seed)
    partial = rng.standard_normal((B, POINT_NUM, 3)).astype(np.float32) * 0.5
    shell = rng.normal(0.0, 0.2, (B, GAUSSIAN_NUM, 3)).astype(np.float32) * 4
    lidar = rng.standard_normal((B, LIDAR_NUM, 3)).astype(np.float32) * 1.4
    return np.concatenate([partial, shell, lidar], 1)


def _port_state(tm, variables):
    return state_dict_from_jax(variables, tm)


def test_weights_match_torch_export(pair):
    _, variables, tm = pair
    mine = state_dict_from_jax(variables, tm)
    theirs, report = export_torch_state_dict(variables, template=tm)
    assert report["missing"] == []
    assert set(mine) == set(theirs) == set(tm.state_dict())
    for k, v in mine.items():
        np.testing.assert_array_equal(v.numpy(), theirs[k], err_msg=k)


def test_train_forward_noise_branch_matches_jax(pair, jax_without_dropout):
    """Noise loss, recall, completion outputs and the updated BatchNorm
    running statistics of one train-mode forward."""
    jm, variables, tm = pair
    pts = _noisy_input(4)
    (w_center, w_rebuild, w_nl, w_recall), mut = jm.apply(
        variables, jnp.asarray(pts), point_num=POINT_NUM, train_with_gaussian=True,
        deterministic=False, mutable=["batch_stats"],
        rngs={"dropout": jax.random.key(9), "droppath": jax.random.key(8)})
    state0 = {k: v.clone() for k, v in tm.state_dict().items()}
    no_dropout(tm).train()
    try:
        with torch.no_grad():
            center, rebuild, nl, recall = tm(torch.tensor(pts), point_num=POINT_NUM)
        after = {k: v.clone() for k, v in tm.state_dict().items()}
    finally:
        tm.load_state_dict(state0)
        tm.eval()
    assert abs(recall.item() - float(w_recall)) <= 1.0 / (B * (N_IN - POINT_NUM)) + 1e-7
    np.testing.assert_allclose(nl.item(), float(w_nl), **TOL)
    np.testing.assert_allclose(center.numpy(), np.asarray(w_center), **TOL)
    np.testing.assert_allclose(rebuild.numpy(), np.asarray(w_rebuild), **TOL)
    want_stats = _port_state(tm, {"params": variables["params"],
                                  "batch_stats": mut["batch_stats"]})
    running = [k for k in after if k.endswith(("running_mean", "running_var"))]
    assert running and any(not torch.equal(after[k], state0[k]) for k in running)
    for k in running:
        np.testing.assert_allclose(after[k].numpy(), want_stats[k].numpy(), err_msg=k, **TOL)


def test_eval_forward_matches_jax(pair):
    jm, variables, tm = pair
    pts = _noisy_input(5)[:, :POINT_NUM]
    w_center, w_rebuild = jm.apply(variables, jnp.asarray(pts), point_num=POINT_NUM,
                                   train_with_gaussian=False, deterministic=True)
    with torch.no_grad():
        center, rebuild = tm.eval()(torch.tensor(pts), point_num=POINT_NUM)
    np.testing.assert_allclose(center.numpy(), np.asarray(w_center), **TOL)
    np.testing.assert_allclose(rebuild.numpy(), np.asarray(w_rebuild), **TOL)


def _grad_capture():
    """An optax transform whose state after an update is the gradient."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda grads, state, params=None: (jax.tree_util.tree_map(jnp.zeros_like, grads),
                                           grads))


def _jax_step_draws(rng, step, n_gt):
    """The random numbers of ``upp_tpu``'s pretask train step (its key
    splits), as the port's ``PretaskDraws``."""
    ks = jax.random.split(jax.random.fold_in(rng, step), 8)
    a1, a2 = jax.random.split(ks[0])
    v = jnp.stack([jax.random.normal(k, (3,), jnp.float32)
                   for k in jax.random.split(ks[2], B)])
    l1, l2 = jax.random.split(ks[5])
    t = lambda a: torch.tensor(np.asarray(a))    # noqa: E731
    return PretaskDraws(
        num_crop=int(jax.random.randint(ks[1], (), int(n_gt * 0.15), int(n_gt * 0.5) + 1)),
        viewpoints=t(v / jnp.linalg.norm(v, axis=-1, keepdims=True)),
        shell_u=float(jax.random.uniform(ks[3], ())),
        shell_normal=t(jax.random.normal(ks[4], (B, GAUSSIAN_NUM, 3), jnp.float32)),
        lidar_idx=t(jax.random.randint(l1, (LIDAR_NUM,), 0, POINT_NUM + GAUSSIAN_NUM)),
        lidar_factor=t(jax.random.uniform(l2, (LIDAR_NUM,), jnp.float32, 1.2, 1.5)),
        aug_scale=t(jax.random.uniform(a1, (B, 1, 3), jnp.float32, 2 / 3, 3 / 2)),
        aug_shift=t(jax.random.uniform(a2, (B, 1, 3), jnp.float32, -0.2, 0.2)))


def test_train_step_matches_jax(pair, jax_without_dropout):
    """One step of each package's ``make_pretask_train_step`` on the same
    clouds and draws: the loss terms and the trainable gradients."""
    jm, variables, tm = pair
    config = ConfigDict.from_nested(CONFIG)
    args = types.SimpleNamespace(noise=True, noise_type=["gaussian_noise", "lidar_noise"],
                                 seed=0)
    gt = _gt()
    rng = jax.random.key(21)
    state = TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                       opt_state=_grad_capture().init(variables["params"]),
                       step=jnp.zeros((), jnp.int32))
    j_step = j_make_train_step(jm, _grad_capture(), config, args)
    new_state, aux = j_step(state, jnp.asarray(gt), rng)
    j_grads = _port_state(tm, {"params": new_state.opt_state,
                               "batch_stats": variables["batch_stats"]})

    state0 = {k: v.clone() for k, v in tm.state_dict().items()}
    try:
        optim.set_trainable(no_dropout(tm), PRETASK_PEFT_LIST)
        opt = optim.build_optimizer(config, tm, steps_per_epoch=1)
        terms = runner_pretask.make_pretask_train_step(tm, opt, config, args)(
            torch.tensor(gt), _jax_step_draws(rng, 0, N_GT))
        grads = {n: p.grad.clone() for n, p in tm.named_parameters() if p.grad is not None}
        trainable = {n for n, p in tm.named_parameters() if p.requires_grad}
    finally:
        tm.load_state_dict(state0)
        tm.eval()
        for p in tm.parameters():
            p.requires_grad_(True)
            p.grad = None
    for k in runner_pretask.LOSS_NAMES:
        tol = dict(rtol=0, atol=100.0 / (B * (N_IN - POINT_NUM))) if k == "recall" else \
            dict(rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(terms[k].item(), float(aux[k]), err_msg=k, **tol)
    assert set(grads) == trainable and len(trainable) > 20
    for n in sorted(trainable):
        g, w = grads[n].numpy(), j_grads[n].numpy()
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-6 + GRAD_SCALE_ATOL * np.abs(w).max(),
                                   err_msg=n)
    diff = sum(float(((grads[n] - j_grads[n]) ** 2).sum()) for n in trainable)
    norm = sum(float((j_grads[n] ** 2).sum()) for n in trainable)
    assert np.sqrt(diff / norm) < 1e-4


def test_trainable_and_decay_sets_match_jax(pair):
    _, variables, tm = pair
    params = variables["params"]
    size = lambda tree: sum(int(np.size(x)) for x in jax.tree_util.tree_leaves(tree))  # noqa: E731
    n_params = sum(p.numel() for p in tm.parameters())
    assert n_params == size(params)
    for peft in (PRETASK_PEFT_LIST, PRETASK_STAGE2_LIST, None):
        mask = joptim.trainable_mask(params, peft)
        try:
            optim.set_trainable(tm, peft)
            assert optim.count_params(tm) == joptim.count_params(params, mask)
        finally:
            optim.set_trainable(tm, None)
    decay = joptim.weight_decay_mask(params)
    want = sum(int(np.size(x)) for x, m in zip(jax.tree_util.tree_leaves(params),
                                                jax.tree_util.tree_leaves(decay)) if m)
    opt = optim.build_optimizer(ConfigDict.from_nested(CONFIG), tm, steps_per_epoch=1)
    groups = {g["weight_decay"]: sum(p.numel() for p in g["params"])
              for g in opt.optimizer.param_groups}
    assert groups == {0.05: want, 0.0: n_params - want}


SCHEDULES = [
    {"type": "CosLR", "kwargs": {"epochs": 5, "initial_epochs": 2}},
    {"type": "CosLR", "kwargs": {"epochs": 4}},
    {"type": "LambdaLR", "kwargs": {"decay_step": 2, "lr_decay": 0.7, "lowest_decay": 0.1}},
    {"type": "StepLR", "kwargs": {"step_size": 2, "gamma": 0.5}},
    {"type": "function"},
]


@pytest.mark.parametrize("sched_cfg", SCHEDULES, ids=lambda c: c["type"])
def test_schedule_matches_jax(sched_cfg):
    opti = ConfigDict.from_nested({"kwargs": {"lr": 1e-3}})
    sche = ConfigDict.from_nested(sched_cfg)
    mine = optim.build_schedule(opti, sche, steps_per_epoch=3)
    theirs = joptim.build_schedule(opti, sche, steps_per_epoch=3)
    # the JAX schedule computes in float32
    for step in range(25):
        np.testing.assert_allclose(mine(step), float(theirs(jnp.int32(step))), rtol=1e-6,
                                   err_msg=str(step))


def test_adamw_matches_masked_adamw_across_stage2(pair):
    """3 steps with the stage-1 trainable set, the switch, 2 steps with the
    stage-2 set; the same gradients every step (frozen parameters get none
    in the port). rtol 1e-6 with atol 5e-8, a few float32 ulps at the
    parameters' scale of 0.1 (7.5e-9 each): a value that passes near zero
    keeps the rounding of the steps that brought it there."""
    _, variables, tm = pair
    config = ConfigDict.from_nested(CONFIG)
    params = variables["params"]
    rng = np.random.default_rng(30)
    grads = [jax.tree_util.tree_map(
        lambda x: rng.standard_normal(np.shape(x)).astype(np.float32), params)
        for _ in range(5)]

    tx, _, _ = joptim.build_optimizer(config, params, 2, peft_list=PRETASK_PEFT_LIST)
    opt_state = tx.init(params)
    for i, g in enumerate(grads):
        if i == 3:
            tx, _, _ = joptim.build_optimizer(config, params, 2, peft_list=PRETASK_STAGE2_LIST)
        updates, opt_state = tx.update(g, opt_state, params)
        params = optax.apply_updates(params, updates)

    state0 = {k: v.clone() for k, v in tm.state_dict().items()}
    try:
        optim.set_trainable(tm, PRETASK_PEFT_LIST)
        opt = optim.build_optimizer(config, tm, steps_per_epoch=2)
        for i, g in enumerate(grads):
            if i == 3:
                optim.set_trainable(tm, PRETASK_STAGE2_LIST)
            mapped = _port_state(tm, {"params": g, "batch_stats": variables["batch_stats"]})
            opt.zero_grad()
            for n, p in tm.named_parameters():
                if p.requires_grad:
                    p.grad = mapped[n].clone()
            opt.step()
        got = {k: v.clone() for k, v in tm.state_dict().items()}
    finally:
        tm.load_state_dict(state0)
        optim.set_trainable(tm, None)
    want = _port_state(tm, {"params": params, "batch_stats": variables["batch_stats"]})
    moved = 0
    for n, _ in tm.named_parameters():
        np.testing.assert_allclose(got[n].numpy(), want[n].numpy(), rtol=1e-6, atol=5e-8,
                                   err_msg=n)
        moved += not torch.equal(got[n], state0[n])
    assert 20 < moved < len(list(tm.parameters()))


@pytest.mark.parametrize("vp", [(1, 1, 1), (-1, 1, -1)])
def test_eval_step_matches_jax(pair, vp):
    jm, variables, tm = pair
    config = ConfigDict.from_nested(CONFIG)
    gt = _gt(subset="test")
    want = j_make_eval_step(jm, config, "easy")(variables, jnp.asarray(gt),
                                                 jnp.asarray(vp, jnp.float32))
    got = runner_pretask.make_pretask_eval_step(tm, config, "easy")(
        torch.tensor(gt), torch.tensor(vp, dtype=torch.float32))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **TOL)


def _tiny_yaml(tmp_path, name):
    cfg = yaml.safe_load(open(REPO / "cfgs/pretask_synthetic.yaml"))
    for split in ("train", "val", "test"):
        cfg["dataset"][split]["_base_"] = CONFIG["dataset"][split]["_base_"]
    cfg.update(model=TINY_PT, npoints=POINT_NUM, total_bs=2, max_epoch=0)
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def test_cli_trains_and_tests_on_cpu(tmp_path, monkeypatch):
    """One epoch writes ckpt-last.pth in the reference layout; --test prints
    the TEST RESULTS table."""
    monkeypatch.chdir(tmp_path)
    from upp_torch.main import main
    best = main(["--config", str(_tiny_yaml(tmp_path, "tiny_pretask_train")),
                 "--device", "cpu"])
    assert np.isfinite(best.cd)
    (last,) = tmp_path.glob("experiments/tiny_pretask_train/**/ckpt-last.pth")
    saved = torch.load(last, map_location="cpu", weights_only=True)
    assert set(saved) == {"base_model", "optimizer", "epoch", "metrics"}
    assert saved["epoch"] == 0 and "blocks.blocks.0.pretask_prompts" in saved["base_model"]
    assert saved["optimizer"]["state"]                  # Adam moments were written

    cd = main(["--test", "--config", str(_tiny_yaml(tmp_path, "tiny_pretask_test")),
               "--device", "cpu"])
    assert np.isfinite(cd.cd)
    (log,) = tmp_path.glob("experiments/tiny_pretask_test/**/tiny_pretask_test.log")
    text = log.read_text()
    assert "TEST RESULTS" in text and "Overall" in text and "F-Score" in text


def test_resume_restores_model_optimizer_and_epoch(tmp_path, pair):
    _, _, tm = pair
    from upp_torch.train import checkpoint as ckpt
    config = ConfigDict.from_nested(CONFIG)
    opt = optim.build_optimizer(config, tm, steps_per_epoch=1)
    for p in tm.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    ckpt.save_checkpoint(tm, opt, 3, "ckpt-last", str(tmp_path), metrics={"cd": 1.5})
    fresh = type(tm)(TINY_PT)
    fresh_opt = optim.build_optimizer(config, fresh, steps_per_epoch=1)
    start, metrics = ckpt.resume_checkpoint(fresh, fresh_opt, str(tmp_path))
    assert (start, metrics) == (4, {"cd": 1.5})
    for (k, a), b in zip(tm.state_dict().items(), fresh.state_dict().values()):
        assert torch.equal(a, b), k
    assert len(fresh_opt.optimizer.state) == len(opt.optimizer.state) > 0
    assert ckpt.resume_checkpoint(fresh, fresh_opt, str(tmp_path / "none")) == (0, {})
    tm.zero_grad(set_to_none=True)


def test_pretask_entry_points_never_fall_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = cfg_from_yaml_file(str(REPO / "cfgs/pretask_synthetic.yaml"))
    args = types.SimpleNamespace(seed=0)
    for entry in (runner_pretask.run_net, runner_pretask.test_net):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry(args, config)


def test_only_adamw_and_single_step_updates_are_ported(pair):
    _, _, tm = pair
    for change in ({"optimizer": {"type": "SGD", "kwargs": {"lr": 0.1}}},
                   {"step_per_update": 2}):
        with pytest.raises(NotImplementedError):
            optim.build_optimizer(ConfigDict.from_nested({**CONFIG, **change}), tm, 1)
