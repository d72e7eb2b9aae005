"""MAE pretraining and the full fine-tune of the port on CPU against the JAX
package, at a small size (the models of ``test_torch_port_baseline.py``:
trans_dim 48, depth 3, 16 groups of 8; 512-point ``Synthetic`` clouds, FPS
to 128, batch 4), on the same clouds and on the JAX step's draws:

* one ``runner_pretrain.make_pretrain_step`` (FPS, scale-translate,
  ``Point_MAE`` in train mode on a given group split, CD-L2, backward):
  loss, the encoder's BatchNorm statistics and every gradient;
* the SVM probe's features and its accuracy on separable classes;
* one ``runner_cls.make_train_step`` of ``PointTransformer`` on the twin of
  ``cfgs/finetune_modelnet_cls.yaml`` (crop, noise, augmentation, every
  parameter trainable): loss, accuracy and every gradient;
* the CLI on the CPU: ``task: pretrain`` with the probe; a warm start from
  a ``Point_MAE`` checkpoint; the two stages, ``task: pretrain`` then
  ``--finetune_model --ckpts`` its ``ckpt-last.pth`` and ``--test``.

The JAX steps run jitted: neither model has the top-5% drop whose near ties
make the classification step's test run JAX op by op. Gradients are held to
JAX's alone, for the port's float32 and float64 steps, per element (rtol
1e-3, atol 1e-6 plus ``scale`` of the tensor's largest gradient), per
tensor (relative norm) and as a whole (``GRAD_TOL``), about 5 and 3 times
what was measured at this size on the CPU. Pretrain: the port sits at most
1.2e-6 of a tensor's largest gradient, 2.0e-6 of its norm and 9e-7 as a
whole from JAX. Fine-tune: 3.5e-4, 1.5e-4 and 8.3e-5, JAX's float32 being
the noisier side (the port's float32 step is 2.1e-5 per tensor from its
float64 one), as in ``test_torch_port_cls_step.py``. A gradient that
vanishes (below 1e-6 of the largest, in the float64 step: the biases right
before a train-mode BatchNorm) is held at noise level. Losses, statistics
and features hold at ``test_torch_port_model.TOL``."""

import copy
import re
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import linen as fnn

from test_torch_port_baseline import MAE_SMALL, PT_SMALL, _masks, mae_pair
from test_torch_port_cls_train import _jnp
from test_torch_port_model import TOL, build_pair
from test_torch_port_pretask import _grad_capture
from test_torch_port_slice import _jax_draws, jax_aug_draws
from upp_tpu.data import BatchLoader as JBatchLoader
from upp_tpu.data import build_dataset_from_cfg as j_build_dataset
from upp_tpu.models import baseline as j_baseline
from upp_tpu.ops.fps import fps as j_fps
from upp_tpu.train import runner_pretrain as j_runner_pretrain
from upp_tpu.train.runner_cls import make_train_step as j_make_train_step
from upp_tpu.train.state import TrainState
from upp_tpu.utils.config import ConfigDict
from upp_torch.data import BatchLoader, build_dataset_from_cfg
from upp_torch.train import optim, runner_cls, runner_pretrain
from upp_torch.train.pipeline import AugmentDraws
from upp_torch.weights import state_dict_from_jax

REPO = Path(__file__).resolve().parent.parent
B = 4
N_DS = 512
NPOINTS = 128
KEY = 31
AUG = "scale-translate"
SYNTH = {"NAME": "Synthetic", "N_POINTS": N_DS, "NUM_CATEGORY": 5, "SIZE": B}
BASE = {
    "optimizer": {"type": "AdamW", "kwargs": {"lr": 1e-3, "weight_decay": 0.05}},
    "scheduler": {"type": "CosLR", "kwargs": {"epochs": 4, "initial_epochs": 1}},
    "dataset": {s: {"_base_": SYNTH, "others": {"subset": "train"}}
                for s in ("train", "val", "test")},
    "npoints": NPOINTS, "data_augmentation": AUG,
}
PRETRAIN = {**BASE, "model": MAE_SMALL}
FINETUNE = {**BASE, "model": PT_SMALL, "noisy_train": True, "noisy_validate": False,
            "optimizer": {"type": "AdamW", "kwargs": {"lr": 5e-4, "weight_decay": 0.05}}}
ARGS = types.SimpleNamespace(seed=0, noise=True, noise_type=["gaussian_noise", "lidar_noise"],
                             incomplete_cropping=True, normalize=False)
LABELS = np.array([3, 1, 0, 4], np.int32)
# per-element atol 1e-6 + scale x the tensor's largest gradient, per-element
# rtol, the relative bound on each tensor's norm and on the whole
GRAD_TOL = {"pretrain": dict(scale=1e-5, rtol=1e-3, tensor=1e-5, glob=5e-6),
            "finetune": dict(scale=1e-3, rtol=1e-3, tensor=5e-4, glob=3e-4)}


def _clouds(size=B, subset="train", n=N_DS):
    ds = build_dataset_from_cfg({**SYNTH, "N_POINTS": n, "SIZE": size}, {"subset": subset})
    return np.stack([ds[i][2][0] for i in range(size)]).astype(np.float32)


def _global(a, b, names):
    num = sum(float(((a[n] - b[n]) ** 2).sum()) for n in names)
    return np.sqrt(num / sum(float((b[n] ** 2).sum()) for n in names))


def _hold_grads(name, grads, exact, j_grads):
    """Every gradient of the port's float32 (``grads``) and float64
    (``exact``) steps against JAX's, at ``GRAD_TOL[name]``."""
    assert set(grads) == set(exact) and len(grads) > 40
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


def _state(variables):
    return TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                      opt_state=_grad_capture().init(variables["params"]),
                      step=jnp.zeros((), jnp.int32))


@pytest.fixture(scope="module")
def pretrain_jax():
    """(port model, JAX gradients and statistics as the port's state dict,
    JAX loss, the group split) of one jitted ``upp_tpu`` pretrain step on
    ``_clouds()`` with the split patched in."""
    jm, np_vars, tm = mae_pair(seed=44)
    vis, mask = _masks(12)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_baseline.PointMAE, "_rand_mask_idx",
                   lambda self, b: (jnp.asarray(vis), jnp.asarray(mask)))
        step = j_runner_pretrain.make_pretrain_step(jm, _grad_capture(),
                                                    ConfigDict.from_nested(PRETRAIN))
        new_state, aux = step(_state(_jnp(np_vars)), jnp.asarray(_clouds()),
                              jax.random.key(KEY))
    grads = state_dict_from_jax({"params": new_state.opt_state,
                                 "batch_stats": np_vars["batch_stats"]}, tm)
    stats = state_dict_from_jax({"params": np_vars["params"],
                                 "batch_stats": new_state.batch_stats}, tm)
    return tm, grads, stats, float(aux["loss"]), (vis, mask)


def _port_pretrain_step(tm, masks, dtype):
    model = copy.deepcopy(tm).to(dtype)
    k_aug = jax.random.split(jax.random.fold_in(jax.random.key(KEY), 0), 4)[0]
    draws = AugmentDraws(**{k: v.to(dtype) for k, v in
                            jax_aug_draws(k_aug, AUG, B, NPOINTS).items()})
    config = ConfigDict.from_nested(PRETRAIN)
    opt = optim.build_optimizer(config, model, steps_per_epoch=1)
    step = runner_pretrain.make_pretrain_step(model, opt, config, ARGS)
    out = step(torch.tensor(_clouds(), dtype=dtype), draws,
               tuple(torch.tensor(m).long() for m in masks))
    grads = {n: p.grad.double() for n, p in model.named_parameters() if p.grad is not None}
    return out, grads, model


def test_pretrain_step_matches_jax(pretrain_jax):
    """One step of each package's pretrain step on the same clouds, group
    split and augmentation draws: the loss, every parameter's gradient and
    the encoder's updated BatchNorm statistics."""
    tm, j_grads, j_stats, j_loss, masks = pretrain_jax
    out, grads, model = _port_pretrain_step(tm, masks, torch.float32)
    _, exact, _ = _port_pretrain_step(tm, masks, torch.float64)
    np.testing.assert_allclose(out["loss"].item(), j_loss, **TOL)
    assert set(grads) == {n for n, _ in model.named_parameters()}
    _hold_grads("pretrain", grads, exact, j_grads)
    running = {k: v for k, v in model.state_dict().items() if "running_" in k}
    assert len(running) == 4
    for k, v in running.items():
        np.testing.assert_allclose(v.numpy(), j_stats[k].numpy(), **TOL, err_msg=k)


def test_pretrain_step_draws_from_its_seeded_generator(pretrain_jax):
    """Without given draws the augmentation, the group split and drop-path
    come from the step's generator: two runs from the same weights and
    seed give the same loss, and the parameters move."""
    tm = pretrain_jax[0]
    config = ConfigDict.from_nested({**PRETRAIN, "model": {
        **MAE_SMALL, "transformer_config": {**MAE_SMALL["transformer_config"],
                                            "drop_path_rate": 0.2}}})
    losses = []
    for _ in range(2):
        model = copy.deepcopy(tm)
        opt = optim.build_optimizer(config, model, steps_per_epoch=1)
        step = runner_pretrain.make_pretrain_step(model, opt, config, ARGS)
        losses.append([float(step(torch.tensor(_clouds()))["loss"]) for _ in range(2)])
    assert losses[0] == losses[1] and losses[0][0] != losses[0][1]
    moved = [n for (n, a), b in zip(model.state_dict().items(), tm.state_dict().values())
             if not torch.equal(a, b)]
    assert len(moved) > 40


def _probe_loaders(pkg_loader, build):
    """(extra_train, val) loaders over two separable ``Synthetic`` splits."""
    return tuple(pkg_loader(build({**SYNTH, "SIZE": 20}, {"subset": s}), 8)
                 for s in ("train", "test"))


def test_svm_probe_matches_jax(pretrain_jax):
    """The probe's features of the port and of JAX on the same clouds and
    weights, and the accuracy of each package's LinearSVC fit."""
    pytest.importorskip("sklearn")
    jm, np_vars, tm = mae_pair(seed=44)
    device = torch.device("cpu")
    extra, val = _probe_loaders(BatchLoader, build_dataset_from_cfg)
    got, labels = runner_pretrain.probe_features(tm, val, NPOINTS, device)

    def j_features(pts):
        points, _ = j_fps(jnp.asarray(pts), NPOINTS)
        return jm.apply(np_vars, points, eval_features=True, deterministic=True)

    want = np.concatenate([np.asarray(j_features(pts)) for pts, _ in val])
    np.testing.assert_allclose(got, want, **TOL)
    assert labels.shape == (20,) and len(set(labels)) == 5
    np.random.seed(0)
    acc = runner_pretrain.svm_probe(tm, extra, val, NPOINTS, device)
    np.random.seed(0)
    j_extra, j_val = _probe_loaders(JBatchLoader, j_build_dataset)
    j_acc = j_runner_pretrain.svm_probe(jm, TrainState(
        params=np_vars["params"], batch_stats=np_vars["batch_stats"], opt_state=None,
        step=jnp.zeros((), jnp.int32)), j_extra, j_val, NPOINTS)
    assert acc == j_acc and acc > 60.0


@pytest.fixture(scope="module")
def finetune_jax():
    """(port model, JAX gradients, JAX loss/acc) of one jitted ``upp_tpu``
    cls train step of ``PointTransformer`` with dropout off."""
    jm, np_vars, tm = build_pair(PT_SMALL, None, NPOINTS, seed=45, deterministic=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, deterministic=None, rng=None: x)
        step = j_make_train_step(jm, _grad_capture(), ConfigDict.from_nested(FINETUNE), ARGS)
        new_state, aux = step(_state(_jnp(np_vars)), jnp.asarray(_clouds()),
                              jnp.asarray(LABELS), jax.random.key(KEY))
    grads = state_dict_from_jax({"params": new_state.opt_state,
                                 "batch_stats": np_vars["batch_stats"]}, tm)
    return tm, grads, {k: float(v) for k, v in aux.items()}


def _port_finetune_step(tm, dtype):
    model = copy.deepcopy(tm).to(dtype)
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    k_pipe = jax.random.split(jax.random.fold_in(jax.random.key(KEY), 0), 3)[0]
    draws = _jax_draws(k_pipe, B, NPOINTS, AUG)
    draws = type(draws)(**{k: v.to(dtype) if torch.is_tensor(v) and v.is_floating_point()
                           else v for k, v in vars(draws).items()})
    config = ConfigDict.from_nested(FINETUNE)
    optim.set_trainable(model, None)
    opt = optim.build_optimizer(config, model, steps_per_epoch=1)
    out = runner_cls.make_train_step(model, opt, config, ARGS)(
        torch.tensor(_clouds(), dtype=dtype), torch.tensor(LABELS), draws)
    return out, {n: p.grad.double() for n, p in model.named_parameters() if p.grad is not None}


def test_finetune_cls_step_matches_jax(finetune_jax):
    """One ``make_train_step`` of ``PointTransformer`` in each package on
    the same clouds, labels and draws (viewpoint crop to 128 points, +48
    lidar and +24 shell points, scale-translate): loss, accuracy and the
    gradient of every parameter."""
    tm, j_grads, aux = finetune_jax
    out, grads = _port_finetune_step(tm, torch.float32)
    _, exact = _port_finetune_step(tm, torch.float64)
    np.testing.assert_allclose(out["loss"].item(), aux["loss"], **TOL)
    np.testing.assert_allclose(out["acc"].item(), aux["acc"], rtol=0, atol=1e-3)
    assert set(grads) == {n for n, _ in tm.named_parameters()}
    _hold_grads("finetune", grads, exact, j_grads)


def _twin(tmp_path, name, cfg, **over):
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump({**cfg, **over}))
    return path


def _log(tmp_path, name):
    (log,) = tmp_path.glob(f"experiments/{name}/**/{name}.log")
    return log.read_text()


def test_main_gives_extra_train_twice_the_batch(tmp_path, monkeypatch):
    """``task: pretrain`` goes to ``runner_pretrain.run_net``, with the
    ``extra_train`` split at 2 x ``total_bs`` and the others at
    ``total_bs``."""
    monkeypatch.chdir(tmp_path)
    from upp_torch.main import main
    seen = {}
    monkeypatch.setattr(runner_pretrain, "run_net",
                        lambda args, config, *w: seen.setdefault("config", config))
    cfg = yaml.safe_load(open(REPO / "cfgs/pretrain_synthetic.yaml"))
    for split in ("train", "val", "test"):
        cfg["dataset"][split]["_base_"] = SYNTH
    cfg["dataset"]["extra_train"] = {"_base_": SYNTH, "others": {"subset": "train"}}
    main(["--config", str(_twin(tmp_path, "pt_bs", cfg, total_bs=6)), "--device", "cpu"])
    bs = {s: seen["config"].dataset[s].others.bs for s in ("train", "val", "test",
                                                           "extra_train")}
    assert bs == {"train": 6, "val": 6, "test": 6, "extra_train": 12}


def _pretrain_data(size=8, extra_train=False):
    splits = [("train", "train"), ("val", "test"), ("test", "test")]
    if extra_train:
        splits.append(("extra_train", "train"))
    return {s: {"_base_": {**SYNTH, "SIZE": size}, "others": {"subset": sub}}
            for s, sub in splits}


def test_cli_pretrain_probes_and_keeps_the_best(tmp_path, monkeypatch):
    """With ``extra_train`` and ``val`` splits, ``task: pretrain`` runs the
    SVM probe after epoch 1 and writes ``ckpt-best`` and ``ckpt-last``."""
    pytest.importorskip("sklearn")
    monkeypatch.chdir(tmp_path)
    from upp_torch.main import main
    pre = {**PRETRAIN, "dataset": _pretrain_data(extra_train=True), "task": "pretrain",
           "total_bs": 4, "max_epoch": 1}
    best = main(["--config", str(_twin(tmp_path, "pt_probe", pre)), "--device", "cpu"])
    assert 0.0 <= best.acc <= 100.0
    text = _log(tmp_path, "pt_probe")
    assert "[SVM probe] acc =" in text and "[Validation] EPOCH: 1" in text
    (last,) = tmp_path.glob("experiments/pt_probe/**/ckpt-last.pth")
    assert (last.parent / "ckpt-best.pth").exists()


@pytest.mark.parametrize("flag", ["--start_ckpts", "--ckpts"])
def test_cli_pretrain_warm_starts_from_a_point_mae_checkpoint(tmp_path, monkeypatch, flag):
    """A ``Point_MAE`` ``.pth`` (the reference's ``base_model`` layout, with
    ``MAE_encoder.*`` keys) warm-starts ``task: pretrain`` whole: nothing
    missing, nothing unexpected, every tensor as saved."""
    monkeypatch.chdir(tmp_path)
    from upp_torch.main import main
    pre = {**PRETRAIN, "dataset": _pretrain_data(size=4), "task": "pretrain",
           "total_bs": 4, "max_epoch": 0}
    saved = runner_cls.init_model(types.SimpleNamespace(seed=9), ConfigDict.from_nested(pre),
                                  torch.device("cpu")).state_dict()
    assert any(k.startswith("MAE_encoder.blocks.") for k in saved)
    path = tmp_path / "mae.pth"
    torch.save({"base_model": saved}, path)
    loaded = []
    load = runner_cls.load_weights

    def recording_load(model, *a, **kw):
        report = load(model, *a, **kw)
        loaded.append((report, {k: v.clone() for k, v in model.state_dict().items()}))
        return report

    monkeypatch.setattr(runner_cls, "load_weights", recording_load)
    name = "pt_warm_" + flag.strip("-")     # a logger of its own per case
    main(["--config", str(_twin(tmp_path, name, pre)), flag, str(path), "--device", "cpu"])
    (((missing, unexpected), state),) = loaded
    assert missing == [] and unexpected == []
    assert state.keys() == saved.keys()
    for k, v in saved.items():
        assert torch.equal(state[k], v), k
    assert f"loaded {len(saved)} tensors from {path}; 0 missing, 0 unexpected" in \
        _log(tmp_path, name)


def test_cli_pretrains_then_finetunes_on_cpu(tmp_path, monkeypatch):
    """``upp_torch.main`` pretrains a small ``Point_MAE`` for epochs 0-1
    (``ckpt-last``; no ``extra_train`` split, so no probe), then
    ``--finetune_model --ckpts`` its ``ckpt-last.pth`` trains
    ``PointTransformer`` with every backbone tensor loaded, every parameter
    trainable past ``--joint_optimization 0``, then ``--test
    --finetune_model --ckpts`` its ``ckpt-best.pth``."""
    monkeypatch.chdir(tmp_path)
    from upp_torch.main import main
    data = _pretrain_data()
    pre = {**PRETRAIN, "dataset": data, "task": "pretrain", "total_bs": 4, "max_epoch": 1}
    best = main(["--config", str(_twin(tmp_path, "pt_pre", pre)), "--device", "cpu"])
    assert best.acc == 0.0
    text = _log(tmp_path, "pt_pre")
    assert len(re.findall(r"EPOCH: \d+ EpochTime = [\d.]+ \(s\) LossX1000 = [\d.]+", text)) == 2
    assert "[SVM probe]" not in text
    (last,) = tmp_path.glob("experiments/pt_pre/**/ckpt-last.pth")
    assert not (last.parent / "ckpt-best.pth").exists()
    saved = torch.load(last, map_location="cpu", weights_only=True)
    assert saved["epoch"] == 1 and "MAE_encoder.blocks.blocks.0.attn.qkv.weight" in \
        saved["base_model"]

    ft = {**FINETUNE, "dataset": {s: data[s] for s in ("train", "val", "test")},
          "task": "classification", "total_bs": 4, "max_epoch": 1, "grad_norm_clip": 10}
    reports = []
    load = runner_cls.load_weights
    monkeypatch.setattr(runner_cls, "load_weights",
                        lambda *a, **kw: reports.append(load(*a, **kw)) or reports[-1])
    main(["--finetune_model", "--config", str(_twin(tmp_path, "pt_ft", ft)),
          "--ckpts", str(last), "--joint_optimization", "0", "--device", "cpu"])
    ((missing, unexpected),) = reports
    assert {k.split(".")[0] for k in missing} == {"cls_token", "cls_pos", "cls_head_finetune"}
    assert {k.split(".")[0] for k in unexpected} == {
        "MAE_decoder", "decoder_pos_embed", "increase_dim", "mask_token"}
    text = _log(tmp_path, "pt_ft")
    assert f"{len(missing)} missing, {len(unexpected)} unexpected" in text
    # a full fine-tune keeps every parameter trainable past the joint epoch
    assert "(100.00 %)" in text and "[joint optimization]" not in text
    assert "[Training] EPOCH: 1 " in text
    (ft_best,) = tmp_path.glob("experiments/pt_ft/**/ckpt-best.pth")
    acc = main(["--test", "--finetune_model", "--config",
                str(_twin(tmp_path, "pt_ft_test", ft)), "--ckpts", str(ft_best),
                "--device", "cpu"])
    assert 0.0 <= acc <= 100.0 and "missing_keys" not in _log(tmp_path, "pt_ft_test")


def test_pretrain_and_finetune_need_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = types.SimpleNamespace(seed=0)
    for entry, cfg in ((runner_pretrain.run_net, PRETRAIN),
                       (runner_cls.finetune_run_net, FINETUNE)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry(args, ConfigDict.from_nested(cfg))
