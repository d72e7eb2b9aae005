"""Data parallelism of the port on the CPU: two ranks over gloo (each a
``tests/torch_dist_worker.py`` process on a free localhost port, joined by
``upp_torch.parallel.dist.init_dist``) against one process on the whole
batch, and against the JAX package. Small sizes: ``trans_dim`` 48, shallow
stacks, a global batch of 4 (2 a rank), at most 512 points a cloud.

(a) Global BatchNorm on two halves of x [4, 16, 8] against
    ``nn.BatchNorm1d`` on the whole (float32; output, input gradient and
    running statistics within atol 1e-6 / rtol 1e-5, measured 4.8e-7,
    2.4e-7 and 1.2e-7; weight and bias gradients, sums over 64 rows,
    within atol 1e-5 / rtol 1e-5, measured 3.8e-6 and 9.5e-7: the test
    prints them) and against
    the JAX package's ``TorchBatchNorm`` (its one-pass variance: ``TOL``,
    1e-4).
(b) The cls PEFT step on 2 ranks x 2 clouds against the port's one-process
    step on the 4, then a joint step after ``set_trainable(JOINT_PEFT_LIST)``
    on the live optimizer, from the step's own generator draws (crop, noise,
    augmentation, dropout and drop-path on). In float64: in float32, AdamW's
    normalised update turns the rounding of gradients that are zero in
    exact arithmetic (the biases before a train-mode BatchNorm) into
    parameter differences of a sizeable part of the learning rate, and near
    ties at the top-5% rectify drop may reorder. Loss and accuracy within
    rtol 1e-9, every gradient and every tensor of the state (parameters and
    running statistics) within atol 1e-9 / rtol 1e-9 (measured, as the test
    prints: loss 1e-14, gradients 1.7e-12, state 1.7e-10); both ranks
    bit-equal.
(c) The pretrain step on 2 ranks against the JAX package's jitted step on
    the global batch, with the harness and bounds of
    ``test_torch_port_pretrain.py`` (``GRAD_TOL["pretrain"]``, ``TOL``):
    the encoder's BatchNorms normalise over every group of all 4 clouds.
(d) Sharded evaluation of a set of 9 (two ranks pad it to 10; the duplicate
    must be dropped) against one process at twice the batch: cls
    ``validate`` and ``test_vote`` accuracies equal, seg mIoU within 1e-6,
    pretask ``validate`` within rtol 1e-5 and ``validate_detailed``'s table
    (taxonomies and counts equal, its 3-decimal values within 1.5e-3), the
    probe's features within rtol 1e-5 / atol 1e-6 in index order. The cls
    model here uses ``propagation_semantics: clean``: the reference gather
    couples a cloud to the cloud before it in its batch, so a sharded
    evaluation equals one process only where the model is per-cloud in eval
    mode, as in the JAX package's per-host evaluation.
(e) The CLI through ``torch.distributed.run --nproc_per_node 2 --launcher
    pytorch --device cpu`` for 2 epochs (the second after the joint
    switch), then a one-process ``--test --ckpts`` of its ``ckpt-best.pth``;
    and rank 0 alone writing, every rank loading a one-process checkpoint.
(f) A world of one under ``--launcher pytorch`` writes the checkpoint, bit
    for bit, of a run without a launcher.
(g) ``--launcher pytorch`` without torchrun's environment raises.
"""

import contextlib
import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import torch_dist_worker as worker
from test_torch_port_baseline import MAE_SMALL
from test_torch_port_model import SMALL, TOL
from test_torch_port_pretask import TINY_PT
from test_torch_port_pretrain import (AUG, B, KEY, NPOINTS, PRETRAIN, _clouds, _hold_grads,
                                      pretrain_jax)  # noqa: F401  (a fixture)
from test_torch_port_seg_model import N_FULL, SEG_SMALL
from test_torch_port_slice import jax_aug_draws
from upp_tpu.models.layers import TorchBatchNorm
from upp_torch.data import build_dataset_from_cfg
from upp_torch.train import checkpoint, optim

REPO = Path(__file__).resolve().parent.parent
WORLD = 2
N_DS = 512
CLS_NPOINTS = 256
CLS_MODEL = {**SMALL, "transformer_config": {**SMALL["transformer_config"],
                                             "drop_path_rate": 0.1}}
CLS_CONFIG = {
    "optimizer": {"type": "AdamW", "kwargs": {"lr": 5e-4, "weight_decay": 0.05}},
    "scheduler": {"type": "CosLR", "kwargs": {"epochs": 4, "initial_epochs": 1}},
    "dataset": {s: {"_base_": {"NAME": "Synthetic", "N_POINTS": N_DS, "NUM_CATEGORY": 5,
                               "SIZE": 8},
                    "others": {"subset": "train"}} for s in ("train", "val", "test")},
    "model": CLS_MODEL, "npoints": CLS_NPOINTS, "noisy_train": True,
    "data_augmentation": "scale-translate", "grad_norm_clip": 10,
}
CLS_ARGS = dict(seed=3, noise=True, noise_type=["gaussian_noise", "lidar_noise"],
                incomplete_cropping=True, normalize=False)
EVAL_SIZE = 9
EVAL_BS = 2                     # a rank's batch; one process takes WORLD x


@contextlib.contextmanager
def one_thread():
    """The one-process references run on one thread: their ops are small,
    and the test workers already hold every core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return str(s.getsockname()[1])


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO), str(REPO / "tests"), os.environ.get("PYTHONPATH", "")]), **extra)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    return env


def run_ranks(tmp, job, timeout=600):
    """Run ``job`` on ``WORLD`` worker ranks; their results, by rank."""
    torch.save(job, tmp / "job.pt")
    port, out = _free_port(), tmp / "out"
    logs = [tmp / f"rank{r}.log" for r in range(WORLD)]
    procs = []
    for r, log in enumerate(logs):
        with open(log, "w") as f:       # a file each: a full pipe would stall a rank
            procs.append(subprocess.Popen(
                [sys.executable, str(REPO / "tests" / "torch_dist_worker.py"), str(r),
                 str(WORLD), port, str(tmp / "job.pt"), str(out)],
                env=_env(), cwd=REPO, stdout=f, stderr=subprocess.STDOUT))
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log.read_text()[-4000:]
    return [torch.load(f"{out}.{r}", weights_only=False) for r in range(WORLD)]


def _synthetic(size, subset="train", n=N_DS):
    ds = build_dataset_from_cfg({"NAME": "Synthetic", "N_POINTS": n, "NUM_CATEGORY": 5,
                                 "SIZE": size}, {"subset": subset})
    return (np.stack([ds[i][2][0] for i in range(size)]).astype(np.float32),
            np.asarray([ds[i][2][1] for i in range(size)], np.int64))


def _one_process_ckpt(tmp):
    """A checkpoint written by one process: ``Point_MAE`` at a seeded init,
    its optimizer after a step of ones."""
    torch.manual_seed(7)
    from upp_torch.models import build_model_from_cfg
    from upp_torch.utils.config import ConfigDict
    model = build_model_from_cfg(MAE_SMALL)
    opt = optim.build_optimizer(ConfigDict.from_nested(PRETRAIN), model, 1)
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    # written before the rank processes read it
    return checkpoint.save_checkpoint(model, opt, 4, "ckpt-last", str(tmp / "one"),
                                      logger="silent", block=True)


def _jobs(tmp, pretrain_jax):
    rng = np.random.default_rng(11)
    tm, _, _, _, masks = pretrain_jax
    k_aug = jax.random.split(jax.random.fold_in(jax.random.key(KEY), 0), 4)[0]
    clouds, labels = _synthetic(4)
    ckpt_path = _one_process_ckpt(tmp)
    synth = {"NAME": "Synthetic", "N_POINTS": N_DS, "NUM_CATEGORY": 5, "SIZE": EVAL_SIZE}
    return {
        "bn": {"x": (2.0 * rng.standard_normal((4, 16, 8)) + 0.5).astype(np.float32),
               "w_out": rng.standard_normal((4, 16, 8)).astype(np.float32),
               "state": {"weight": 1.0 + 0.1 * rng.standard_normal(8).astype(np.float32),
                         "bias": 0.1 * rng.standard_normal(8).astype(np.float32),
                         "running_mean": 0.1 * rng.standard_normal(8).astype(np.float32),
                         "running_var": rng.uniform(0.5, 1.5, 8).astype(np.float32)}},
        "cls": {"config": CLS_CONFIG, "args": CLS_ARGS, "clouds": clouds, "labels": labels},
        "pretrain": {"config": PRETRAIN, "model": MAE_SMALL, "state": tm.state_dict(),
                     "clouds": _clouds(), "masks": masks,
                     "draws": {k: v.numpy() for k, v in
                               jax_aug_draws(k_aug, AUG, B, NPOINTS).items()}},
        "eval": {"bs": EVAL_BS, "seed": 5, "npoints": 128,
                 "cls_config": {**CLS_CONFIG, "model": {**CLS_MODEL,
                                                        "propagation_semantics": "clean"}},
                 "cls_data": synth, "probe_data": synth,
                 "seg_model": SEG_SMALL,
                 "seg_data": {"NAME": "SyntheticPart", "N_POINTS": N_FULL, "SIZE": EVAL_SIZE},
                 "pretask_config": {**CLS_CONFIG, "model": TINY_PT, "npoints": 128},
                 "pretask_data": {**synth, "NUM_CATEGORY": 3},
                 "mae_model": MAE_SMALL},
        "ckpt": {"model": MAE_SMALL, "config": PRETRAIN, "dir": str(tmp / "ckpt"),
                 "one_process_ckpt": ckpt_path},
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory, pretrain_jax):
    """(the job, the two ranks' results) of one two-rank run of every case."""
    tmp = tmp_path_factory.mktemp("dist")
    job = _jobs(tmp, pretrain_jax)
    job["cases"] = ["bn", "cls", "pretrain", "eval", "ckpt"]
    return job, run_ranks(tmp, job)


def _rank_equal(results, *path):
    a, b = results
    for key in path:
        a, b = a[key], b[key]
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), (path, k)
    else:
        assert a == b, path


def test_global_batchnorm_matches_one_process_and_jax(runs):
    """(a) Each rank normalises its half with the whole batch's statistics."""
    job, results = runs
    bn_job = job["bn"]
    x = torch.tensor(bn_job["x"]).requires_grad_(True)
    ref = torch.nn.BatchNorm1d(8)
    ref.load_state_dict({k: torch.tensor(v) for k, v in bn_job["state"].items()}, strict=False)
    y = ref(x.reshape(-1, 8)).reshape(x.shape)
    (y * torch.tensor(bn_job["w_out"])).sum().backward()
    got = {k: np.concatenate([r["bn"][k] for r in results]) for k in ("y", "x_grad")}
    r0 = results[0]["bn"]
    for r in results[1:]:
        for k in ("weight_grad", "bias_grad", "running_mean", "running_var"):
            np.testing.assert_array_equal(r["bn"][k], r0[k], err_msg=k)
    print("[global batchnorm, 2 ranks] from nn.BatchNorm1d: output "
          f"{np.abs(got['y'] - y.detach().numpy()).max():.3g}, input gradient "
          f"{np.abs(got['x_grad'] - x.grad.numpy()).max():.3g}, weight / bias gradients "
          f"{np.abs(r0['weight_grad'] - ref.weight.grad.numpy()).max():.3g} / "
          f"{np.abs(r0['bias_grad'] - ref.bias.grad.numpy()).max():.3g}, running statistics "
          f"{max(np.abs(r0['running_mean'] - ref.running_mean.numpy()).max(), np.abs(r0['running_var'] - ref.running_var.detach().numpy()).max()):.3g}")
    np.testing.assert_allclose(got["y"], y.detach().numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["x_grad"], x.grad.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(r0["weight_grad"], ref.weight.grad.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(r0["bias_grad"], ref.bias.grad.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(r0["running_mean"], ref.running_mean.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(r0["running_var"], ref.running_var.numpy(), rtol=1e-5, atol=1e-6)
    # two all-reduces each way: (count, sum), then the centred squares
    assert r0["counts"]["forward"] == 2 and r0["counts"]["backward"] == 2

    st = bn_job["state"]
    jbn = TorchBatchNorm(use_running_average=False)
    stats = {"mean": jnp.asarray(st["running_mean"]), "var": jnp.asarray(st["running_var"])}

    def loss(params, xj):
        yj, mut = jbn.apply({"params": params, "batch_stats": stats}, xj,
                            mutable=["batch_stats"])
        return (yj * bn_job["w_out"]).sum(), (yj, mut["batch_stats"])

    (_, (yj, new)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        {"scale": jnp.asarray(st["weight"]), "bias": jnp.asarray(st["bias"])},
        jnp.asarray(bn_job["x"]))
    for port, want in ((got["y"], yj), (got["x_grad"], gx), (r0["weight_grad"], gp["scale"]),
                       (r0["bias_grad"], gp["bias"]), (r0["running_mean"], new["mean"]),
                       (r0["running_var"], new["var"])):
        np.testing.assert_allclose(port, np.asarray(want), **TOL)


@pytest.fixture(scope="module")
def cls_one_process(runs):
    with one_thread():
        return worker.case_cls(runs[0]["cls"])


@pytest.mark.parametrize("stage", ["peft", "joint"])
def test_cls_step_on_two_ranks_matches_one_process(runs, cls_one_process, stage):
    """(b) The PEFT step, then the joint step after the switch on the live
    optimizer: the ranks hold equal tensors, the one process's."""
    _, results = runs
    _rank_equal(results, "cls", stage, "state")
    _rank_equal(results, "cls", stage, "loss")
    ref = cls_one_process[stage]
    got = results[0]["cls"][stage]
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-9, atol=0)
    assert got["acc"] == pytest.approx(ref["acc"], rel=1e-9)
    assert got["grads"].keys() == ref["grads"].keys() and len(ref["grads"]) > 10
    for name, g in ref["grads"].items():
        np.testing.assert_allclose(got["grads"][name].numpy(), g.numpy(), rtol=1e-9, atol=1e-9,
                                   err_msg=name)
    for name, v in ref["state"].items():
        if v.is_floating_point():
            np.testing.assert_allclose(got["state"][name].numpy(), v.numpy(), rtol=1e-9,
                                       atol=1e-9, err_msg=name)
        else:
            assert torch.equal(got["state"][name], v), name
    if stage == "joint":
        assert any(n.startswith("rectify_prompter") for n in ref["grads"])
        assert not any(n.startswith("cls_head_finetune") for n in ref["grads"])
    counts = got["counts"]
    print(f"[cls {stage} step, 2 ranks] loss {abs(got['loss'] - ref['loss']):.3g} from one "
          f"process, gradients {max(float((got['grads'][n] - g).abs().max()) for n, g in ref['grads'].items()):.3g}, "
          f"state {max(float((got['state'][n] - v).abs().max()) for n, v in ref['state'].items() if v.is_floating_point()):.3g}; "
          f"collectives: {dict(counts)}")
    assert counts["gradients"] == 1 and counts["forward"] > 0 and counts["backward"] > 0


def test_pretrain_step_on_two_ranks_matches_jax(runs, pretrain_jax):
    """(c) Two ranks of the port against the JAX package's jitted step on
    the global batch: loss, every gradient, the encoder's statistics."""
    _, j_grads, j_stats, j_loss, _ = pretrain_jax
    _, results = runs
    for dtype in ("torch.float32", "torch.float64"):
        _rank_equal(results, "pretrain", dtype, "grads")
        _rank_equal(results, "pretrain", dtype, "running")
    got = results[0]["pretrain"]
    np.testing.assert_allclose(got["torch.float32"]["loss"], j_loss, **TOL)
    _hold_grads("pretrain", got["torch.float32"]["grads"], got["torch.float64"]["grads"],
                j_grads)
    running = got["torch.float32"]["running"]
    assert len(running) == 4
    for k, v in running.items():
        np.testing.assert_allclose(v.numpy(), j_stats[k].numpy(), **TOL, err_msg=k)


def _table(lines):
    rows = {}
    for ln in lines:
        parts = ln.split("\t")
        if len(parts) == 5 and parts[0] not in ("Taxonomy",):
            rows[parts[0]] = (parts[1], [float(v) for v in parts[2:]])
    return rows


def test_sharded_evaluation_gathers_every_sample_once(runs):
    """(d) Every runner's evaluation on two ranks equals one process's."""
    job, results = runs
    with one_thread():
        ref = worker.case_eval({**job["eval"], "bs": EVAL_BS * WORLD})
    got = results[0]["eval"]
    for key in ("cls_acc", "vote_acc", "seg", "pretask_cd", "pretask_table"):
        assert results[1]["eval"][key] == got[key], key
    idx, (col,) = got["gathered"]
    np.testing.assert_array_equal(idx, np.arange(EVAL_SIZE))
    np.testing.assert_array_equal(col, 10 * np.arange(EVAL_SIZE))
    assert 0 < ref["cls_acc"] < 100 and ref["cls_acc"] * EVAL_SIZE / 100 % 1 < 1e-9
    assert got["cls_acc"] == ref["cls_acc"] and got["vote_acc"] == ref["vote_acc"]
    for k, v in ref["seg"].items():
        np.testing.assert_allclose(got["seg"][k], v, rtol=0, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(got["pretask_cd"], ref["pretask_cd"], rtol=1e-5)
    want, have = _table(ref["pretask_table"]), _table(got["pretask_table"])
    assert want.keys() == have.keys() and "Overall" in want
    for tax, (count, vals) in want.items():
        assert have[tax][0] == count, tax
        np.testing.assert_allclose(have[tax][1], vals, rtol=0, atol=1.5e-3, err_msg=tax)
    feats, labels = got["probe"]
    assert feats.shape[0] == EVAL_SIZE
    np.testing.assert_array_equal(labels, ref["probe"][1])
    np.testing.assert_allclose(feats, ref["probe"][0], rtol=1e-5, atol=1e-6)


def test_rank_zero_writes_and_every_rank_loads_one_process_checkpoints(runs, tmp_path):
    """(e) ``save_checkpoint`` writes on rank 0 only; a one-process
    checkpoint loads on every rank through ``--ckpts`` and a resume."""
    job, results = runs
    assert [r["ckpt"]["written"] for r in results] == [True, False]
    assert not os.path.exists(os.path.join(job["ckpt"]["dir"], "rank1"))
    saved = torch.load(job["ckpt"]["one_process_ckpt"], weights_only=True)["base_model"]
    for r in results:
        assert r["ckpt"]["start_epoch"] == 5
        for k, v in saved.items():
            assert torch.equal(r["ckpt"]["loaded"][k], v) and torch.equal(r["ckpt"]["resumed"][k], v)


def _cls_yaml(tmp, name, max_epoch):
    cfg = yaml.safe_load(open(REPO / "cfgs" / "unify_synthetic_cls.yaml"))
    for split in ("train", "val", "test"):
        cfg["dataset"][split]["_base_"] = dict(CLS_CONFIG["dataset"][split]["_base_"])
    cfg.update(model=CLS_MODEL, npoints=CLS_NPOINTS, total_bs=4, max_epoch=max_epoch)
    path = tmp / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def _launch(argv, tmp, nproc=None, timeout=600):
    """``python -m upp_torch.main argv`` in ``tmp``, under ``torchrun`` with
    ``nproc`` ranks when given."""
    cmd = [sys.executable, "-m"]
    if nproc is not None:
        cmd += ["torch.distributed.run", "--standalone", "--nproc_per_node", str(nproc),
                "-m", "upp_torch.main", "--launcher", "pytorch"]
    else:
        cmd += ["upp_torch.main"]
    return subprocess.Popen(cmd + argv + ["--device", "cpu"], cwd=tmp, env=_env(OMP_NUM_THREADS="1"),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), timeout


def _finish(launched):
    proc, timeout = launched
    out = proc.communicate(timeout=timeout)[0]
    assert proc.returncode == 0, out[-4000:]
    return out


def test_cli_trains_on_two_ranks_then_tests_in_one_process(tmp_path, monkeypatch):
    """(e) ``torchrun --nproc_per_node 2`` trains 2 epochs (the second after
    the joint switch): one run directory, a rank's batch of ``total_bs //
    2``, the writers on rank 0 alone; one process tests its ckpt-best."""
    cfg = _cls_yaml(tmp_path, "dist_cls", max_epoch=1)
    _finish(_launch(["--peft_model", "--config", str(cfg), "--joint_optimization", "0",
                     "--exp_name", "two"], tmp_path, nproc=2))
    runs_dir = tmp_path / "experiments" / "dist_cls" / "plain-network" / "peft-two"
    (run,) = list(runs_dir.iterdir())
    log = (run / "dist_cls.log").read_text()
    assert "config.dataset.train.others.bs : 2" in log and "config.dataset.val.others.bs : 2" in log
    assert "[joint optimization] switching" in log
    assert len(re.findall(r"\[Training\] EPOCH: \d", log)) == 2
    assert {p.name for p in run.iterdir()} >= {"ckpt-best.pth", "ckpt-last.pth", "config.yaml"}
    assert not list(run.glob("*.tmp"))
    batches = [ln for ln in (tmp_path / "experiments" / "TFBoard" / "dist_cls" / "plain-network"
                             / "peft-two" / "train_metrics.jsonl").read_text().splitlines()
               if '"Loss/Batch/Loss"' in ln]
    assert len(batches) == 2 * 2                # 8 clouds / (2 ranks x 2) a step, 2 epochs
    monkeypatch.chdir(tmp_path)
    from upp_torch.main import main
    acc = main(["--test", "--peft_model", "--config", str(_cls_yaml(tmp_path, "dist_cls_test", 1)),
                "--ckpts", str(run / "ckpt-best.pth"), "--device", "cpu"])
    assert 0.0 <= acc <= 100.0
    (test_log,) = tmp_path.glob("experiments/dist_cls_test/**/dist_cls_test.log")
    text = test_log.read_text()
    assert "missing_keys" not in text and "unexpected_keys" not in text and "[TEST] acc" in text


def test_world_of_one_under_the_launcher_matches_no_launcher(tmp_path):
    """(f) ``torchrun --nproc_per_node 1 --launcher pytorch`` and the plain
    CLI write the same ``ckpt-last.pth``, bit for bit."""
    cfg = _cls_yaml(tmp_path, "one_cls", max_epoch=0)
    argv = ["--peft_model", "--config", str(cfg)]
    runs = [_launch(argv + ["--exp_name", "launched"], tmp_path, nproc=1),
            _launch(argv + ["--exp_name", "plain"], tmp_path)]
    for launched in runs:
        _finish(launched)
    base = tmp_path / "experiments" / "one_cls" / "plain-network"
    (a,), (b,) = (list((base / f"peft-{n}").glob("*/ckpt-last.pth")) for n in ("launched", "plain"))
    a, b = (torch.load(p, weights_only=True) for p in (a, b))
    assert a["epoch"] == b["epoch"] == 0 and a["metrics"] == b["metrics"]
    for part in ("base_model",):
        assert a[part].keys() == b[part].keys()
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), k
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    assert sa.keys() == sb.keys() and sa
    for k in sa:
        for name in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa[k][name], sb[k][name]), (k, name)


def test_launcher_without_torchrun_environment_raises(tmp_path, monkeypatch):
    """(g) No silent fallback to one process."""
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.chdir(tmp_path)
    from upp_torch.main import main
    with pytest.raises(RuntimeError, match="torchrun"):
        main(["--launcher", "pytorch", "--device", "cpu", "--peft_model", "--config",
              str(_cls_yaml(tmp_path, "no_env", max_epoch=0))])
    assert not (tmp_path / "experiments").exists()
