"""The port's segmentation runner against the JAX package on CPU, at the
small size of ``test_torch_port_seg_model.py``: the mIoU validation and
``test_net`` on ``SyntheticPart`` with the same weights (a reference-keyed
``.pth`` made from the JAX variables, loaded by both packages through
``--ckpts``), and the CLI: ``task: segmentation`` with ``--peft_model`` and
``--finetune_model`` trains on the hermetic twin of
``cfgs/unify_shapenetpart_seg.yaml`` / ``cfgs/finetune_shapenetpart_seg.yaml``
(each split's dataset replaced by ``SyntheticPart``), writes its
checkpoints, resumes, and ``--test --ckpts`` evaluates."""

import re
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from test_torch_port_seg_model import N_FULL, PT_SMALL, SEG_SMALL, seg_pair
from upp_tpu.data import BatchLoader as JBatchLoader
from upp_tpu.data import build_dataset_from_cfg as j_build_dataset
from upp_tpu.train import runner_seg as j_runner_seg
from upp_tpu.train.state import TrainState
from upp_tpu.utils.config import ConfigDict
from upp_torch.data import BatchLoader, build_dataset_from_cfg
from upp_torch.train import runner_seg
from upp_torch.utils.config import cfg_from_yaml_file

REPO = Path(__file__).resolve().parent.parent
PART = {"NAME": "SyntheticPart", "N_POINTS": N_FULL, "SIZE": 8}
SUMMARY = re.compile(r"Epoch (\d+) test Accuracy: ([\d.]+)  Class avg mIOU: ([\d.]+)  "
                     r"Instance avg mIOU: ([\d.]+)")


@pytest.fixture(scope="module")
def pair():
    return seg_pair(SEG_SMALL, 25)


def _keys(m):
    return {k: m[k] for k in ("accuracy", "class_avg_accuracy", "class_avg_iou",
                              "instance_avg_iou")}


def test_validate_matches_jax(pair, capsys):
    """``validate`` (argmax within each object's parts, the mIoU suite) of
    the UPP eval step over 8 ``SyntheticPart`` clouds, batch 4: the same
    accuracy, class-avg and instance-avg mIoU and per-category IoU as JAX's
    ``validate``, each to 1e-6, and the reference's log lines."""
    jm, variables, tm = pair
    config = ConfigDict.from_nested({"model": SEG_SMALL})
    state = TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                       opt_state=None, step=jnp.zeros((), jnp.int32))
    want = j_runner_seg.validate(
        j_runner_seg.make_seg_eval_step(jm, config, True), state,
        JBatchLoader(j_build_dataset(PART, {"subset": "test"}), 4), 3)
    capsys.readouterr()
    got = runner_seg.validate(
        runner_seg.make_seg_eval_step(tm, config, True),
        BatchLoader(build_dataset_from_cfg(PART, {"subset": "test"}), 4), torch.device("cpu"), 3)
    lines = capsys.readouterr().out.splitlines()
    for k, v in _keys(want).items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-6, err_msg=k)
    assert got["per_category_iou"].keys() == want["per_category_iou"].keys()
    for k, v in want["per_category_iou"].items():
        np.testing.assert_allclose(got["per_category_iou"][k], v, rtol=0, atol=1e-6)
    assert [ln.split()[3] for ln in lines[:-1]] == sorted(want["per_category_iou"])
    assert all(ln.startswith("eval mIoU of ") for ln in lines[:-1])
    assert SUMMARY.fullmatch(lines[-1]).group(1) == "3"


def test_test_net_matches_jax(pair, tmp_path):
    """``test_net`` of both packages from one reference-keyed ``.pth`` (the
    JAX variables moved by ``state_dict_from_jax``): equal mIoU suites."""
    _, _, tm = pair
    path = tmp_path / "seg.pth"
    torch.save({"base_model": tm.state_dict()}, path)
    config = ConfigDict.from_nested({
        "model": SEG_SMALL,
        "dataset": {"test": {"_base_": PART, "others": {"subset": "test", "bs": 4}}}})
    args = types.SimpleNamespace(seed=0, ckpts=str(path), device="cpu")
    want = j_runner_seg.test_net(args, config, unify=True)
    got = runner_seg.test_net(args, config, unify=True)
    for k, v in _keys(want).items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-6, err_msg=k)
    assert 0.0 < got["instance_avg_iou"] < 1.0


def seg_twin(tmp_path, name, finetune=False, max_epoch=1):
    """The hermetic twin of a shipped seg config: each split's dataset
    ``SyntheticPart`` (8 clouds of 256 points), the small model, batch 4."""
    src = "finetune_shapenetpart_seg" if finetune else "unify_shapenetpart_seg"
    cfg = yaml.safe_load(open(REPO / "cfgs" / f"{src}.yaml"))
    for split in ("train", "val", "test"):
        cfg["dataset"][split]["_base_"] = dict(PART)
    cfg.update(model=PT_SMALL if finetune else SEG_SMALL, npoints=N_FULL, total_bs=4,
               max_epoch=max_epoch)
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def test_cli_segmentation_trains_resumes_and_tests_on_cpu(tmp_path, monkeypatch):
    """``--peft_model`` trains epochs 0 and 1 (``SEG_PEFT_LIST``), logging
    the mIoU table each epoch and writing ``ckpt-best.pth``,
    ``ckpt-last.pth`` and the JSONL metrics; a resumed run continues at
    epoch 2 with the step count restored and the frozen backbone
    bit-unchanged; ``--test --peft_model --ckpts`` evaluates ckpt-best."""
    monkeypatch.chdir(tmp_path)
    from upp_torch.main import main
    metrics = main(["--peft_model", "--config", str(seg_twin(tmp_path, "seg_twin")),
                    "--device", "cpu"])
    assert 0.0 < metrics["instance_avg_iou"] <= 1.0
    (run,) = tmp_path.glob("experiments/seg_twin/plain-network/peft-retrain/*")
    log = (run / "seg_twin.log").read_text()
    assert [m[0] for m in SUMMARY.findall(log)] == ["0", "1"]
    assert "eval mIoU of Airplane" in log and "# TrainableParams" in log
    saved = torch.load(run / "ckpt-last.pth", map_location="cpu", weights_only=True)
    assert saved["epoch"] == 1 and saved["optimizer"]["num_steps"] == 4
    assert (run / "ckpt-best.pth").exists()
    assert list(tmp_path.glob("experiments/TFBoard/seg_twin/**/test_metrics.jsonl"))

    config = cfg_from_yaml_file(str(seg_twin(tmp_path, "seg_twin", max_epoch=2)))
    for split in ("train", "val", "test"):
        config.dataset[split].others.bs = 4
    args = types.SimpleNamespace(seed=0, device="cpu", experiment_path=str(run), resume=True,
                                 peft_model=True, log_name="seg_twin")
    runner_seg.run_net(args, config)
    resumed = torch.load(run / "ckpt-last.pth", map_location="cpu", weights_only=True)
    assert resumed["epoch"] == 2 and resumed["optimizer"]["num_steps"] == 6
    for k, v in saved["base_model"].items():
        frozen = not any(t in k for t in runner_seg.SEG_PEFT_LIST) and "running" not in k \
            and "num_batches" not in k
        if frozen:
            assert torch.equal(v, resumed["base_model"][k]), k
    assert not torch.equal(saved["base_model"]["seg_head.0.weight"],
                           resumed["base_model"]["seg_head.0.weight"])

    got = main(["--test", "--peft_model", "--device", "cpu",
                "--config", str(seg_twin(tmp_path, "seg_twin_test")),
                "--ckpts", str(run / "ckpt-best.pth")])
    assert 0.0 < got["instance_avg_iou"] <= 1.0
    (test_log,) = tmp_path.glob("experiments/seg_twin_test/ckpt-best/**/seg_twin_test.log")
    text = test_log.read_text()
    assert SUMMARY.search(text) and "missing_keys" not in text


def test_cli_segmentation_finetune_on_cpu(tmp_path, monkeypatch):
    """``--finetune_model`` on the twin of ``finetune_shapenetpart_seg.yaml``
    (``PointTransformer_seg``) trains every parameter for one epoch and
    checkpoints; ``--test`` evaluates it with the full fine-tune's eval step."""
    monkeypatch.chdir(tmp_path)
    from upp_torch.main import main
    metrics = main(["--finetune_model", "--config",
                    str(seg_twin(tmp_path, "ft_twin", finetune=True, max_epoch=0)),
                    "--device", "cpu"])
    assert 0.0 < metrics["instance_avg_iou"] <= 1.0
    (run,) = tmp_path.glob("experiments/ft_twin/plain-network/finetune-retrain/*")
    log = (run / "ft_twin.log").read_text()
    trainable, total = re.search(r"TrainableParams: ([\d.]+) M / ([\d.]+) M", log).groups()
    assert trainable == total
    got = main(["--test", "--device", "cpu", "--ckpts", str(run / "ckpt-last.pth"),
                "--config", str(seg_twin(tmp_path, "ft_twin_test", finetune=True))])
    assert 0.0 < got["instance_avg_iou"] <= 1.0


def test_seg_entry_points_need_a_card_unless_told(monkeypatch):
    """Without CUDA the seg runners raise instead of falling back to the
    CPU; only ``device="cpu"`` runs them there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = cfg_from_yaml_file(str(REPO / "cfgs/unify_shapenetpart_seg.yaml"))
    args = types.SimpleNamespace(seed=0)
    for entry in (runner_seg.run_net, runner_seg.finetune_run_net, runner_seg.test_net):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry(args, config)
