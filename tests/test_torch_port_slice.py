"""The PyTorch port's first slice end to end on CPU: clean and noisy
``make_eval_step``, ``corrupt_batch`` with JAX's draws, the robust 3-pass
inference, the CLI, and the port's two rules: it imports nothing of JAX, and
its entry points never fall back to the CPU on their own."""

import ast
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from test_torch_port_model import SMALL, TOL, build_pair
from upp_tpu.ops.fps import fps as jax_fps
from upp_tpu.train.pipeline import corrupt_batch as jax_corrupt_batch
from upp_tpu.train.runner_cls import make_eval_step as jax_make_eval_step
from upp_tpu.utils.config import ConfigDict
from upp_torch import resolve_device
from upp_torch.data import build_dataset_from_cfg
from upp_torch.ops.fps import fps
from upp_torch.train import runner_cls
from upp_torch.train.pipeline import CorruptDraws, corrupt_batch
from upp_torch.utils.config import cfg_from_yaml_file

REPO = Path(__file__).resolve().parent.parent
NPOINTS = 256


@pytest.fixture(scope="module")
def pair():
    return build_pair(SMALL, NPOINTS, NPOINTS + 72, seed=1)


def _synthetic(n_points, size, subset="test"):
    ds = build_dataset_from_cfg({"NAME": "Synthetic", "N_POINTS": n_points,
                                 "NUM_CATEGORY": 6, "SIZE": size},
                                {"subset": subset})
    return np.stack([ds[i][2][0] for i in range(size)]).astype(np.float32)


@pytest.mark.parametrize("noisy_validate", [False, True])
def test_make_eval_step_matches_jax(pair, noisy_validate):
    jm, variables, tm = pair
    config = ConfigDict.from_nested({"npoints": NPOINTS,
                                     "noisy_validate": noisy_validate})
    args = types.SimpleNamespace(normalize=False)
    clouds = _synthetic(1024, 3)
    want = np.asarray(jax_make_eval_step(jm, config, args)(variables, jnp.asarray(clouds)))
    got = runner_cls.make_eval_step(tm, config, args)(torch.tensor(clouds))
    np.testing.assert_array_equal(got.numpy(), want)

    pts_j, _ = jax_fps(jnp.asarray(clouds), NPOINTS)
    want_logits = jm.apply(variables, pts_j, completion_prompt=noisy_validate,
                           denoise=noisy_validate, point_num=NPOINTS, deterministic=True)
    pts_t, _ = fps(torch.tensor(clouds), NPOINTS)
    with torch.no_grad():
        got_logits = tm(pts_t, completion_prompt=noisy_validate,
                        denoise=noisy_validate, point_num=NPOINTS)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), **TOL)


def _t(a):
    return torch.tensor(np.asarray(a))


def jax_aug_draws(key, aug, B, N):
    """The random numbers of ``upp_tpu``'s augmentation ``aug`` from
    ``key`` (its key splits), as the port's ``AugmentDraws`` fields, for
    clouds [B, N, 3]."""
    u = jax.random.uniform
    if aug == "rotate":
        return {"aug_theta": _t(u(key, (B,), jnp.float32, -jnp.pi, jnp.pi))}
    if aug == "scale-translate":
        a1, a2 = jax.random.split(key)
        return {"aug_scale": _t(u(a1, (B, 1, 3), jnp.float32, 2 / 3, 3 / 2)),
                "aug_shift": _t(u(a2, (B, 1, 3), jnp.float32, -0.2, 0.2))}
    if aug == "scale":
        return {"aug_scale": _t(u(key, (B, 1, 3), jnp.float32, 2 / 3, 3 / 2))}
    if aug == "translate":
        return {"aug_shift": _t(u(key, (B, 1, 3), jnp.float32, -0.2, 0.2))}
    if aug == "jitter":
        return {"aug_normal": _t(jax.random.normal(key, (B, N, 3), jnp.float32))}
    if aug == "dropout":
        k1, k2 = jax.random.split(key)
        return {"aug_ratio": _t(u(k1, (B, 1), jnp.float32) * 0.5),
                "aug_u": _t(u(k2, (B, N), jnp.float32))}
    if aug == "hflip":
        k1, k2 = jax.random.split(key)
        return {"aug_apply": _t(u(k1, (B, 1), jnp.float32)),
                "aug_axis": _t(u(k2, (B, 3), jnp.float32))}
    assert aug is None
    return {}


def _jax_draws(key, B, n_in, aug):
    """JAX's random numbers inside ``corrupt_batch`` (same key splits) for
    clouds of ``n_in`` points after the crop."""
    k_crop, k_lidar, k_gauss, k_aug = jax.random.split(key, 4)
    v = jnp.stack([jax.random.normal(k, (3,), jnp.float32)
                   for k in jax.random.split(k_crop, B)])
    v = v / jnp.linalg.norm(v, axis=-1, keepdims=True)
    k1, k2 = jax.random.split(k_lidar)
    return CorruptDraws(
        viewpoints=_t(v),
        lidar_idx=_t(jax.random.randint(k1, (48,), 0, n_in)),
        lidar_factor=_t(jax.random.uniform(k2, (48,), jnp.float32, 1.2, 1.5)),
        shell_normal=_t(jax.random.normal(k_gauss, (B, 24, 3), jnp.float32)),
        **jax_aug_draws(k_aug, aug, B, n_in + 72))


AUGMENTATIONS = [None, "scale-translate", "rotate", "scale", "translate", "jitter",
                 "dropout", "hflip"]


@pytest.mark.parametrize("augmentation", AUGMENTATIONS)
def test_robust_inference_matches_jax(pair, augmentation):
    """corrupt_batch (viewpoint crop, lidar + shell noise[, an augmentation])
    with JAX's draws, then the 3-pass forward."""
    jm, variables, tm = pair
    clouds = _synthetic(1024, 2, subset="train")
    key = jax.random.key(11)
    kw = dict(npoints=NPOINTS, n_points_dataset=1024, noisy_train=True,
              incomplete_cropping=True, augmentation=augmentation)
    want_pts = jax_corrupt_batch(key, jnp.asarray(clouds), **kw)
    got_pts = corrupt_batch(torch.tensor(clouds), **kw,
                            draws=_jax_draws(key, 2, NPOINTS, augmentation))
    assert got_pts.shape == (2, NPOINTS + 72, 3)
    np.testing.assert_allclose(got_pts.numpy(), np.asarray(want_pts), rtol=1e-6, atol=1e-6)

    want = jm.apply(variables, jnp.asarray(got_pts.numpy()), completion_prompt=True,
                    denoise=True, point_num=NPOINTS, deterministic=True)
    with torch.no_grad():
        got = tm(got_pts, completion_prompt=True, denoise=True, point_num=NPOINTS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_unknown_augmentation_raises():
    clouds = torch.tensor(_synthetic(1024, 2))
    with pytest.raises(ValueError, match="unknown data_augmentation"):
        corrupt_batch(clouds, npoints=NPOINTS, n_points_dataset=1024, noisy_train=True,
                      incomplete_cropping=True, augmentation="mixup")


def test_corrupt_batch_from_a_generator_is_seeded():
    clouds = torch.tensor(_synthetic(1024, 2))
    kw = dict(npoints=NPOINTS, n_points_dataset=1024, noisy_train=True,
              incomplete_cropping=True)
    a = corrupt_batch(clouds, **kw, generator=torch.Generator().manual_seed(3))
    b = corrupt_batch(clouds, **kw, generator=torch.Generator().manual_seed(3))
    assert a.shape == (2, NPOINTS + 72, 3) and torch.isfinite(a).all()
    assert torch.equal(a, b)


def test_cli_test_runs_on_cpu(tmp_path, monkeypatch):
    cfg = yaml.safe_load(open(REPO / "cfgs/unify_synthetic_cls.yaml"))
    base = {"NAME": "Synthetic", "N_POINTS": 1024, "NUM_CATEGORY": 6, "SIZE": 4}
    for split in ("train", "val", "test"):
        cfg["dataset"][split]["_base_"] = base
    cfg.update(model={**SMALL, "cls_dim": 6}, npoints=NPOINTS, total_bs=2)
    path = tmp_path / "small.yaml"
    path.write_text(yaml.safe_dump(cfg))
    monkeypatch.chdir(tmp_path)
    from upp_torch.main import main
    acc = main(["--test", "--peft_model", "--config", str(path), "--device", "cpu"])
    assert 0.0 <= acc <= 100.0


def test_port_imports_no_jax():
    """No module of the port, nor chip_smoke.py, imports jax, flax, optax or
    the JAX package."""
    banned = {"jax", "jaxlib", "flax", "optax", "upp_tpu"}
    files = sorted((REPO / "upp_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, f"{f}: imports {name}"


def test_entry_points_never_fall_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    assert resolve_device("cpu").type == "cpu"
    config = cfg_from_yaml_file(str(REPO / "cfgs/unify_synthetic_cls.yaml"))
    for entry in (runner_cls.test_net, runner_cls.run_net, runner_cls.finetune_run_net):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry(types.SimpleNamespace(seed=0), config)


def test_chip_smoke_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    r = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
