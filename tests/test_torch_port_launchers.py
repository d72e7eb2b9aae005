"""The port's launchers (new files beside the root ones, which stay as they
are): ``python -m upp_torch.hyperparam_probing --dry_run`` prints, for a
grid, the root sweep's commands with ``main.py`` replaced by ``-m
upp_torch.main`` (the ``--peft_model`` fix kept, each trial config a
temporary file removed after it); ``bash -n`` accepts
``upp_torch/launch/train.sh`` and ``test.sh``, which run ``python -m
upp_torch.main``."""

import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
GRID = ["--lrs", "5e-4", "1e-3", "--prompt_nums", "5", "10", "--max_epoch", "2",
        "--ckpts", "prompter_bases/x.pth", "--dry_run"]


def _commands(cmd):
    out = subprocess.run(cmd + GRID, cwd=REPO, capture_output=True, text=True, timeout=120,
                         check=True).stdout
    lines = [ln for ln in out.splitlines() if ln.startswith("->")]
    paths = [re.search(r"--config (\S+)", ln).group(1) for ln in lines]
    return [ln.replace(p, "<trial.yaml>") for ln, p in zip(lines, paths)], paths


def test_hyperparam_probing_prints_the_root_sweep_under_the_port():
    jax_cmds, _ = _commands([sys.executable, "hyperparam_probing.py"])
    port_cmds, paths = _commands([sys.executable, "-m", "upp_torch.hyperparam_probing"])
    assert len(port_cmds) == 4
    assert port_cmds == [c.replace(f"{sys.executable} main.py",
                                   f"{sys.executable} -m upp_torch.main") for c in jax_cmds]
    assert all("--peft_model" in c and "--ckpts prompter_bases/x.pth" in c for c in port_cmds)
    assert not any(Path(p).exists() for p in paths)


@pytest.mark.parametrize("script", ["train.sh", "test.sh"])
def test_launch_scripts_parse_and_run_the_port(script):
    path = REPO / "upp_torch" / "launch" / script
    subprocess.run(["bash", "-n", str(path)], check=True)
    text = path.read_text()
    runs = [ln for ln in text.splitlines() if ln.startswith("python")]
    assert runs and all(ln.startswith("python -m upp_torch.main") for ln in runs)
    assert "main.py" not in text
