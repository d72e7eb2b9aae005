"""Runs over several hosts, on one machine (imports no JAX): two
``torch.distributed.run`` node groups on localhost (``--nnodes 2
--node_rank {0,1} --nproc_per_node 1``, gloo on the CPU), so the second
group's rank is 1 while its local rank is 0, as on a second host.

(a) The cls CLI (two epochs, the second after the joint switch) under the
    two node groups writes the same ``ckpt-last.pth``, bit for bit, as a
    single node with two ranks (``--standalone --nproc_per_node 2``): the
    run directory, the checkpoints and the writers are rank 0's, read from
    the global rank, and the second group's rank takes its rows.
(b) The native host library built by two processes at once into an empty
    build directory (each node group's local rank 0 builds it at first
    use): both load it and return the same FPS indices, and only the
    library is left in the directory.

Two real hosts stay untested: the machines these tests run on have one."""

import json
import os
import subprocess
import sys
from pathlib import Path

import torch

from test_torch_port_dist import _cls_yaml, _env, _finish, _free_port

REPO = Path(__file__).resolve().parent.parent


def _torchrun(tmp, node_args, exp_name, cfg):
    cmd = [sys.executable, "-m", "torch.distributed.run", *node_args, "--nproc_per_node", "1"
           if "--nnodes" in node_args else "2", "-m", "upp_torch.main", "--launcher", "pytorch",
           "--peft_model", "--config", str(cfg), "--joint_optimization", "0", "--deterministic",
           "--exp_name", exp_name, "--device", "cpu"]
    return subprocess.Popen(cmd, cwd=tmp, env=_env(OMP_NUM_THREADS="1"),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), 600


def test_two_node_groups_write_the_single_node_checkpoint(tmp_path):
    """(a) Bit for bit, model and optimizer."""
    cfg = _cls_yaml(tmp_path, "hosts_cls", max_epoch=1)
    port = _free_port()
    nodes = [_torchrun(tmp_path, ["--nnodes", "2", "--node_rank", str(r), "--master_addr",
                                  "127.0.0.1", "--master_port", port], "two_nodes", cfg)
             for r in (0, 1)]
    outs = [_finish(n) for n in nodes]
    _finish(_torchrun(tmp_path, ["--standalone"], "one_node", cfg))
    base = tmp_path / "experiments" / "hosts_cls" / "plain-network"
    (a,), (b,) = (list((base / f"peft-{n}").glob("*/ckpt-last.pth"))
                  for n in ("two_nodes", "one_node"))
    a, b = (torch.load(p, weights_only=True) for p in (a, b))
    assert a["epoch"] == b["epoch"] == 1 and a["metrics"] == b["metrics"]
    assert a["base_model"].keys() == b["base_model"].keys()
    for k in a["base_model"]:
        assert torch.equal(a["base_model"][k], b["base_model"][k]), k
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    assert sa.keys() == sb.keys() and sa and a["optimizer"]["num_steps"] == b["optimizer"]["num_steps"]
    for i in sa:
        for name in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa[i][name], sb[i][name]), (i, name)
    # one run directory, written by the first node group's rank 0
    assert len(list((base / "peft-two_nodes").iterdir())) == 1
    assert "[joint optimization] switching" in outs[0]
    print(f"[two node groups] ckpt-last equal bit for bit to one node's: "
          f"{len(a['base_model'])} tensors, {len(sa)} AdamW states, epoch {a['epoch']}")


_BUILD = """
import json, sys
from pathlib import Path
import numpy as np
import upp_torch.native as native
native.BUILD_DIR = Path(sys.argv[1])
lib = native.get_lib()
pts = np.random.default_rng(0).standard_normal((2048, 3)).astype(np.float32)
print(json.dumps({"loaded": lib is not None, "idx": native.fps_host(pts, 64).tolist()}))
"""


def test_native_library_built_by_two_processes_at_once(tmp_path):
    """(b) Two builds race into one empty directory: each writes its own
    temporary file and renames it into place."""
    build = tmp_path / "build"
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(build)], cwd=REPO,
                              env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))
    assert all(o["loaded"] for o in outs), "a process fell back to numpy: no g++?"
    assert outs[0]["idx"] == outs[1]["idx"] and len(set(outs[0]["idx"])) == 64
    files = sorted(os.listdir(build))
    assert len(files) == 1 and files[0].startswith("libupp_native-") and files[0].endswith(".so")
