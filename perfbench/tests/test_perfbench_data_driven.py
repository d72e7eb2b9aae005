"""A cell, its configuration, its traffic, its driver and a metric are added
by files and ``BENCHMARK.json`` entries alone: a copy of the harness, with
throwaway files and the entries that name them, runs the new cells without
an edit to any file it already had. The new driver owns its FLOP count:
``step_mfu`` reads it, and is left out where a driver has none."""

import json
import os
import shutil
import subprocess
import sys

from conftest import PERFBENCH, ROOT

DRIVER = '''"""A throwaway traffic kind: the completion sweep, with a FLOP count of
its own ({flops})."""

from drivers import pretask_eval


class Cell(pretask_eval.Cell):
    def flops(self):
        return {flops}
'''

RUN = ("import json, sys, time, torch; sys.path[:0] = [sys.argv[1], sys.argv[2]]\n"
       "from harness import bench\n"
       "for name in sys.argv[3:]:\n"
       "    line, _ = bench.run(name, 5, 0.0, True, time.time(), device=torch.device('cpu'))\n"
       "    print(json.dumps(line))\n")


def test_a_cell_added_by_files_alone_runs(tmp_path):
    copy = tmp_path / "perfbench"
    shutil.copytree(PERFBENCH, copy, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {os.path.join(d, p): open(os.path.join(d, p), "rb").read()
              for d, _, fs in os.walk(copy) for p in fs}
    shutil.copy(copy / "configs" / "upp_pretask_modelnet.json", copy / "configs" / "tiny.json")
    traffic = json.load(open(copy / "traffic" / "pretask_eval.json"))
    traffic.update(batch=2, pool=2, warmup_batches=1, check_batches=1, profile_units=1)
    for name, flops in (("tiny_counted", 10**9), ("tiny_uncounted", None)):
        (copy / "drivers" / f"{name}.py").write_text(DRIVER.format(flops=flops))
        (copy / "traffic" / f"{name}.json").write_text(json.dumps({**traffic, "driver": name}))
    (copy / "metrics" / "units_done.py").write_text(
        '"""Units the window completed."""\n\n\ndef read(run):\n    return run.window.units\n')
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    cells = ["tiny_counted", "tiny_uncounted"]
    for name in cells:
        bench["workloads"].append({"name": name, "config": "tiny", "traffic": name,
                                   "chips": 1, "why": "a test's cell"})
    bench["configs"].append({"name": "tiny", "source": "a test", "file": "perfbench/configs/tiny.json",
                             "reduced": [], "why": "a test's configuration"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "eval_clouds_per_s" in (m["name"], m.get("moves")):
            m["workloads"] += cells
    bench["per_layer"].append({"name": "units_done", "unit": "units", "better": "higher",
                               "source": "host_clock", "layer": "runners", "moves": "setup_s",
                               "workloads": cells})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    out = subprocess.run([sys.executable, "-c", RUN, str(copy), ROOT] + cells, cwd=tmp_path,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    counted, uncounted = [json.loads(x) for x in out.stdout.splitlines() if x.startswith("{")]
    for line in (counted, uncounted):
        assert line["metrics"]["units_done"]["value"] >= 1
        assert set(line["checked"]) == {"cd_gap", "fscore_gap"}
        assert "dispatch_ms.eval" in line["metrics"]
    assert counted["metrics"]["step_mfu.eval"]["value"] > 0
    assert "step_mfu.eval" not in uncounted["metrics"]
    after = {p: open(p, "rb").read() for p in before}
    assert after == before
