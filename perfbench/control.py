"""Readings of the check's control and faults, to set the check's limits.

    python3 perfbench/control.py --workload <name> --seeds 1 2 3

For each seed, on the cell's own sizes, without the program: the control
(the reference with TF32 products, the precision below the configuration's
float32) held to the reference, and for a training cell the fault "half of
the batch left out, the mean over the rest" planted in the reference. Each
line printed is one seed's readings as JSON. The benchmark's runs never run
this.
"""

import time

T0 = time.time()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]


@contextlib.contextmanager
def half_batch():
    """The loss over the first half of the batch alone."""
    from reference import train as rt
    ce = rt.cross_entropy
    rt.cross_entropy = lambda logits, labels: ce(logits[:len(logits) // 2],
                                                 labels[:len(labels) // 2])
    try:
        yield
    finally:
        rt.cross_entropy = ce


def readings(workload: str, seed: int, device, overrides=None, b=None):
    """{"control": numbers[, "half_batch": numbers]} of one seed; ``b``: the
    benchmark's entries (BENCHMARK.json unless given)."""
    import torch
    from harness import bench, cells, inputs
    entry, config, traffic = bench.find(workload, b or bench.load_json(bench.ROOT, "BENCHMARK.json"))
    traffic = {**traffic, **(overrides or {})}
    ctx = bench.Context(seed, seed % inputs.PROGRAM_SEED_MOD, 0.0, False, device, config,
                        traffic, entry)
    if device.type == "cuda":
        from upp_torch import resolve_device
        resolve_device(device)
    cell = bench.set_up(ctx, program=False)
    if isinstance(cell, cells.TrainCell):
        ref = cell.reference_readings()
        out = {"control": cell.compare(cell.reference_readings(tf32=True), ref)}
        with half_batch():
            out["half_batch"] = cell.compare(cell.reference_readings(), ref)
        return out
    P = cell.weights()
    worst = {}
    for i in range(int(traffic["check_batches"])):
        ref = cell.reference(i, P)
        with cells.precision(True):
            ctrl = cell.reference(i, P)
        for k, v in cell.compare_batch(cell.as_answers(ctrl), ref).items():
            worst[k] = max(worst.get(k, 0.0), v)
        if isinstance(ref, torch.Tensor):   # logits: how many labels the control flips
            worst["flipped"] = worst.get("flipped", 0) + int((ref.argmax(-1) !=
                                                               ctrl.argmax(-1)).sum())
        del ref, ctrl
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return {"control": worst}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args()
    import torch
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        t = time.time()
        out = readings(args.workload, seed, device)
        print(json.dumps({"workload": args.workload, "seed": seed, **out,
                          "seconds": time.time() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
