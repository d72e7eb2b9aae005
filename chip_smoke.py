#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (``upp_torch``) once on a CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build the CUDA kernels from ``upp_torch/csrc`` (one nvcc per source,
     in parallel) and print the build time and each kernel's registers and
     spills (``ptxas -v``);
  2. hold each kernel against its plain PyTorch version on the card at
     every shape the paths give it (classification shapes at batch 120,
     pretask shapes at batch 64): FPS indices equal, kNN indices equal and
     distances within 1e-6 (gathered xyz equal), Chamfer indices equal and
     distances bit-equal with and without validity masks (one cloud with no
     valid target each way); time kernel and plain. Then all three again on
     grid-quantized clouds full of repeated points (real ties) at the big
     path shapes, and at edge shapes (kNN and FPS at their limits; Chamfer
     at N=1, M=1 and N or M far the larger) on random and tie clouds, with
     every FPS variant and every Chamfer variant (role, mask) run; the host
     time per wrapper call at three small shapes; and ``torch.cdist`` + min
     as a yardstick beside the Chamfer kernel at (2048, 8192);
  3. kNN backward: gradients to query and points through the kernel's
     autograd Function against autograd through ``knn_plain`` (rtol 1e-5,
     atol 1e-6) at the pretask's (batch 64) and the cls train step's
     (batch 120) gradient shapes; time both backwards;
  4. clean eval: ``make_eval_step`` (FPS 8192→1024, downstream pass, argmax)
     at full width on 120 synthetic 8192-point clouds, seeded weights;
  5. robust inference: ``corrupt_batch`` (viewpoint crop 8192→1024, +48
     lidar, +24 shell points) then the 3-pass ``PointMAEUnify`` at full
     width, batch 120: finite logits, launch counts of one step, time; then
     ``torch.profiler`` over 3 steps: device-busy ms per step, idle share,
     the FPS, kNN and Chamfer kernels' device time;
  6. card vs CPU: the same weights and corrupted input at batch 8 through
     the kernels on the card and the plain versions on the CPU: logits
     within rtol 1e-3 / atol 2e-3, equal argmax;
  7. pretask train: 3 steps of ``make_pretask_train_step`` on
     ``cfgs/pretask_synthetic.yaml`` at full width, batch 64 (``total_bs``
     of ``cfgs/pretask.yaml``): finite loss terms, trainable parameters
     changed and frozen ones bit-unchanged, launch counts of one step, time
     per step, peak memory;
  8. pretask eval: ``make_pretask_eval_step`` (easy crop, viewpoint
     (1,1,1)) at batch 64: finite CDs and F-score, launch counts, time; then
     ``torch.profiler`` over 3 steps, as for the robust step (with the
     Chamfer kernels' device time);
  9. pretask card vs CPU: one train step at batch 4 from the same weights
     and draws, dropout and drop-path off: the four loss terms within
     rtol 1e-3 / atol 2e-3, the trainable gradients' global norm within
     rtol 1e-2;
 10. cls train, PEFT stage: 3 steps of ``runner_cls.make_train_step`` on
     ``cfgs/unify_synthetic_cls.yaml`` at full width, batch 120 (the
     ``total_bs`` of ``cfgs/unify_modelnet_cls.yaml``), with ``PEFT_LIST``:
     finite loss and accuracy, every trainable tensor the step reaches
     changed and every other one bit-unchanged, the launch counts of one
     step (its forward is the robust step's), no kNN backward, ms per step
     and clouds/s (mean of 10 steps after a warm-up), peak memory, and a
     ``torch.profiler`` profile over 3 steps;
 11. cls train, joint stage: ``JOINT_PEFT_LIST`` switched in on the live
     optimizer: the kNN backward runs (its calls by shape, each timed alone
     in phase 3), the head is bit-unchanged by a step, the rectify
     prompter moves; ms per step, peak memory and a profile, in which each
     ``KnnKernel.backward`` call is a ``knn_backward`` range: its calls and
     the device time of what it launched, per step;
 12. cls train card vs CPU: one step at batch 8 in each stage from the same
     weights and draws (drawn on the CPU), dropout and drop-path off: loss
     within rtol 1e-3 / atol 2e-3, the trainable gradients' global norm
     within rtol 1e-2;
 13. CLI: ``python -m upp_torch.main --peft_model`` (in process) trains
     ``cfgs/unify_synthetic_cls.yaml`` on a 48-cloud synthetic split, batch
     24, epochs 0-2 with ``--joint_optimization 1`` (epoch 2 trains the
     joint set), then ``--test --vote --ckpts <its ckpt-best.pth>``: epoch
     times, validation, test and vote accuracy;
 14. seg train, UPP PEFT: 3 steps of ``runner_seg.make_seg_train_step`` on
     the hermetic twin of ``cfgs/unify_shapenetpart_seg.yaml`` (each split
     ``SyntheticPart``, 2048 points) at full width, batch 30 (its
     ``total_bs``), ``SEG_PEFT_LIST``: the launch counts of one step (raw
     crop to 1536 points, +24 shell, +64 lidar, rectify, completion,
     downstream over 128 groups, kNN k=3 to the 2048 query points), finite
     loss, trainable tensors changed and others bit-unchanged, ms per step
     (mean of 10 after a warm-up), peak memory, a profile over 3 steps;
 15. seg eval: the UPP eval step at batch 30: launch counts, normalised
     log-probabilities, ms per batch, a profile;
 16. seg train, full fine-tune: ``PointTransformer_seg`` (the model of
     ``cfgs/finetune_shapenetpart_seg.yaml``), every parameter trainable:
     as phase 14 (FPS 2048→128, kNN k=32 and the k=5 propagation);
 17. seg card vs CPU at batch 4, same weights and draws (drawn on the CPU),
     dropout and drop-path off, no clip: eval log-probabilities within rtol
     1e-3 / atol 2e-3, equal argmax wherever the top two differ by more
     than 4e-3; train loss within rtol 1e-3; trainable-gradient norm within
     rtol 1e-2;
 18. seg CLI: ``upp_torch.main --peft_model`` trains the seg twin (60
     training clouds, batch 30) for epochs 0 and 1, then ``--test
     --peft_model --ckpts <its ckpt-best.pth>``: the mIoU lines of every
     validation and the test, both checkpoints;
 19. pretrain train: 3 steps of ``runner_pretrain.make_pretrain_step`` on
     ``cfgs/pretrain_synthetic.yaml`` (the model of ``cfgs/pretrain.yaml``:
     384-dim, 12 + 4 blocks, 64 groups of 32, mask ratio 0.6, CD-L2) at
     batch 128 (its ``total_bs``) on 8192-point synthetic clouds: the launch
     counts of one step (FPS 8192→1024 and 1024→64, kNN k=32, one Chamfer
     call over 128 x 38 rebuilt groups of 32), finite loss, every parameter
     the loss reaches changed (the first that did not is named), ms per
     step (mean of 10 after a warm-up), clouds/s, peak memory and a profile
     over 3 steps;
 20. probe features: ``Point_MAE``'s ``eval_features`` at batch 128 on the
     card against the same weights and points on the CPU (rtol 1e-3, atol
     2e-3), its launch counts and time (the LinearSVC fit needs
     scikit-learn, which the card's machine lacks: CPU tests only);
 21. pretrain card vs CPU at batch 4: one step from the same weights, group
     split and augmentation draws, drop-path off: loss within rtol 1e-3 /
     atol 2e-3, the gradients' global norm within rtol 1e-2;
 22. fine-tune cls: ``PointTransformer`` on the twin of
     ``cfgs/finetune_modelnet_cls.yaml`` (each split ``Synthetic``, 8192
     points) at batch 40: crop, noise, scale-translate, clip 10, every
     parameter trainable; as phase 19, then its eval step at batch 40;
 23. fine-tune card vs CPU at batch 8: eval logits within rtol 1e-3 / atol
     2e-3 with equal argmax; one train step from the same weights and draws
     (drawn on the CPU), dropout and drop-path off, no clip: loss within
     rtol 1e-3 / atol 2e-3, the gradients' norm within rtol 1e-2;
 24. the two-stage CLI: ``upp_torch.main`` pretrains a 48-cloud twin of
     ``cfgs/pretrain_synthetic.yaml`` (batch 24, epochs 0-1, no probe
     split), then ``--finetune_model --ckpts <its ckpt-last.pth>`` trains
     the fine-tune twin for epochs 0-1, then ``--test --finetune_model
     --ckpts <its ckpt-best.pth>`` (ckpt-last when no validation beat 0 %);
     the load reports as missing only the cls tokens and head, as
     unexpected only the decoder side.
Phase 2 also holds FPS and kNN at every seg shape at batch 30, on the seg
clouds and on tie-heavy grid clouds of 2048 points, and FPS, kNN and
Chamfer at the pretrain shapes (batch 128; Chamfer over 4864 clouds of 32
points) and the fine-tune shapes (batch 40), on synthetic and tie-heavy
grid clouds. Launch counts are reset right before each path run (4, 5, 7,
8, 10, 11, 14, 15, 16, 19, 20, 22) and read right after; the
kernel-vs-plain comparisons do not count. Before the last line it prints
the ``kernels`` JSON line (FPS and kNN launches of one cls train step, of
one seg PEFT train step, of one pretrain train step and of one fine-tune
cls train step; Chamfer's of one pretask and of one pretrain train step;
each entry names its ``path``) and the card's name and power limit; the
last line is the ``{"ok": true, "device": ...}`` JSON object.
"""

from __future__ import annotations

import copy
import json
import os
import re
import subprocess
import sys
import time
import types
from collections import Counter

import numpy as np
import torch

CFG = "cfgs/unify_synthetic_cls.yaml"
PRETASK_CFG = "cfgs/pretask_synthetic.yaml"
B = 120                 # the flagship's batch
B_CPU = 8               # card-vs-CPU comparison batch
B_PRETASK = 64          # total_bs of the published cfgs/pretask.yaml
B_PRETASK_CPU = 4       # pretask card-vs-CPU comparison batch
CLI_CLOUDS = 48         # per split of the CLI phase's synthetic dataset
CLI_BS = 24
CLI_DIR = "build/chip_smoke"
SEG_CFG = "cfgs/unify_shapenetpart_seg.yaml"
SEG_FT_CFG = "cfgs/finetune_shapenetpart_seg.yaml"
B_SEG = 30              # total_bs of the published seg configs
B_SEG_CPU = 4           # seg card-vs-CPU comparison batch
N_SEG = 2048            # N_POINTS of cfgs/dataset_configs/ShapeNetPart.yaml
SEG_CLI_CLOUDS = 60     # training split of the seg CLI phase (val and test: 30)
PRETRAIN_CFG = "cfgs/pretrain_synthetic.yaml"   # the model of cfgs/pretrain.yaml
FT_CFG = "cfgs/finetune_modelnet_cls.yaml"
B_PRETRAIN = 128        # total_bs of cfgs/pretrain.yaml
B_PRETRAIN_CPU = 4      # pretrain card-vs-CPU comparison batch
N_MASKED = 38           # int(0.6 * 64) masked groups a cloud
B_REBUILD = B_PRETRAIN * N_MASKED    # the pretrain step's Chamfer clouds of 32 points
B_FT = 40               # total_bs of cfgs/finetune_modelnet_cls.yaml
N_POINTS = 8192
NPOINTS = 1024
SEED = 0
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
F32_FLOP_PER_S = 67e12        # H100 SXM data sheet, float32 outside tensor cores

# every kernel call of one step, with its count per step:
# ("fps", N, n_samples, masked) / ("knn", S, N, k, gather) /
# ("chamfer", N, M, masked)
CLEAN_CALLS = Counter({
    ("fps", 8192, 1024, False): 1,            # make_eval_step's FPS
    ("fps", 1024, 64, False): 1, ("knn", 64, 1024, 32, True): 1,    # group
    ("fps", 64, 32, False): 1, ("knn", 32, 64, 8, True): 1,         # lvl2 group
    ("knn", 64, 32, 8, False): 6,             # propagation in 6 prompted blocks
})
ROBUST_CALLS = Counter({
    ("fps", 8192, 1024, True): 1,             # viewpoint crop (partial half)
    # rectify pass
    ("fps", 1096, 32, False): 1, ("knn", 32, 1096, 16, True): 1,
    ("fps", 32, 32, False): 1, ("knn", 32, 32, 16, True): 1,        # SA group
    ("knn", 32, 32, 16, False): 1,            # propagation2 interp
    ("knn", 1096, 32, 16, False): 1,          # propagation1 interp
    # completion pass
    ("fps", 972, 32, False): 1, ("knn", 32, 972, 16, True): 1,
    ("knn", 32, 32, 6, False): 1,             # mask-token propagate
    ("fps", 1024, 256, False): 1, ("fps", 1228, 1024, False): 1,
    # downstream pass
    ("fps", 1024, 64, False): 1, ("knn", 64, 1024, 32, True): 1,
    ("fps", 64, 32, False): 1, ("knn", 32, 64, 8, True): 1,
    ("knn", 64, 32, 8, False): 6,
})
PRETASK_TRAIN_CALLS = Counter({
    ("fps", 8192, 1024, True): 2,             # viewpoint crop, both halves
    # rectify pass over 1024 + 20 shell + 32 lidar points
    ("fps", 1076, 32, False): 1, ("knn", 32, 1076, 16, True): 1,
    ("fps", 32, 32, False): 1, ("knn", 32, 32, 16, True): 1,        # SA group
    ("knn", 32, 32, 16, False): 1,            # propagation2 interp
    ("knn", 1076, 32, 16, False): 1,          # propagation1 interp
    ("knn", 52, 1024, 4, True): 1,            # noise supervision (K=4)
    # completion pass after dropping the 52 noisiest points
    ("fps", 1024, 32, False): 1, ("knn", 32, 1024, 16, True): 1,
    ("knn", 32, 32, 6, False): 1,             # mask-token propagate, with gradient
    # losses: coarse vs crop, rebuild vs crop, partial+rebuild vs gt
    ("chamfer", 32, 1024, False): 1, ("chamfer", 1024, 1024, False): 1,
    ("chamfer", 2048, 8192, False): 1,
})   # a Chamfer call is two launches: the fused pass and the unpack
PRETASK_EVAL_CALLS = Counter({
    ("fps", 8192, 1024, True): 1,             # easy crop, partial half
    ("fps", 1024, 128, False): 1,             # partial centers
    ("fps", 1024, 32, False): 1, ("knn", 32, 1024, 16, True): 1,
    ("knn", 32, 32, 6, False): 1,
    ("chamfer", 160, 8192, False): 2,         # sparse L1, L2
    ("chamfer", 2048, 8192, False): 5,        # dense L1, L2, F-score, CDL1, CDL2
})
# (call, batch) of the kNN backward checks: the pretask's gradient shapes at
# batch 64, the cls train joint stage's at batch 120
SEG_TRAIN_CALLS = Counter({
    # rectify pass over the 1536-point raw crop + 24 shell + 64 lidar points
    ("fps", 1624, 32, False): 1, ("knn", 32, 1624, 16, True): 1,
    ("fps", 32, 32, False): 1, ("knn", 32, 32, 16, True): 1,        # SA group
    ("knn", 32, 32, 16, False): 1,            # propagation2 interp
    ("knn", 1624, 32, 16, False): 1,          # propagation1 interp
    # completion pass over the 1459 points the rectify drop keeps
    ("fps", 1459, 32, False): 1, ("knn", 32, 1459, 16, True): 1,
    ("knn", 32, 32, 6, False): 1,             # mask-token propagate
    ("fps", 1024, 384, False): 1, ("fps", 1843, 1536, False): 1,
    # downstream pass, 128 groups of 32, then propagation_0 to the 2048 queries
    ("fps", 1536, 128, False): 1, ("knn", 128, 1536, 32, True): 1,
    ("knn", 2048, 128, 3, False): 1,
})
SEG_FT_CALLS = Counter({("fps", 2048, 128, False): 1, ("knn", 128, 2048, 32, True): 1,
                        ("knn", 2048, 128, 5, False): 1})    # PointTransformer_seg
SEG_EVAL_CALLS = Counter({("fps", 2048, 128, False): 1, ("knn", 128, 2048, 32, True): 1,
                          ("knn", 2048, 128, 3, False): 1})  # downstream pass alone
PRETRAIN_CALLS = Counter({("fps", 8192, 1024, False): 1,      # FPS to npoints
                          ("fps", 1024, 64, False): 1, ("knn", 64, 1024, 32, True): 1})
PRETRAIN_CHAMFER = Counter({("chamfer", 32, 32, False): 1})   # rebuild vs masked groups
FT_CALLS = Counter({("fps", 8192, 1024, True): 1,             # viewpoint crop
                    ("fps", 1096, 64, False): 1, ("knn", 64, 1096, 32, True): 1})
FT_EVAL_CALLS = PRETRAIN_CALLS    # FPS to npoints, then the group (as the probe)
KNN_GRAD_CALLS = ((("knn", 32, 32, 6, False), B_PRETASK), (("knn", 32, 1024, 16, True), B_PRETASK),
                  (("knn", 64, 32, 8, False), B), (("knn", 64, 1024, 32, True), B),
                  (("knn", 32, 32, 6, False), B), (("knn", 32, 972, 16, True), B))
# path shapes held to the plain versions again on grid-quantized clouds full
# of repeated points (every squared distance exact: real ties), at batch B
# (Chamfer at B_PRETASK)
TIE_CALLS = (("knn", 64, 1024, 32, True), ("knn", 32, 1096, 16, True),
             ("fps", 8192, 1024, True), ("fps", 1228, 1024, False),
             ("chamfer", 2048, 8192, False), ("chamfer", 160, 8192, False))
# the kernels' limits and, with the path shapes, every FPS variant (csrc/fps.cu
# chooses one by N) and both Chamfer roles (ops/chamfer_cuda.py::launch_plan
# makes the larger cloud resident), on random clouds and on tie clouds, at
# batch B_EDGE; every Chamfer check also runs masked, with one cloud whose
# targets are all invalid in each direction
B_EDGE = 8
EDGE_CALLS = (("knn", 64, 16384, 32, True), ("knn", 37, 16, 16, True),
              ("knn", 1, 1024, 32, True), ("knn", 100, 1096, 16, False),
              ("fps", 16384, 1024, True), ("fps", 16384, 256, False),
              ("fps", 3000, 512, False), ("fps", 100, 64, False), ("fps", 20, 20, True),
              ("chamfer", 1, 1000, False), ("chamfer", 1000, 1, False),
              ("chamfer", 37, 1000, False), ("chamfer", 1000, 37, False),
              ("chamfer", 16384, 2048, False))
HOST_CALLS = (("knn", 64, 32, 8, False), ("fps", 64, 32, False),
              ("chamfer", 32, 1024, False))   # host cost per call
KERNEL_SOURCES = {
    "fps": ("upp_torch/csrc/fps.cu", "upp_tpu/ops/fps_pallas.py:38"),
    "knn": ("upp_torch/csrc/knn.cu", "upp_tpu/ops/knn_pallas.py:48"),
    "chamfer": ("upp_torch/csrc/chamfer.cu", "upp_tpu/ops/chamfer_pallas.py:44"),
}


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def synthetic_clouds(n: int):
    """(clouds [n, 8192, 3], labels [n]) of the synthetic test split."""
    from upp_torch.data.synthetic import SyntheticDataset
    from upp_torch.utils.config import ConfigDict
    ds = SyntheticDataset(ConfigDict(N_POINTS=N_POINTS, NUM_CATEGORY=6,
                                     SIZE=n, subset="test"))
    return (np.stack([ds[i][2][0] for i in range(n)]).astype(np.float32),
            np.asarray([ds[i][2][1] for i in range(n)], np.int64))


def _wrappers():
    """(name, module, attribute, key of a call) of each kernel wrapper."""
    from upp_torch.ops import chamfer_cuda, fps_cuda, knn_cuda
    return (
        ("fps", fps_cuda, "fps_idx",
         lambda xyz, n_samples, valid=None, start_idx=None:
             ("fps", xyz.shape[1], n_samples, valid is not None)),
        ("knn", knn_cuda, "knn",
         lambda query, points, k, gather:
             ("knn", query.shape[1], points.shape[1], k, gather)),
        ("chamfer", chamfer_cuda, "nn_both",
         lambda x, y, valid_x=None, valid_y=None:
             ("chamfer", x.shape[1], y.shape[1],
              valid_x is not None or valid_y is not None)),
    )


class Recorder:
    """Counts the kernel calls of a path run by shape, around the wrappers.
    The wrappers' own launch counters are what the run reports: a wrapper
    increments its counter through its module-level name, which points at
    the recording stand-in here, so the stand-in carries the counter and
    hands it back on exit."""

    def __init__(self):
        self.wrappers = _wrappers()
        self.calls = Counter()

    def __enter__(self):
        self.orig = []
        for _, mod, attr, key in self.wrappers:
            f0 = getattr(mod, attr)

            def rec(*a, _f0=f0, _key=key, **kw):
                self.calls[_key(*a, **kw)] += 1
                return _f0(*a, **kw)

            rec.launches = f0.launches
            setattr(mod, attr, rec)
            self.orig.append(f0)
        return self

    def __exit__(self, *exc):
        for (_, mod, attr, _), f0 in zip(self.wrappers, self.orig):
            f0.launches = getattr(mod, attr).launches
            setattr(mod, attr, f0)


def reset_counts():
    for _, mod, attr, _ in _wrappers():
        getattr(mod, attr).launches = 0


def read_counts():
    return {name: getattr(mod, attr).launches for name, mod, attr, _ in _wrappers()}


def bound_parts(call, bsz):
    """(bytes, operations) the call must move and do: inputs read once,
    outputs written once; 10 float32 operations per (point, round) of FPS
    (3 sub, 3 mul, 2 add, min, compare), per (query, point) pair of kNN
    (3 sub, 3 mul, 2 add, compare against the k-th, plus the select) and per
    (x, y) pair of Chamfer (3 sub, 3 mul, 2 add, one minimum in each
    direction; a pair is evaluated once in the least work)."""
    if call[0] == "fps":
        _, n, s, masked = call
        nbytes = bsz * n * 12 + bsz * s * 4 + (bsz * n + bsz * 4 if masked else 0)
        return nbytes, 10 * bsz * s * n
    if call[0] == "chamfer":
        _, n, m, masked = call
        nbytes = bsz * (n + m) * (12 + 8 + (1 if masked else 0))
        return nbytes, 10 * bsz * n * m
    _, s, n, k, gather = call
    nbytes = bsz * (s * 12 + n * 12 + s * k * 8 + (s * k * 12 if gather else 0))
    return nbytes, 10 * bsz * s * n


def seg_shapes():
    """Every kernel shape of the seg train (PEFT, fine-tune) and eval steps."""
    return sorted(set(SEG_TRAIN_CALLS) | set(SEG_FT_CALLS) | set(SEG_EVAL_CALLS))


def baseline_shapes():
    """(call, batch) of every kernel shape of the pretrain (batch 128; its
    Chamfer over 4864 clouds) and fine-tune cls (batch 40) paths."""
    return ([(c, B_PRETRAIN) for c in sorted(PRETRAIN_CALLS)]
            + [(c, B_REBUILD) for c in PRETRAIN_CHAMFER]
            + [(c, B_FT) for c in sorted(set(FT_CALLS) | set(FT_EVAL_CALLS))])


def kernel_shapes():
    """(call, batch) of every kernel shape the paths run: the classification
    shapes at batch 120, the pretask ones it does not share at batch 64, the
    segmentation ones at batch 30, the pretrain and fine-tune ones."""
    cls = set(CLEAN_CALLS) | set(ROBUST_CALLS)
    pretask = (set(PRETASK_TRAIN_CALLS) | set(PRETASK_EVAL_CALLS)) - cls
    return ([(c, B) for c in sorted(cls)] + [(c, B_PRETASK) for c in sorted(pretask)]
            + [(c, B_SEG) for c in seg_shapes()] + baseline_shapes())


def _check_fps(call, clouds, gen):
    from upp_torch.ops import fps_cuda
    from upp_torch.ops.corrupt import _crop_masks
    from upp_torch.ops.fps import fps_plain_idx
    from upp_torch.ops.geometry import index_points
    _, n, s, masked = call
    xyz = clouds[:, :n].contiguous()
    valid = start = None
    if masked:
        d, crop = _crop_masks(xyz, n // 4, None, gen)
        valid = ~crop
        start = torch.where(valid, d, torch.inf).argmin(1)
    k_idx = fps_cuda.fps_idx(xyz, s, valid, start)
    p_idx = fps_plain_idx(xyz, s, valid, start)
    torch.cuda.synchronize()
    if not torch.equal(k_idx.long(), p_idx):
        bad = (k_idx.long() != p_idx).sum().item()
        raise AssertionError(f"FPS {call}: {bad} indices differ from the plain version")
    err = (index_points(xyz, k_idx.long()) - index_points(xyz, p_idx)).abs().max().item()
    ms = cuda_ms(lambda: fps_cuda.fps_idx(xyz, s, valid, start), reps=10)
    plain_ms = cuda_ms(lambda: fps_plain_idx(xyz, s, valid, start), reps=2, warmup=1)
    return err, ms, plain_ms


def _check_knn(call, clouds):
    from upp_torch.ops import knn_cuda
    from upp_torch.ops.geometry import index_points
    from upp_torch.ops.knn import knn_plain
    _, s, n, k, gather = call
    points = clouds[:, :n].contiguous()
    query = clouds[:, :s].contiguous()
    kd, ki, kn = knn_cuda.knn(query, points, k, gather)
    pd, pi = knn_plain(query, points, k)
    torch.cuda.synchronize()
    if not torch.equal(ki.long(), pi):
        bad = (ki.long() != pi).sum().item()
        raise AssertionError(f"kNN {call}: {bad} indices differ from the plain version")
    err = (kd - pd).abs().max().item()
    if err > 1e-6:
        raise AssertionError(f"kNN {call}: distances differ by {err} > 1e-6")
    if gather:
        nerr = (kn - index_points(points, pi)).abs().max().item()
        if nerr != 0.0:
            raise AssertionError(f"kNN {call}: gathered xyz differ by {nerr}")
    ms = cuda_ms(lambda: knn_cuda.knn(query, points, k, gather), reps=20)
    plain_ms = cuda_ms(lambda: knn_plain(query, points, k), reps=5)
    return err, ms, plain_ms


CHAMFER_VARIANTS_RUN = set()   # (y resident, masked) of every Chamfer check


def _check_chamfer(call, clouds, gen):
    """x: the next cloud's first N points (another shape), y: the cloud's
    first M points; unmasked and with random validity masks, under which
    the first cloud has no valid y and the last no valid x. Indices equal,
    distances bit-equal."""
    from upp_torch.ops import chamfer_cuda
    from upp_torch.ops.chamfer import nn_both_plain
    _, n, m, _ = call
    x = torch.roll(clouds, 1, 0)[:, :n].contiguous()
    y = clouds[:, :m].contiguous()
    bsz = clouds.shape[0]
    vx = torch.rand((bsz, n), generator=gen, device=x.device) > 0.2
    vy = torch.rand((bsz, m), generator=gen, device=x.device) > 0.2
    vy[0] = False
    vx[-1] = False
    swap = chamfer_cuda.launch_plan(bsz, n, m).swap
    err = 0.0
    for masks in ((None, None), (vx, vy)):
        masked = masks[0] is not None
        got = chamfer_cuda.nn_both(x, y, *masks)
        want = nn_both_plain(x, y, *masks)
        torch.cuda.synchronize()
        for name, g, w in zip(("i1", "i2"), got[1::2], want[1::2]):
            if not torch.equal(g.long(), w):
                bad = (g.long() != w).sum().item()
                raise AssertionError(f"Chamfer {call} masked={masked}: "
                                     f"{bad} {name} differ from the plain version")
        e = max((g - w).abs().max().item() for g, w in zip(got[0::2], want[0::2]))
        if not all(torch.equal(g, w) for g, w in zip(got[0::2], want[0::2])):
            raise AssertionError(f"Chamfer {call} masked={masked}: distances not bit-equal "
                                 f"(max difference {e})")
        err = max(err, e)
        CHAMFER_VARIANTS_RUN.add((swap, masked))
    ms = cuda_ms(lambda: chamfer_cuda.nn_both(x, y), reps=10)
    plain_ms = cuda_ms(lambda: nn_both_plain(x, y), reps=2, warmup=1)
    return err, ms, plain_ms


def tie_clouds(bsz, n, gen):
    """[bsz, n, 3] on the card: n // 2 points of the grid of multiples of 1/8
    in [-1, 1] and n - n // 2 repeats of them, in a random order."""
    base = torch.randint(-8, 9, (bsz, n // 2, 3), generator=gen, device=gen.device) / 8.0
    pick = torch.randint(0, n // 2, (bsz, n - n // 2), generator=gen, device=gen.device)
    cloud = torch.cat([base, torch.gather(base, 1, pick[..., None].expand(-1, -1, 3))], 1)
    order = torch.argsort(torch.rand((bsz, n), generator=gen, device=gen.device), 1)
    return torch.gather(cloud, 1, order[..., None].expand(-1, -1, 3)).contiguous()


def _check(call, clouds, gen):
    if call[0] == "fps":
        return _check_fps(call, clouds, gen)
    if call[0] == "knn":
        return _check_knn(call, clouds)
    return _check_chamfer(call, clouds, gen)


def rebuild_clouds(clouds):
    """[4864, 32, 3]: the first 38 x 32 points of each of 128 clouds, cut
    into clouds of 32 (the pretrain Chamfer's shape)."""
    return clouds[:B_PRETRAIN, :B_REBUILD // B_PRETRAIN * 32].reshape(B_REBUILD, 32, 3)


def phase_kernels(clouds, seg_clouds, card):
    """Kernel vs plain on the card at every path shape (the seg shapes on
    the seg clouds, the pretrain Chamfer on ``rebuild_clouds``). Returns
    per-shape rows."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    sources = {B_SEG: seg_clouds, B_REBUILD: rebuild_clouds(clouds)}
    rows = []
    for call, bsz in kernel_shapes():
        src = sources.get(bsz, clouds)
        err, ms, plain_ms = _check(call, src[:bsz].contiguous(), gen)
        nbytes, ops = bound_parts(call, bsz)
        rows.append({"call": list(call), "batch": bsz, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "bytes": nbytes, "ops": ops})
        print(f"[kernel] {call}: max_abs_err {err:.3g}, kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {bound_ms(nbytes, ops):.4f} ms "
              f"(B={bsz}; {card})", flush=True)
    return rows


def phase_kernel_ties_and_edges(card):
    """FPS, kNN and Chamfer vs plain on tie clouds at the big path shapes
    (batch B, Chamfer B_PRETASK), and at the edge shapes (batch B_EDGE) on
    random and on tie clouds; every FPS variant and every Chamfer variant
    (role and mask) must have run."""
    from upp_torch.ops import fps_cuda
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    cases = [("ties", call, tie_clouds(B_PRETASK if call[0] == "chamfer" else B, 8192, gen))
             for call in TIE_CALLS]
    cases += [("seg ties", call, tie_clouds(B_SEG, N_SEG, gen)) for call in seg_shapes()]
    cases += [("baseline ties", call, tie_clouds(bsz, 32 if bsz == B_REBUILD else N_POINTS, gen))
              for call, bsz in baseline_shapes()]
    for call in EDGE_CALLS:
        n = max(call[1:3]) if call[0] in ("knn", "chamfer") else call[1]
        cases.append(("edge", call, torch.randn((B_EDGE, n, 3), generator=gen,
                                                device=gen.device)))
        cases.append(("edge ties", call, tie_clouds(B_EDGE, n, gen)))
    for kind, call, clouds in cases:
        err, ms, plain_ms = _check(call, clouds, gen)
        print(f"[kernel {kind}] {call}: identical to plain, max_abs_err {err:.3g}, kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms (B={clouds.shape[0]}; {card})", flush=True)
    fps_n = {c[1] for c, _ in kernel_shapes() if c[0] == "fps"}
    fps_n |= {c[1] for c in EDGE_CALLS if c[0] == "fps"}
    variants = {n: fps_cuda.variant(n) for n in sorted(fps_n)}
    print(f"[kernel variants] FPS variant by N: {variants}", flush=True)
    if set(variants.values()) != set(range(fps_cuda.num_variants())):
        raise AssertionError(f"FPS variants run {set(variants.values())}, of "
                             f"{fps_cuda.num_variants()}")
    print(f"[kernel variants] Chamfer (y resident, masked) run: "
          f"{sorted(CHAMFER_VARIANTS_RUN)}", flush=True)
    if CHAMFER_VARIANTS_RUN != {(s, m) for s in (False, True) for m in (False, True)}:
        raise AssertionError(f"Chamfer variants run {sorted(CHAMFER_VARIANTS_RUN)}, of 4")


def phase_chamfer_yardstick(clouds, card):
    """``torch.cdist`` then a minimum over each axis at (2048, 8192), batch
    B_PRETASK: not one call computing the same function (its distances are
    not the kernel's arithmetic, and it keeps the [B, N, M] matrix), so a
    yardstick printed here and not the ``library_ms`` of the kernels line."""
    from upp_torch.ops import chamfer_cuda
    x = torch.roll(clouds[:B_PRETASK], 1, 0)[:, :2048].contiguous()
    y = clouds[:B_PRETASK, :8192].contiguous()

    def cdist_min():
        d = torch.cdist(x, y)
        return d.min(2), d.min(1)
    ms = cuda_ms(cdist_min, reps=5)
    kernel_ms = cuda_ms(lambda: chamfer_cuda.nn_both(x, y), reps=10)
    print(f"[chamfer yardstick] (2048, 8192): torch.cdist + min over each axis {ms:.4f} ms, "
          f"the kernel {kernel_ms:.4f} ms (CUDA events; B={B_PRETASK}; {card})", flush=True)


def phase_host_cost(clouds, card, reps=200):
    """Host time per wrapper call at small shapes: the enqueue of ``reps``
    calls on the host clock, the device time by CUDA events beside it."""
    from upp_torch.ops import chamfer_cuda, fps_cuda, knn_cuda
    for call in HOST_CALLS:
        if call[0] == "knn":
            _, s, n, k, gather = call
            points, query = clouds[:, :n].contiguous(), clouds[:, :s].contiguous()

            def fn():
                return knn_cuda.knn(query, points, k, gather)
        elif call[0] == "chamfer":
            _, n, m, _ = call
            x, y = clouds[:, :n].contiguous(), clouds[:, :m].contiguous()

            def fn():
                return chamfer_cuda.nn_both(x, y)
        else:
            _, n, s, _ = call
            xyz = clouds[:, :n].contiguous()

            def fn():
                return fps_cuda.fps_idx(xyz, s)
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_us = (time.perf_counter() - t0) / reps * 1e6
        torch.cuda.synchronize()
        dev_us = cuda_ms(fn, reps) * 1e3
        print(f"[host] {call}: {host_us:.1f} us of host time per call ({reps} calls "
              f"enqueued), {dev_us:.1f} us per call by CUDA events (B={clouds.shape[0]}; "
              f"{card})", flush=True)


def bound_ms(nbytes, ops):
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOP_PER_S) * 1e3


def phase_knn_backward(clouds, card):
    """Gradients through the kernel's autograd Function vs autograd through
    ``knn_plain`` at the pretask's and the cls train step's gradient-carrying
    kNN shapes. Returns the backward's ms through the Function by (call,
    batch)."""
    from upp_torch.ops.geometry import index_points
    from upp_torch.ops.knn import knn, knn_plain, knn_points
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    backward_ms = {}
    for call, bsz in KNN_GRAD_CALLS:
        _, s, n, k, gather = call
        points = clouds[:bsz, :n].contiguous()
        query = (clouds[:bsz, n:n + s] * 0.9).contiguous()
        g_d = torch.randn((bsz, s, k), generator=gen, device=points.device)
        g_nb = torch.randn((bsz, s, k, 3), generator=gen, device=points.device)

        def loss(q, p, kernel):
            if kernel:
                out = knn_points(q, p, k) if gather else knn(q, p, k)
            else:
                d, idx = knn_plain(q, p, k)
                out = (d, idx, index_points(p, idx))
            total = (out[0] * g_d).sum()
            return total + (out[2] * g_nb).sum() if gather else total

        grads, times = [], []
        for kernel in (True, False):
            q = query.clone().requires_grad_(True)
            p = points.clone().requires_grad_(True)
            value = loss(q, p, kernel)
            grads.append(torch.autograd.grad(value, (q, p), retain_graph=True))
            times.append(cuda_ms(lambda: torch.autograd.grad(value, (q, p), retain_graph=True),
                                 reps=10))
        for name, g, w in zip(("query", "points"), *grads):
            if not torch.allclose(g, w, rtol=1e-5, atol=1e-6):
                raise AssertionError(f"kNN backward {call}: {name} gradients differ by "
                                     f"{(g - w).abs().max().item()}")
        err = max((g - w).abs().max().item() for g, w in zip(*grads))
        backward_ms[(call, bsz)] = times[0]
        print(f"[knn backward] {call}: max |grad diff| {err:.3g} (rtol 1e-5, atol 1e-6); "
              f"backward through the kernel's Function {times[0]:.4f} ms, through "
              f"knn_plain {times[1]:.4f} ms (B={bsz}; {card})", flush=True)
    return backward_ms


CHAMFER_KERNELS = ("nn_fused_kernel", "unpack_kernel")


def profile_steps(step, name, step_ms, card, bsz=B, steps=3, rows=10, ranges=()):
    """``torch.profiler`` over ``steps`` steps: the device's busy time per
    step (the self device time of its own events: kernels, copies, memsets),
    the wall time per step, the idle share against both the profiled and the
    unprofiled (``step_ms``) step, the FPS, kNN and Chamfer kernels' share,
    and the largest rows; for each ``record_function`` name in ``ranges``,
    its calls per step and the device time of what it launched. Returns
    {name: (calls, device ms) per step} of ``ranges``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    events = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                     and not getattr(e, "is_user_annotation", False)), key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in events) / 1e3 / steps
    if busy <= 0.0:
        print(f"[{name} profile] the profiler saw no device time: busy time and idle "
              "share not measured", flush=True)
        return {}
    fps_ms, knn_ms, chamfer_ms = (
        sum(dev_us(e) for e in events if any(k in e.key for k in kernels)) / 1e3 / steps
        for kernels in (("fps_kernel",), ("knn_kernel",), CHAMFER_KERNELS))
    print(f"[{name} profile] {steps} steps: device busy {busy:.3f} ms/step (FPS kernels "
          f"{fps_ms:.3f}, kNN kernels {knn_ms:.3f}, Chamfer kernels {chamfer_ms:.3f}); wall "
          f"{wall_ms:.2f} ms/step profiled (idle share {1 - busy / wall_ms:.3f}), "
          f"{step_ms:.2f} unprofiled (idle share {1 - busy / step_ms:.3f}) (B={bsz}; {card})",
          flush=True)
    for e in events[:rows]:
        print(f"[{name} profile]   {dev_us(e) / 1e3 / steps:8.3f} ms/step  "
              f"{e.count // steps:5d} calls/step  {e.key[:90]}", flush=True)
    # a range's host-side event holds the device time of every kernel
    # launched inside it (its children's included)
    spans = {}
    for r in ranges:
        mine = [e for e in prof.events() if e.name == r and e.device_type == DeviceType.CPU]
        ms = sum(getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
                 for e in mine) / 1e3 / steps
        spans[r] = (len(mine) / steps, ms)
        print(f"[{name} profile] {r}: {len(mine) / steps:g} calls/step, device {ms:.3f} "
              f"ms/step (kernels launched inside it)", flush=True)
    return spans


def check_calls(name, rec, want):
    """The path run's calls by shape equal ``want``, and every kernel of the
    path launched at least once (by its wrapper's own counter)."""
    got = Counter({k: v for k, v in rec.calls.items()})
    if got != want:
        raise AssertionError(f"{name}: kernel calls {dict(got)} != expected {dict(want)}")
    counts = read_counts()
    idle = sorted({c[0] for c in want if counts[c[0]] < 1})
    if idle:
        raise AssertionError(f"{name} launched no {idle} kernel: {counts}")
    return counts


def kernel_entry(name, rows, table, launches, bsz, path):
    """The ``kernels`` JSON entry of one kernel on one path: ms, plain and
    bound summed over one step's calls (``table``, at batch ``bsz``) from
    the per-shape rows."""
    src, replaces = KERNEL_SOURCES[name]
    mine = [(r, table[tuple(r["call"])]) for r in rows
            if r["call"][0] == name and r["batch"] == bsz and tuple(r["call"]) in table]
    t_bytes = sum(r["bytes"] * c for r, c in mine) / HBM_BYTES_PER_S * 1e3
    t_ops = sum(r["ops"] * c for r, c in mine) / F32_FLOP_PER_S * 1e3
    return {"name": name, "path": path, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows if r["call"][0] == name),
            "ms": sum(r["ms"] * c for r, c in mine),
            "plain_ms": sum(r["plain_ms"] * c for r, c in mine),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


def no_dropout(model):
    """Dropout and drop-path off (their draws differ between devices)."""
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
        if hasattr(m, "drop_path_rate"):
            m.drop_path_rate = 0.0
    return model


def pretask_setup(config, device):
    """(model, optimizer, train step, eval step) of the pretask path from
    the seeded weights, with the stage-1 trainable set."""
    from upp_torch.train.optim import build_optimizer, set_trainable
    from upp_torch.train.runner_cls import init_model
    from upp_torch.train.runner_pretask import (PRETASK_PEFT_LIST, make_pretask_eval_step,
                                                make_pretask_train_step)
    args = types.SimpleNamespace(seed=SEED, noise=True,
                                 noise_type=["gaussian_noise", "lidar_noise"])
    model = init_model(args, config, device)
    set_trainable(model, PRETASK_PEFT_LIST)
    optimizer = build_optimizer(config, model, steps_per_epoch=1)
    return (model, optimizer, make_pretask_train_step(model, optimizer, config, args),
            make_pretask_eval_step(model, config, "easy"))


def phase_pretask(clouds, config, card, device):
    """Pretask train (3 steps) and eval at full width, batch 64. Returns the
    launch counts of one train step."""
    from upp_torch.train.runner_pretask import LOSS_NAMES
    model, _, train_step, eval_step = pretask_setup(config, device)
    gt = clouds[:B_PRETASK]
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with Recorder() as rec:
        terms = train_step(gt)
        torch.cuda.synchronize()
    counts = check_calls("pretask train", rec, PRETASK_TRAIN_CALLS)
    history = [terms] + [train_step(gt) for _ in range(2)]
    for i, t in enumerate(history):
        vals = {k: float(v) for k, v in t.items()}
        if not all(np.isfinite(v) for v in vals.values()):
            raise AssertionError(f"pretask train step {i}: loss terms not finite: {vals}")
        print(f"[pretask train] step {i}: " + ", ".join(f"{k} {v:.4f}" for k, v in vals.items()),
              flush=True)
    trainable = [n for n, p in model.named_parameters() if p.requires_grad]
    frozen = [n for n, p in model.named_parameters() if not p.requires_grad]
    params = dict(model.named_parameters())
    stale = [n for n in trainable if torch.equal(params[n].detach(), before[n])]
    moved = [n for n in frozen if not torch.equal(params[n].detach(), before[n])]
    if stale or moved or not trainable:
        raise AssertionError(f"pretask train: trainable unchanged {stale[:5]}, "
                             f"frozen changed {moved[:5]}, {len(trainable)} trainable")
    # eager steps wait on the host, whose cores the machine shares: average 10
    step_ms = cuda_ms(lambda: train_step(gt), reps=10, warmup=1)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[pretask train] launches of one step {counts}; {len(trainable)} trainable "
          f"tensors changed, {len(frozen)} frozen bit-unchanged; {step_ms:.2f} ms/step, "
          f"{B_PRETASK / step_ms * 1e3:.1f} clouds/s, peak {peak_gib:.2f} GiB "
          f"(B={B_PRETASK}; {card})", flush=True)
    assert set(LOSS_NAMES) == set(terms)

    vp = torch.tensor((1.0, 1.0, 1.0))
    reset_counts()
    with Recorder() as rec:
        out = eval_step(gt, vp)
        torch.cuda.synchronize()
    eval_counts = check_calls("pretask eval", rec, PRETASK_EVAL_CALLS)
    vals = {k: v.float().mean().item() for k, v in out.items()}
    if not all(np.isfinite(v) for v in vals.values()) or not 0.0 <= vals["F-Score"] <= 1.0:
        raise AssertionError(f"pretask eval: bad metrics {vals}")
    eval_ms = cuda_ms(lambda: eval_step(gt, vp), reps=10, warmup=1)
    print(f"[pretask eval] launches {eval_counts}; "
          + ", ".join(f"{k} {v:.4f}" for k, v in vals.items())
          + f"; {eval_ms:.2f} ms/batch (B={B_PRETASK}; {card})", flush=True)
    profile_steps(lambda: eval_step(gt, vp), "pretask eval", eval_ms, card, bsz=B_PRETASK)
    return counts


def phase_pretask_card_vs_cpu(clouds, config, card, device):
    """One train step at batch 4 on the card and on the CPU from the same
    weights and draws (drawn on the CPU), dropout and drop-path off."""
    from upp_torch.train.runner_pretask import (GAUSSIAN_NUM, LIDAR_NUM, PRETASK_PEFT_LIST,
                                                PretaskDraws)
    bsz = B_PRETASK_CPU
    gen = torch.Generator().manual_seed(SEED + 3)
    v = torch.randn((bsz, 3), generator=gen)
    n_in = int(config.npoints) + GAUSSIAN_NUM
    draws = PretaskDraws(
        num_crop=int(torch.randint(int(N_POINTS * 0.15), int(N_POINTS * 0.5) + 1, (),
                                   generator=gen)),
        viewpoints=v / torch.linalg.norm(v, dim=-1, keepdim=True),
        shell_u=float(torch.rand((), generator=gen)),
        shell_normal=torch.randn((bsz, GAUSSIAN_NUM, 3), generator=gen),
        lidar_idx=torch.randint(0, n_in, (LIDAR_NUM,), generator=gen),
        lidar_factor=1.2 + 0.3 * torch.rand((LIDAR_NUM,), generator=gen),
        aug_scale=2 / 3 + (3 / 2 - 2 / 3) * torch.rand((bsz, 1, 3), generator=gen),
        aug_shift=0.2 * (2 * torch.rand((bsz, 1, 3), generator=gen) - 1))
    results = []
    for dev in (device, torch.device("cpu")):
        model, _, train_step, _ = pretask_setup(config, dev)
        no_dropout(model)
        on_dev = PretaskDraws(**{k: (x.to(dev) if torch.is_tensor(x) else x)
                                 for k, x in vars(draws).items()})
        terms = train_step(clouds[:bsz].to(dev), on_dev)
        gnorm = torch.sqrt(sum((p.grad.double() ** 2).sum() for n, p in model.named_parameters()
                               if p.grad is not None and any(t in n for t in PRETASK_PEFT_LIST)))
        results.append(({k: float(x) for k, x in terms.items()}, float(gnorm)))
    (card_t, card_g), (cpu_t, cpu_g) = results
    print(f"[pretask card vs cpu] recall card {card_t['recall']:.4f}, cpu {cpu_t['recall']:.4f} "
          "(a flipped near-tie in the hard drop shows here)", flush=True)
    for k in ("cropping_coarse", "cropping_dense", "dense", "noise_loss"):
        if not np.isclose(card_t[k], cpu_t[k], rtol=1e-3, atol=2e-3):
            raise AssertionError(f"pretask card vs CPU: {k} {card_t[k]} vs {cpu_t[k]}")
    if not np.isclose(card_g, cpu_g, rtol=1e-2, atol=0.0):
        raise AssertionError(f"pretask card vs CPU: grad norm {card_g} vs {cpu_g}")
    diff = max(abs(card_t[k] - cpu_t[k]) / max(abs(cpu_t[k]), 1e-12)
               for k in ("cropping_coarse", "cropping_dense", "dense", "noise_loss"))
    print(f"[pretask card vs cpu] B={bsz}: loss terms within rel {diff:.3g} (rtol 1e-3, "
          f"atol 2e-3); trainable grad norm card {card_g:.6g}, cpu {cpu_g:.6g} "
          f"(rtol 1e-2) ({card})", flush=True)


class KnnBackwardRecorder:
    """Counts ``KnnKernel.backward`` calls by shape, ("knn", S, N, k,
    gather), and marks each as a ``knn_backward`` profiler range."""

    def __enter__(self):
        from upp_torch.ops.knn import KnnKernel
        self.cls, self.orig = KnnKernel, KnnKernel.backward
        self.calls = Counter()

        def backward(ctx, *grads):
            query, points, idx, nbr = ctx.saved_tensors
            self.calls[("knn", query.shape[1], points.shape[1], idx.shape[2],
                        nbr is not None)] += 1
            with torch.profiler.record_function("knn_backward"):
                return self.orig(ctx, *grads)

        KnnKernel.backward = staticmethod(backward)
        return self

    def __exit__(self, *exc):
        self.cls.backward = staticmethod(self.orig)


def cls_train_setup(config, device, peft_list):
    """(model, optimizer, train step) of the classification path from the
    seeded weights, with the trainable set ``peft_list``."""
    from upp_torch.train.optim import build_optimizer, set_trainable
    from upp_torch.train.runner_cls import init_model, make_train_step
    args = types.SimpleNamespace(seed=SEED, noise=True,
                                 noise_type=["gaussian_noise", "lidar_noise"])
    model = init_model(args, config, device)
    set_trainable(model, peft_list)
    optimizer = build_optimizer(config, model, steps_per_epoch=1)
    return model, optimizer, make_train_step(model, optimizer, config, args)


def _check_moves(name, model, before, must_move):
    """Every parameter in ``must_move`` changed, every other one is
    bit-unchanged. Returns the number of each."""
    params = dict(model.named_parameters())
    stale = [n for n in must_move if torch.equal(params[n].detach(), before[n])]
    moved = [n for n in params if n not in must_move
             and not torch.equal(params[n].detach(), before[n])]
    if stale or moved or not must_move:
        raise AssertionError(f"{name}: unchanged {stale[:5]}, changed outside the set "
                             f"{moved[:5]}, {len(must_move)} to move")
    return len(must_move), len(params) - len(must_move)


def phase_cls_train(clouds, labels, config, card, device, backward_ms):
    """Classification training at full width, batch 120: 3 PEFT steps, then
    the joint switch on the live optimizer. ``backward_ms``: phase 3's kNN
    backward ms by (call, batch). Returns the launch counts of one PEFT
    step."""
    from upp_torch.train.optim import set_trainable
    from upp_torch.train.runner_cls import JOINT_PEFT_LIST, PEFT_LIST
    model, _, train_step = cls_train_setup(config, device, PEFT_LIST)
    pts, lab = clouds[:B], labels[:B]
    snapshot = lambda: {n: p.detach().clone() for n, p in model.named_parameters()}  # noqa: E731
    before = snapshot()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with Recorder() as rec, KnnBackwardRecorder() as bwd:
        out = train_step(pts, lab)
        torch.cuda.synchronize()
    counts = check_calls("cls train (PEFT)", rec, ROBUST_CALLS)
    if bwd.calls:
        raise AssertionError(f"cls train (PEFT): kNN backward ran {dict(bwd.calls)}")
    history = [out] + [train_step(pts, lab) for _ in range(2)]
    for i, m in enumerate(history):
        vals = {k: float(v) for k, v in m.items()}
        if not all(np.isfinite(v) for v in vals.values()):
            raise AssertionError(f"cls train (PEFT) step {i}: not finite: {vals}")
        print(f"[cls train] PEFT step {i}: loss {vals['loss']:.4f}, acc {vals['acc']:.2f}",
              flush=True)
    # the trainable tensors the step reaches have a gradient; the others (the
    # bnorm of blocks that do not propagate, the decoder's) never step
    used = {n for n, p in model.named_parameters() if p.grad is not None}
    n_moved, n_fixed = _check_moves("cls train (PEFT)", model, before, used)
    n_unused = sum(p.requires_grad for p in model.parameters()) - len(used)
    step_ms = cuda_ms(lambda: train_step(pts, lab), reps=10, warmup=1)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[cls train] PEFT: launches of one step {counts}; {n_moved} trainable tensors "
          f"changed, {n_unused} trainable without a gradient and {n_fixed - n_unused} frozen "
          f"bit-unchanged; {step_ms:.2f} ms/step, {B / step_ms * 1e3:.1f} clouds/s, peak "
          f"{peak_gib:.2f} GiB (B={B}; {card})", flush=True)
    profile_steps(lambda: train_step(pts, lab), "cls train PEFT", step_ms, card)

    set_trainable(model, JOINT_PEFT_LIST)
    before = snapshot()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with Recorder() as rec, KnnBackwardRecorder() as bwd:
        out = train_step(pts, lab)
        torch.cuda.synchronize()
    joint_counts = check_calls("cls train (joint)", rec, ROBUST_CALLS)
    if not bwd.calls or any((c, B) not in backward_ms for c in bwd.calls):
        raise AssertionError(f"cls train (joint): kNN backward calls {dict(bwd.calls)}, "
                             f"checked in phase 3: {sorted(backward_ms)}")
    bwd_ms = sum(n * backward_ms[(c, B)] for c, n in bwd.calls.items())
    vals = {k: float(v) for k, v in out.items()}
    if not all(np.isfinite(v) for v in vals.values()):
        raise AssertionError(f"cls train (joint): not finite: {vals}")
    used = {n for n, p in model.named_parameters() if p.grad is not None}
    if any(n.startswith("cls_head_finetune") for n in used) or not any(
            n.startswith("rectify_prompter") for n in used):
        raise AssertionError(f"cls train (joint): wrong set stepped {sorted(used)[:8]}")
    n_moved, n_fixed = _check_moves("cls train (joint)", model, before, used)
    joint_ms = cuda_ms(lambda: train_step(pts, lab), reps=10, warmup=1)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[cls train] joint: launches of one step {joint_counts}; loss {vals['loss']:.4f}; "
          f"kNN backward calls {dict(bwd.calls)}, {bwd_ms:.3f} ms a step estimated from "
          f"phase 3's calls timed alone; {n_moved} tensors changed, the head and {n_fixed} "
          f"others bit-unchanged; {joint_ms:.2f} ms/step, {B / joint_ms * 1e3:.1f} clouds/s, "
          f"peak {peak_gib:.2f} GiB (B={B}; {card})", flush=True)
    with KnnBackwardRecorder():
        spans = profile_steps(lambda: train_step(pts, lab), "cls train joint", joint_ms, card,
                              ranges=("knn_backward",))
    if spans and spans["knn_backward"][0] != sum(bwd.calls.values()):
        print(f"[cls train joint profile] the profile saw {spans['knn_backward'][0]:g} kNN "
              f"backward calls a step of the step's {sum(bwd.calls.values())}: its device "
              "time not measured", flush=True)
    return counts


def phase_cls_card_vs_cpu(clouds, labels, config, card, device, stages=None, tag="cls"):
    """One cls train step at batch 8 in each of ``stages``, (name, trainable
    list or None for every parameter), the PEFT and joint stages unless
    given, on the card and on the CPU, from the same weights and draws
    (drawn on the CPU), dropout and drop-path off, without the gradient clip
    (the norm compared is the gradients' own)."""
    from upp_torch.train.runner_cls import JOINT_PEFT_LIST, PEFT_LIST
    stages = stages or (("PEFT", PEFT_LIST), ("joint", JOINT_PEFT_LIST))
    from upp_torch.train.pipeline import CorruptDraws
    config = copy.deepcopy(config)
    config.grad_norm_clip = None
    bsz = B_CPU
    gen = torch.Generator().manual_seed(SEED + 5)
    v = torch.randn((bsz, 3), generator=gen)
    draws = CorruptDraws(
        viewpoints=v / torch.linalg.norm(v, dim=-1, keepdim=True),
        lidar_idx=torch.randint(0, NPOINTS, (48,), generator=gen),
        lidar_factor=1.2 + 0.3 * torch.rand((48,), generator=gen),
        shell_normal=torch.randn((bsz, 24, 3), generator=gen),
        aug_scale=2 / 3 + (3 / 2 - 2 / 3) * torch.rand((bsz, 1, 3), generator=gen),
        aug_shift=0.2 * (2 * torch.rand((bsz, 1, 3), generator=gen) - 1))
    for stage, peft in stages:
        results = []
        for dev in (device, torch.device("cpu")):
            model, _, train_step = cls_train_setup(config, dev, peft)
            no_dropout(model)
            on_dev = CorruptDraws(**{k: (x.to(dev) if torch.is_tensor(x) else x)
                                     for k, x in vars(draws).items()})
            out = train_step(clouds[:bsz].to(dev), labels[:bsz].to(dev), on_dev)
            gnorm = torch.sqrt(sum((p.grad.double() ** 2).sum() for p in model.parameters()
                                   if p.grad is not None))
            results.append((float(out["loss"]), float(out["acc"]), float(gnorm)))
        (card_l, card_a, card_g), (cpu_l, cpu_a, cpu_g) = results
        if not np.isclose(card_l, cpu_l, rtol=1e-3, atol=2e-3):
            raise AssertionError(f"{tag} card vs CPU ({stage}): loss {card_l} vs {cpu_l}")
        if not np.isclose(card_g, cpu_g, rtol=1e-2, atol=0.0):
            raise AssertionError(f"{tag} card vs CPU ({stage}): grad norm {card_g} vs {cpu_g}")
        print(f"[{tag} card vs cpu] {stage}, B={bsz}: loss card {card_l:.6f}, cpu {cpu_l:.6f} "
              f"(rtol 1e-3, atol 2e-3), acc {card_a:.1f} / {cpu_a:.1f}; trainable grad norm "
              f"card {card_g:.6g}, cpu {cpu_g:.6g} (rtol 1e-2) ({card})", flush=True)


def phase_cls_cli(card):
    """``upp_torch.main`` trains the classifier on a small synthetic split
    with the joint switch, then tests its ``ckpt-best.pth`` with the vote.
    The YAMLs and the run's output stay inside the checkout (``build/``,
    ``experiments/``)."""
    import yaml
    from upp_torch.main import main as upp_main
    cfg = yaml.safe_load(open(CFG))
    for split in ("train", "val", "test"):
        cfg["dataset"][split]["_base_"] = {"NAME": "Synthetic", "N_POINTS": N_POINTS,
                                           "NUM_CATEGORY": 6, "SIZE": CLI_CLOUDS}
    cfg.update(total_bs=CLI_BS, max_epoch=2)
    os.makedirs(CLI_DIR, exist_ok=True)
    paths = {}
    for name in ("cls_cli_train", "cls_cli_test"):      # one log file each
        paths[name] = os.path.join(CLI_DIR, f"{name}.yaml")
        with open(paths[name], "w") as f:
            yaml.safe_dump(cfg, f)
    t0 = time.time()
    best = upp_main(["--peft_model", "--config", paths["cls_cli_train"],
                     "--joint_optimization", "1", "--exp_name", "chip_smoke"])
    train_s = time.time() - t0
    run = sorted(os.listdir("experiments/cls_cli_train/plain-network/peft-chip_smoke"))[-1]
    run = os.path.join("experiments/cls_cli_train/plain-network/peft-chip_smoke", run)
    log = open(os.path.join(run, "cls_cli_train.log")).read()
    epochs = re.findall(r"EPOCH: (\d+) EpochTime = ([\d.]+)", log)
    val = re.findall(r"\[Validation\] EPOCH: (\d+)\s+acc = ([\d.]+)", log)
    best_pth = os.path.join(run, "ckpt-best.pth")
    if (len(epochs) != 3 or "[joint optimization] switching" not in log
            or not os.path.exists(best_pth)
            or not os.path.exists(os.path.join(run, "ckpt-last.pth"))):
        raise AssertionError(f"CLI training: epochs {epochs}, log tail {log[-2000:]}")
    t0 = time.time()
    acc = upp_main(["--test", "--vote", "--peft_model", "--config", paths["cls_cli_test"],
                    "--ckpts", best_pth, "--exp_name", "chip_smoke"])
    test_s = time.time() - t0
    test_dir = "experiments/cls_cli_test/ckpt-best/test-peft-chip_smoke"
    test_log = open(os.path.join(test_dir, sorted(os.listdir(test_dir))[-1],
                                 "cls_cli_test.log")).read()
    vote = re.findall(r"\[TEST_VOTE\] acc = ([\d.]+)", test_log)
    if not vote or "missing_keys" in test_log or not 0.0 <= acc <= 100.0:
        raise AssertionError(f"CLI test: log tail {test_log[-2000:]}")
    print(f"[cls cli] {CLI_CLOUDS} clouds a split, batch {CLI_BS}: epoch times (s) "
          f"{', '.join(f'{e}: {t}' for e, t in epochs)}; validation acc "
          f"{', '.join(f'{e}: {a}' for e, a in val)}; best {best.acc:.4f}; training "
          f"{train_s:.1f} s of wall time; --test --vote --ckpts ckpt-best.pth: acc {acc:.4f}, "
          f"vote acc {vote[0]}, {test_s:.1f} s ({card})", flush=True)


def seg_config(path, sizes=None):
    """The hermetic twin of the seg config at ``path`` as a dict: each
    split's dataset ``SyntheticPart`` with the ShapeNetPart config's 2048
    points (``sizes``: clouds per split)."""
    import yaml
    cfg = yaml.safe_load(open(path))
    for split in ("train", "val", "test"):
        cfg["dataset"][split]["_base_"] = {"NAME": "SyntheticPart", "N_POINTS": N_SEG,
                                           "SIZE": (sizes or {}).get(split, B_SEG)}
    return cfg


def seg_batch(n, device):
    """(clouds [n, 2048, 3], categories [n], part labels [n, 2048]) of the
    ``SyntheticPart`` training split, on ``device``."""
    from upp_torch.data.synthetic import SyntheticPartDataset
    from upp_torch.utils.config import ConfigDict
    ds = SyntheticPartDataset(ConfigDict(N_POINTS=N_SEG, SIZE=n, subset="train"))
    items = [ds[i] for i in range(n)]
    return (torch.from_numpy(np.stack([it[0] for it in items])).to(device),
            torch.tensor([int(it[1][0]) for it in items], device=device),
            torch.from_numpy(np.stack([it[2] for it in items])).long().to(device))


def seg_setup(config, device, unify):
    """(model, train step, eval step) of a seg path from the seeded weights:
    ``SEG_PEFT_LIST`` trainable for the UPP model, everything for the
    fine-tune."""
    from upp_torch.train.optim import build_optimizer, set_trainable
    from upp_torch.train.runner_cls import init_model
    from upp_torch.train.runner_seg import (SEG_PEFT_LIST, make_seg_eval_step,
                                            make_seg_train_step)
    args = types.SimpleNamespace(seed=SEED)
    model = init_model(args, config, device)
    set_trainable(model, SEG_PEFT_LIST if unify else None)
    optimizer = build_optimizer(config, model, steps_per_epoch=1)
    return (model, make_seg_train_step(model, optimizer, config, args, unify),
            make_seg_eval_step(model, config, unify))


def phase_seg_train(name, batch, config, card, device, unify, want):
    """3 seg train steps at full width, batch 30: the launch counts of one
    step (``want``), finite loss and accuracy, every trainable tensor the
    step reaches changed and every other one bit-unchanged; ms per step
    (mean of 10 after a warm-up), peak memory and a profile over 3 steps.
    Returns (launch counts of one step, the eval step)."""
    model, train_step, eval_step = seg_setup(config, device, unify)
    return phase_train(name, train_step, model, batch, card, want, B_SEG), eval_step


def phase_seg_eval(eval_step, batch, card):
    """The UPP seg eval step (downstream pass alone) at batch 30: launch
    counts, log-probabilities finite and normalised, ms per batch."""
    pts, cls, _ = batch
    reset_counts()
    with Recorder() as rec:
        logp = eval_step(pts, cls)
        torch.cuda.synchronize()
    counts = check_calls("seg eval", rec, SEG_EVAL_CALLS)
    total = logp.exp().sum(-1)
    if (logp.shape != (B_SEG, N_SEG, 50) or not torch.isfinite(logp).all()
            or not torch.allclose(total, torch.ones_like(total), atol=1e-4)):
        raise AssertionError(f"seg eval: log-probabilities {tuple(logp.shape)} not finite "
                             "or not normalised")
    eval_ms = cuda_ms(lambda: eval_step(pts, cls), reps=10, warmup=1)
    print(f"[seg eval] launches {counts}; {eval_ms:.2f} ms/batch, "
          f"{B_SEG / eval_ms * 1e3:.1f} clouds/s (B={B_SEG}; {card})", flush=True)
    profile_steps(lambda: eval_step(pts, cls), "seg eval", eval_ms, card, bsz=B_SEG)


def phase_seg_card_vs_cpu(batch, config, card, device):
    """The UPP seg eval and train steps at batch 4 on the card and on the
    CPU from the same weights; the train step on the same draws (drawn on
    the CPU), dropout and drop-path off, no gradient clip: eval
    log-probabilities within rtol 1e-3 / atol 2e-3 and the same argmax
    wherever the top two differ by more than 4e-3; train loss within rtol
    1e-3; the trainable gradients' norm within rtol 1e-2."""
    from upp_torch.train.pipeline import CorruptDraws
    from upp_torch.train.runner_seg import GAUSSIAN_NUM, LIDAR_NUM
    config = copy.deepcopy(config)
    config.grad_norm_clip = None
    bsz = B_SEG_CPU
    gen = torch.Generator().manual_seed(SEED + 6)
    v = torch.randn((bsz, 3), generator=gen)
    kept = N_SEG - N_SEG // 4
    draws = CorruptDraws(
        viewpoints=v / torch.linalg.norm(v, dim=-1, keepdim=True),
        shell_normal=torch.randn((bsz, GAUSSIAN_NUM, 3), generator=gen),
        lidar_idx=torch.randint(0, kept + GAUSSIAN_NUM, (LIDAR_NUM,), generator=gen),
        lidar_factor=1.2 + 0.3 * torch.rand((LIDAR_NUM,), generator=gen),
        aug_scale=2 / 3 + (3 / 2 - 2 / 3) * torch.rand((bsz, 1, 3), generator=gen),
        aug_shift=0.2 * (2 * torch.rand((bsz, 1, 3), generator=gen) - 1))
    results = []
    for dev in (device, torch.device("cpu")):
        pts, cls, lab = (t[:bsz].to(dev) for t in batch)
        model, train_step, eval_step = seg_setup(config, dev, unify=True)
        no_dropout(model)
        logp = eval_step(pts, cls).cpu()
        on_dev = CorruptDraws(**{k: (x.to(dev) if torch.is_tensor(x) else x)
                                 for k, x in vars(draws).items()})
        out = train_step(pts, cls, lab, on_dev)
        gnorm = torch.sqrt(sum((p.grad.double() ** 2).sum() for p in model.parameters()
                               if p.grad is not None))
        results.append((logp, float(out["loss"]), float(gnorm)))
    (card_p, card_l, card_g), (cpu_p, cpu_l, cpu_g) = results
    diff = (card_p - cpu_p).abs().max().item()
    if not torch.allclose(card_p, cpu_p, rtol=1e-3, atol=2e-3):
        raise AssertionError(f"seg card vs CPU: log-probabilities differ by {diff}")
    top2 = cpu_p.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 4e-3
    same = card_p.argmax(-1) == cpu_p.argmax(-1)
    if not same[clear].all():
        raise AssertionError(f"seg card vs CPU: argmax differs at {(~same[clear]).sum().item()} "
                             "points with a clear top")
    if not np.isclose(card_l, cpu_l, rtol=1e-3, atol=0.0):
        raise AssertionError(f"seg card vs CPU: train loss {card_l} vs {cpu_l}")
    if not np.isclose(card_g, cpu_g, rtol=1e-2, atol=0.0):
        raise AssertionError(f"seg card vs CPU: grad norm {card_g} vs {cpu_g}")
    print(f"[seg card vs cpu] B={bsz}: eval max |log-prob diff| {diff:.3g} (rtol 1e-3, atol "
          f"2e-3), argmax equal at all {int(clear.sum())} of {clear.numel()} points with a "
          f"top-two gap above 4e-3 ({int(same.sum())} equal in all); train loss card "
          f"{card_l:.6f}, cpu {cpu_l:.6f} (rtol 1e-3); trainable grad norm card {card_g:.6g}, "
          f"cpu {cpu_g:.6g} (rtol 1e-2) ({card})", flush=True)


def phase_seg_cli(card):
    """``upp_torch.main --peft_model`` trains the hermetic seg twin (60
    training clouds, batch 30) for epochs 0 and 1, then ``--test
    --peft_model --ckpts`` its ``ckpt-best.pth``: the mIoU lines of every
    validation and of the test, both checkpoints."""
    import yaml
    from upp_torch.main import main as upp_main
    cfg = seg_config(SEG_CFG, {"train": SEG_CLI_CLOUDS})
    cfg.update(max_epoch=1, total_bs=B_SEG)
    os.makedirs(CLI_DIR, exist_ok=True)
    paths = {}
    for name in ("seg_cli_train", "seg_cli_test"):
        paths[name] = os.path.join(CLI_DIR, f"{name}.yaml")
        with open(paths[name], "w") as f:
            yaml.safe_dump(cfg, f)
    summary = re.compile(r"Epoch (\d+) test Accuracy: ([\d.]+)  Class avg mIOU: ([\d.]+)  "
                         r"Instance avg mIOU: ([\d.]+)")
    t0 = time.time()
    upp_main(["--peft_model", "--config", paths["seg_cli_train"], "--exp_name", "chip_smoke"])
    train_s = time.time() - t0
    runs = "experiments/seg_cli_train/plain-network/peft-chip_smoke"
    run = os.path.join(runs, sorted(os.listdir(runs))[-1])
    log = open(os.path.join(run, "seg_cli_train.log")).read()
    epochs = re.findall(r"EPOCH: (\d+) EpochTime = ([\d.]+) \(s\) Losses = \['([\d.]+)'", log)
    vals = summary.findall(log)
    best_pth = os.path.join(run, "ckpt-best.pth")
    if (len(epochs) != 2 or len(vals) != 2 or log.count("eval mIoU of ") < 8
            or not all(0.0 < float(loss) < 100.0 for _, _, loss in epochs)
            or not os.path.exists(best_pth)
            or not os.path.exists(os.path.join(run, "ckpt-last.pth"))):
        raise AssertionError(f"seg CLI training: epochs {epochs}, log tail {log[-2000:]}")
    t0 = time.time()
    upp_main(["--test", "--peft_model", "--config", paths["seg_cli_test"], "--ckpts", best_pth,
              "--exp_name", "chip_smoke"])
    test_s = time.time() - t0
    test_dir = "experiments/seg_cli_test/ckpt-best/test-peft-chip_smoke"
    test_log = open(os.path.join(test_dir, sorted(os.listdir(test_dir))[-1],
                                 "seg_cli_test.log")).read()
    test = summary.findall(test_log)
    if not test or "missing_keys" in test_log or "eval mIoU of " not in test_log:
        raise AssertionError(f"seg CLI test: log tail {test_log[-2000:]}")
    print(f"[seg cli] {SEG_CLI_CLOUDS} training clouds, batch {B_SEG}: epoch times (s) and "
          f"mean losses {', '.join(f'{e}: {t} {loss}' for e, t, loss in epochs)}; validation (epoch, accuracy, class "
          f"mIoU, instance mIoU) {vals}; training {train_s:.1f} s of wall time; --test "
          f"--peft_model --ckpts ckpt-best.pth: {test[0][1:]}, {test_s:.1f} s ({card})",
          flush=True)


def pretrain_setup(config, device):
    """(model, train step) of the pretrain path from the seeded weights."""
    from upp_torch.train.optim import build_optimizer
    from upp_torch.train.runner_cls import init_model
    from upp_torch.train.runner_pretrain import make_pretrain_step
    args = types.SimpleNamespace(seed=SEED)
    model = init_model(args, config, device)
    optimizer = build_optimizer(config, model, steps_per_epoch=1)
    return model, make_pretrain_step(model, optimizer, config, args)


def phase_train(name, step, model, batch, card, want, bsz):
    """3 train steps: the launch counts of one (``want``), finite metrics,
    every tensor with a gradient changed and every other one bit-unchanged;
    ms per step (mean of 10 after a warm-up), clouds/s, peak memory and a
    profile over 3 steps. Returns the launch counts."""
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with Recorder() as rec:
        out = step(*batch)
        torch.cuda.synchronize()
    counts = check_calls(name, rec, want)
    history = [out] + [step(*batch) for _ in range(2)]
    for i, m in enumerate(history):
        vals = {k: float(v) for k, v in m.items()}
        if not all(np.isfinite(v) for v in vals.values()):
            raise AssertionError(f"{name} step {i}: not finite: {vals}")
        print(f"[{name}] step {i}: " + ", ".join(f"{k} {v:.4f}" for k, v in vals.items()),
              flush=True)
    used = {n for n, p in model.named_parameters() if p.grad is not None}
    n_moved, n_fixed = _check_moves(name, model, before, used)
    step_ms = cuda_ms(lambda: step(*batch), reps=10, warmup=1)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[{name}] launches of one step {counts}; {n_moved} tensors with a gradient "
          f"changed, {n_fixed} others bit-unchanged; {step_ms:.2f} ms/step, "
          f"{bsz / step_ms * 1e3:.1f} clouds/s, peak {peak_gib:.2f} GiB (B={bsz}; {card})",
          flush=True)
    profile_steps(lambda: step(*batch), name, step_ms, card, bsz=bsz)
    return counts


def phase_probe_features(model, clouds, card, device):
    """``eval_features`` of the pretrained model at batch 128 on the card
    and, from the same weights and points, on the CPU; launch counts and
    time of FPS to 1024 plus the features."""
    from upp_torch.ops.fps import fps
    pts = clouds[:B_PRETRAIN]

    @torch.inference_mode()
    def features(pts):
        model.eval()
        points, _ = fps(pts, NPOINTS)
        return points, model(points, eval_features=True)

    reset_counts()
    with Recorder() as rec:
        points, feats = features(pts)
        torch.cuda.synchronize()
    counts = check_calls("probe features", rec, PRETRAIN_CALLS)
    with torch.inference_mode():
        want = copy.deepcopy(model).cpu()(points.cpu(), eval_features=True)
    diff = (feats.cpu() - want).abs().max().item()
    if feats.shape != want.shape or not torch.allclose(feats.cpu(), want, rtol=1e-3, atol=2e-3):
        raise AssertionError(f"probe features: card vs CPU differ by {diff}")
    ms = cuda_ms(lambda: features(pts), reps=5, warmup=1)
    print(f"[probe features] launches {counts}; features {tuple(feats.shape)}, card vs CPU max "
          f"|diff| {diff:.3g} (rtol 1e-3, atol 2e-3); {ms:.2f} ms/batch, "
          f"{B_PRETRAIN / ms * 1e3:.1f} clouds/s (B={B_PRETRAIN}; {card})", flush=True)


def phase_pretrain_card_vs_cpu(clouds, config, card, device):
    """One pretrain step at batch 4 on the card and on the CPU from the
    same weights, group split and augmentation draws (drawn on the CPU),
    drop-path off."""
    from upp_torch.train.pipeline import AugmentDraws
    bsz = B_PRETRAIN_CPU
    gen = torch.Generator().manual_seed(SEED + 7)
    perm = torch.argsort(torch.rand((bsz, 64), generator=gen), dim=1)
    masks = (perm[:, :64 - N_MASKED], perm[:, 64 - N_MASKED:])
    draws = AugmentDraws(
        aug_scale=2 / 3 + (3 / 2 - 2 / 3) * torch.rand((bsz, 1, 3), generator=gen),
        aug_shift=0.2 * (2 * torch.rand((bsz, 1, 3), generator=gen) - 1))
    results = []
    for dev in (device, torch.device("cpu")):
        model, step = pretrain_setup(config, dev)
        no_dropout(model)
        out = step(clouds[:bsz].to(dev), AugmentDraws(**{k: v.to(dev) for k, v in
                                                        vars(draws).items() if v is not None}),
                   tuple(m.to(dev) for m in masks))
        gnorm = torch.sqrt(sum((p.grad.double() ** 2).sum() for p in model.parameters()
                               if p.grad is not None))
        results.append((float(out["loss"]), float(gnorm)))
    (card_l, card_g), (cpu_l, cpu_g) = results
    if not np.isclose(card_l, cpu_l, rtol=1e-3, atol=2e-3):
        raise AssertionError(f"pretrain card vs CPU: loss {card_l} vs {cpu_l}")
    if not np.isclose(card_g, cpu_g, rtol=1e-2, atol=0.0):
        raise AssertionError(f"pretrain card vs CPU: grad norm {card_g} vs {cpu_g}")
    print(f"[pretrain card vs cpu] B={bsz}: loss card {card_l:.6f}, cpu {cpu_l:.6f} (rtol "
          f"1e-3, atol 2e-3); grad norm card {card_g:.6g}, cpu {cpu_g:.6g} (rtol 1e-2) ({card})",
          flush=True)


def finetune_config():
    """The hermetic twin of ``cfgs/finetune_modelnet_cls.yaml``: each split
    ``Synthetic`` with 8192 points (the model keeps its 40 classes)."""
    import yaml
    cfg = yaml.safe_load(open(FT_CFG))
    for split in ("train", "val", "test"):
        cfg["dataset"][split]["_base_"] = {"NAME": "Synthetic", "N_POINTS": N_POINTS,
                                           "NUM_CATEGORY": 6, "SIZE": CLI_CLOUDS}
    return cfg


def phase_finetune(clouds, labels, config, card, device):
    """Fine-tune cls train at batch 40 (``phase_train``), then its eval step
    at batch 40. Returns the launch counts of one train step."""
    from upp_torch.train.runner_cls import make_eval_step
    model, _, step = cls_train_setup(config, device, None)
    counts = phase_train("finetune cls train", step, model, (clouds[:B_FT], labels[:B_FT]),
                         card, FT_CALLS, B_FT)
    eval_step = make_eval_step(model, config, types.SimpleNamespace(normalize=False))
    reset_counts()
    with Recorder() as rec:
        preds = eval_step(clouds[:B_FT])
        torch.cuda.synchronize()
    eval_counts = check_calls("finetune cls eval", rec, FT_EVAL_CALLS)
    if preds.shape != (B_FT,) or not ((preds >= 0) & (preds < config.model.cls_dim)).all():
        raise AssertionError(f"finetune cls eval: bad predictions {preds}")
    eval_ms = cuda_ms(lambda: eval_step(clouds[:B_FT]), reps=10, warmup=1)
    print(f"[finetune cls eval] launches {eval_counts}; {eval_ms:.2f} ms/batch, "
          f"{B_FT / eval_ms * 1e3:.1f} clouds/s (B={B_FT}; {card})", flush=True)
    return counts


def phase_finetune_logits(clouds, config, card, device):
    """``PointTransformer``'s eval logits at batch 8 on the card and on the
    CPU, from the same weights and points."""
    from upp_torch.ops.fps import fps
    from upp_torch.train.runner_cls import init_model
    args = types.SimpleNamespace(seed=SEED)
    with torch.inference_mode():
        points, _ = fps(clouds[:B_CPU], NPOINTS)
        card_l = init_model(args, config, device)(points).cpu()
        cpu_l = init_model(args, config, torch.device("cpu"))(points.cpu())
    diff = (card_l - cpu_l).abs().max().item()
    if not torch.allclose(card_l, cpu_l, rtol=1e-3, atol=2e-3) or not torch.equal(
            card_l.argmax(-1), cpu_l.argmax(-1)):
        raise AssertionError(f"finetune card vs CPU: logits differ by {diff}")
    print(f"[finetune card vs cpu] B={B_CPU}: eval max |logit diff| {diff:.3g} (rtol 1e-3, "
          f"atol 2e-3), argmax equal ({card})", flush=True)


def phase_two_stage_cli(card):
    """``upp_torch.main`` pretrains a 48-cloud twin of
    ``cfgs/pretrain_synthetic.yaml`` (batch 24, epochs 0-1), then
    fine-tunes ``PointTransformer`` from its ``ckpt-last.pth`` (epochs 0-1)
    and tests the fine-tune's ``ckpt-best.pth`` (its ``ckpt-last.pth`` when
    no validation beat 0 %). The fine-tune's load must
    miss only the cls tokens and head and find unexpected only the decoder
    side."""
    import glob
    import yaml
    from upp_torch.main import main as upp_main
    from upp_torch.train import runner_cls
    pre = yaml.safe_load(open(PRETRAIN_CFG))
    for split in ("train", "val", "test"):
        pre["dataset"][split]["_base_"] = {"NAME": "Synthetic", "N_POINTS": N_POINTS,
                                           "NUM_CATEGORY": 6, "SIZE": CLI_CLOUDS}
        pre["dataset"][split]["others"].pop("SIZE", None)
    pre.update(total_bs=CLI_BS, max_epoch=1)
    ft = finetune_config()
    ft.update(total_bs=CLI_BS, max_epoch=1)
    os.makedirs(CLI_DIR, exist_ok=True)
    paths = {}
    for name, cfg in (("pretrain_cli", pre), ("finetune_cli_train", ft),
                      ("finetune_cli_test", ft)):
        paths[name] = os.path.join(CLI_DIR, f"{name}.yaml")
        with open(paths[name], "w") as f:
            yaml.safe_dump(cfg, f)
    t0 = time.time()
    upp_main(["--config", paths["pretrain_cli"], "--exp_name", "chip_smoke"])
    pre_s = time.time() - t0
    last = sorted(glob.glob("experiments/pretrain_cli/plain-network/*chip_smoke/*/"
                            "ckpt-last.pth"))[-1]
    log = open(os.path.join(os.path.dirname(last), "pretrain_cli.log")).read()
    epochs = re.findall(r"EPOCH: (\d+) EpochTime = ([\d.]+) \(s\) LossX1000 = ([\d.]+)", log)
    if len(epochs) != 2 or not all(0.0 < float(v) < 1e6 for _, _, v in epochs):
        raise AssertionError(f"pretrain CLI: epochs {epochs}, log tail {log[-2000:]}")

    reports = []
    load = runner_cls.load_weights
    runner_cls.load_weights = lambda *a, **kw: reports.append(load(*a, **kw)) or reports[-1]
    try:
        t0 = time.time()
        best = upp_main(["--finetune_model", "--config", paths["finetune_cli_train"],
                         "--ckpts", last, "--exp_name", "chip_smoke"])
        ft_s = time.time() - t0
    finally:
        runner_cls.load_weights = load
    ((missing, unexpected),) = reports
    heads = ({k.split(".")[0] for k in missing}, {k.split(".")[0] for k in unexpected})
    if heads != ({"cls_token", "cls_pos", "cls_head_finetune"},
                 {"MAE_decoder", "decoder_pos_embed", "increase_dim", "mask_token"}):
        raise AssertionError(f"fine-tune --ckpts: missing {missing}, unexpected {unexpected}")
    run = os.path.dirname(sorted(glob.glob("experiments/finetune_cli_train/ckpt-last/"
                                           "*chip_smoke/*/ckpt-last.pth"))[-1])
    ft_log = open(os.path.join(run, "finetune_cli_train.log")).read()
    ft_epochs = re.findall(r"EPOCH: (\d+) EpochTime = ([\d.]+)", ft_log)
    if len(ft_epochs) != 2 or "(100.00 %)" not in ft_log:
        raise AssertionError(f"fine-tune CLI: epochs {ft_epochs}, log tail {ft_log[-2000:]}")
    # ckpt-best is written only when a validation accuracy rises above 0,
    # which 4 steps of a 40-class head may not reach
    tested = "ckpt-best" if os.path.exists(os.path.join(run, "ckpt-best.pth")) else "ckpt-last"
    t0 = time.time()
    acc = upp_main(["--test", "--finetune_model", "--config", paths["finetune_cli_test"],
                    "--ckpts", os.path.join(run, f"{tested}.pth"), "--exp_name", "chip_smoke"])
    test_s = time.time() - t0
    test_log = sorted(glob.glob(f"experiments/finetune_cli_test/{tested}/*chip_smoke/*/"
                                "finetune_cli_test.log"))[-1]
    if "missing_keys" in open(test_log).read() or not 0.0 <= acc <= 100.0:
        raise AssertionError(f"fine-tune CLI test: acc {acc}")
    print(f"[two-stage cli] pretrain {CLI_CLOUDS} clouds, batch {CLI_BS}: epochs (epoch, s, "
          f"loss x1000) {epochs}, {pre_s:.1f} s; fine-tune --ckpts ckpt-last.pth: "
          f"{len(missing)} missing (cls tokens and head), {len(unexpected)} unexpected (decoder "
          f"side), epochs (epoch, s) {ft_epochs}, best acc {best.acc:.4f}, {ft_s:.1f} s; --test "
          f"--ckpts {tested}.pth: acc {acc:.4f}, {test_s:.1f} s ({card})", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    from upp_torch import resolve_device
    from upp_torch.ops import cuda_build
    from upp_torch.train.pipeline import corrupt_batch
    from upp_torch.train.runner_cls import init_model, make_eval_step
    from upp_torch.utils.config import ConfigDict, cfg_from_yaml_file

    device = resolve_device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[card] {kind}; nvidia-smi: {card}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)

    # 1. build
    t0 = time.time()
    usage = cuda_build.build(["fps", "knn", "chamfer"])
    print(f"[build] fps.cu + knn.cu + chamfer.cu built in {time.time() - t0:.1f} s "
          f"({card})", flush=True)
    for name, lines in usage.items():
        for kernel in lines.split("; "):
            print(f"[ptxas] {name}.cu {kernel}", flush=True)

    clouds_np, labels_np = synthetic_clouds(B_PRETRAIN)
    all_clouds = torch.from_numpy(clouds_np).to(device)
    clouds = all_clouds[:B]
    labels = torch.from_numpy(labels_np).to(device)[:B]
    seg = seg_batch(B_SEG, device)

    # 2. kernels vs plain, ties and edges, host cost; 3. kNN backward
    with torch.inference_mode():
        rows = phase_kernels(all_clouds, seg[0], card)
        phase_kernel_ties_and_edges(card)
        phase_host_cost(clouds, card)
        phase_chamfer_yardstick(clouds, card)
    backward_ms = phase_knn_backward(clouds, card)

    config = cfg_from_yaml_file(CFG)
    args = type("Args", (), {"seed": SEED, "normalize": False})()
    model = init_model(args, config, device)

    # 4. clean eval
    eval_step = make_eval_step(model, config, args)
    reset_counts()
    with Recorder() as rec:
        preds = eval_step(clouds)
        torch.cuda.synchronize()
    clean_counts = check_calls("clean eval", rec, CLEAN_CALLS)
    if preds.shape != (B,) or not ((preds >= 0) & (preds < config.model.cls_dim)).all():
        raise AssertionError(f"clean eval: bad predictions {preds}")
    clean_ms = cuda_ms(lambda: eval_step(clouds), reps=3, warmup=1)
    print(f"[clean eval] launches {clean_counts}; {clean_ms:.2f} ms/batch, "
          f"{B / clean_ms * 1e3:.1f} clouds/s (B={B}; {card})", flush=True)

    # 5. robust inference
    gen = torch.Generator(device=device).manual_seed(SEED)

    def robust_step(pts, bsz_gen):
        with torch.inference_mode():
            points = corrupt_batch(
                pts, npoints=NPOINTS, n_points_dataset=N_POINTS, noisy_train=True,
                incomplete_cropping=True, augmentation=None, generator=bsz_gen)
            return points, model(points, denoise=True, completion_prompt=True,
                                 point_num=NPOINTS)

    reset_counts()
    with Recorder() as rec:
        points, logits = robust_step(clouds, gen)
        torch.cuda.synchronize()
    robust_counts = check_calls("robust inference", rec, ROBUST_CALLS)
    if points.shape != (B, NPOINTS + 72, 3):
        raise AssertionError(f"corrupt_batch: shape {tuple(points.shape)}")
    if logits.shape != (B, config.model.cls_dim) or not torch.isfinite(logits).all():
        raise AssertionError("robust inference: logits not finite / wrong shape")
    torch.cuda.reset_peak_memory_stats()
    robust_ms = cuda_ms(lambda: robust_step(clouds, gen), reps=3, warmup=1)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[robust] launches of one step {robust_counts}; {robust_ms:.2f} ms/batch, "
          f"{B / robust_ms * 1e3:.1f} clouds/s, peak {peak_gib:.2f} GiB "
          f"(B={B}; {card})", flush=True)
    profile_steps(lambda: robust_step(clouds, gen), "robust", robust_ms, card)

    # 6. card vs CPU
    small = clouds[:B_CPU]
    points_c, logits_c = robust_step(small, torch.Generator(device=device).manual_seed(SEED + 1))
    cpu_model = init_model(args, config, torch.device("cpu"))
    with torch.inference_mode():
        logits_h = cpu_model(points_c.cpu(), denoise=True, completion_prompt=True,
                             point_num=NPOINTS)
    diff = (logits_c.cpu() - logits_h).abs().max().item()
    if not torch.allclose(logits_c.cpu(), logits_h, rtol=1e-3, atol=2e-3):
        raise AssertionError(f"card vs CPU: logits differ by {diff}")
    if not torch.equal(logits_c.argmax(-1).cpu(), logits_h.argmax(-1)):
        raise AssertionError("card vs CPU: argmax differs")
    print(f"[card vs cpu] B={B_CPU}: max |logit diff| {diff:.3g} "
          f"(rtol 1e-3, atol 2e-3), argmax equal", flush=True)

    # 7-8. pretask train and eval, 9. pretask card vs CPU
    pretask_config = cfg_from_yaml_file(PRETASK_CFG)
    pretask_counts = phase_pretask(clouds, pretask_config, card, device)
    phase_pretask_card_vs_cpu(clouds, pretask_config, card, device)
    del model

    # 10-11. cls train, 12. cls card vs CPU, 13. CLI
    cls_counts = phase_cls_train(clouds, labels, config, card, device, backward_ms)
    phase_cls_card_vs_cpu(clouds, labels, config, card, device)
    phase_cls_cli(card)

    # 14. seg PEFT train, 15. seg fine-tune train, 16. seg eval,
    # 17. seg card vs CPU, 18. seg CLI
    seg_cfg = ConfigDict.from_nested(seg_config(SEG_CFG))
    seg_counts, seg_eval = phase_seg_train("seg train PEFT", seg, seg_cfg, card, device,
                                           True, SEG_TRAIN_CALLS)
    phase_seg_eval(seg_eval, seg, card)
    del seg_eval
    phase_seg_train("seg train fine-tune", seg, ConfigDict.from_nested(seg_config(SEG_FT_CFG)),
                    card, device, False, SEG_FT_CALLS)
    phase_seg_card_vs_cpu(seg, seg_cfg, card, device)
    phase_seg_cli(card)

    # 19. pretrain train, 20. probe features, 21. pretrain card vs CPU
    pre_cfg = cfg_from_yaml_file(PRETRAIN_CFG)
    pre_model, pre_step = pretrain_setup(pre_cfg, device)
    pre_counts = phase_train("pretrain train", pre_step, pre_model, (all_clouds,), card,
                             PRETRAIN_CALLS + PRETRAIN_CHAMFER, B_PRETRAIN)
    phase_probe_features(pre_model, all_clouds, card, device)
    del pre_model, pre_step
    phase_pretrain_card_vs_cpu(all_clouds, pre_cfg, card, device)

    # 22. fine-tune cls train and eval, 23. fine-tune card vs CPU, 24. two-stage CLI
    ft_cfg = ConfigDict.from_nested(finetune_config())
    ft_counts = phase_finetune(clouds, labels, ft_cfg, card, device)
    phase_finetune_logits(clouds, ft_cfg, card, device)
    phase_cls_card_vs_cpu(clouds, labels, ft_cfg, card, device, stages=(("fine-tune", None),),
                          tag="finetune")
    phase_two_stage_cli(card)

    # the cls train step's forward makes the robust step's kernel calls
    kernels = [kernel_entry("fps", rows, ROBUST_CALLS, cls_counts["fps"], B, "cls train step"),
               kernel_entry("knn", rows, ROBUST_CALLS, cls_counts["knn"], B, "cls train step"),
               kernel_entry("chamfer", rows, PRETASK_TRAIN_CALLS, pretask_counts["chamfer"],
                            B_PRETASK, "pretask train step"),
               kernel_entry("fps", rows, SEG_TRAIN_CALLS, seg_counts["fps"], B_SEG,
                            "seg PEFT train step"),
               kernel_entry("knn", rows, SEG_TRAIN_CALLS, seg_counts["knn"], B_SEG,
                            "seg PEFT train step")]
    kernels += [kernel_entry(k, rows, PRETRAIN_CALLS, pre_counts[k], B_PRETRAIN, "pretrain")
                for k in ("fps", "knn")]
    kernels += [kernel_entry("chamfer", rows, PRETRAIN_CHAMFER, pre_counts["chamfer"],
                             B_REBUILD, "pretrain"),
                kernel_entry("fps", rows, FT_CALLS, ft_counts["fps"], B_FT, "finetune_cls"),
                kernel_entry("knn", rows, FT_CALLS, ft_counts["knn"], B_FT, "finetune_cls")]
    print("[kernels] ms/plain_ms/bound_ms summed over one step's calls of each entry's path: "
          f"fps and knn over one cls train step (B={B}, the robust step's calls), one seg "
          f"PEFT train step (B={B_SEG}), one pretrain train step (B={B_PRETRAIN}) and one "
          f"fine-tune cls train step (B={B_FT}); chamfer over one pretask train step "
          f"(B={B_PRETASK}) and one pretrain train step (its {B_REBUILD} clouds of 32); "
          f"launches from those steps' runs; {card}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
