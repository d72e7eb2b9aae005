#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (``upp_torch``) once on a CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build the CUDA kernels from ``upp_torch/csrc`` (one nvcc per source,
     in parallel) and print the build time and each kernel's registers and
     spills (``ptxas -v``);
  2. hold each kernel against its plain PyTorch version on the card at
     every shape the paths give it (classification shapes at batch 120,
     pretask shapes at batch 64, the others below): FPS indices equal, kNN indices equal and
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
     at full width on 120 synthetic 8192-point clouds, seeded weights; the
     replayed step's predictions equal the eager first call's;
  5. robust inference: ``corrupt_batch`` (viewpoint crop 8192→1024, +48
     lidar, +24 shell points) then the 3-pass ``PointMAEUnify`` at full
     width, batch 120: finite logits, launch counts of one step, time; then
     a step of replayed CUDA graphs: its three replays, its ``launches.*``
     equal to the eager step's, and the logits of the first step's input
     bit-equal to the eager ones; then ``torch.profiler`` over 3 steps:
     device-busy ms per step, idle share, the FPS, kNN and Chamfer kernels'
     device time;
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
     step (its forward is the robust step's), no kNN backward; then a
     fourth step, a replayed CUDA graph (the first ran eager, the second
     captured): one replay, the eager step's ``launches.*``, no host sync,
     finite, the same tensors moved; ms per step and clouds/s (mean of 10
     steps after a warm-up), peak memory, and a ``torch.profiler`` profile
     over 3 steps;
 11. cls train, joint stage: ``JOINT_PEFT_LIST`` switched in on the live
     optimizer, a new key whose first step runs eager: the kNN backward
     runs (its calls by shape, each timed alone in phase 3), the head is
     bit-unchanged by a step, the rectify prompter moves; after the key's
     capture a replayed step checked as in phase 10; ms per step, peak
     memory and a profile of the replayed steps; then eager steps (the
     graph forced off) profiled, in which each ``KnnKernel.backward`` call
     is a ``knn_backward`` range: its calls and the device time of what it
     launched, per step;
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
     loss, trainable tensors changed and others bit-unchanged, a replayed
     step checked as in phase 10, ms per step (mean of 10 after a warm-up),
     peak memory, a profile over 3 steps;
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
     parameter trainable; as phase 19 with a replayed step checked as in
     phase 10, then its eval step at batch 40;
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
     unexpected only the decoder side;
 25. dist world1: phase 13's CLI command with ``--deterministic`` under
     ``python -m torch.distributed.run --standalone --nproc_per_node 1 -m
     upp_torch.main --launcher pytorch`` (NCCL, a world of one) and without
     the launcher, side by side: their ``ckpt-last.pth`` equal bit for bit
     (without ``--deterministic`` the backwards' atomic scatter-adds make
     runs differ in their low bits, and the noisy passes' near ties can turn
     that into other sampled points); then the cls PEFT train step at batch
     120 through the launched code path (no collective runs), timed beside
     phase 10's time;
 26. dist two ranks, one card: two processes share the card over gloo
     (passed explicitly: NCCL takes one rank a device), each with half of
     the global batch: the cls PEFT step at batch 120 (60/60) without the
     noisy passes and with them, the joint step after the switch, the
     pretrain step at batch 128 (64/64), each against this process's
     one-process step at ``DIST_TOL`` (the continuous steps tensor by
     tensor: loss, gradients, updated parameters, running statistics; the
     noisy ones, whose near ties reorder, by loss and gradient norm at phase
     12's bounds) and the ranks equal bit for bit; the collectives of each
     step by kind and bytes, and ms per step (two processes time-sharing
     one card: not a scaling number);
 27. dist nccl two cards: the same over NCCL, one card a rank, when there
     are two cards; else it prints that it did not run and why;
 28. PoinTr at the width of its published PCN configuration (trans_dim
     384, 6 + 8 blocks, 224 queries, 14336 predicted points) at batch 48,
     on 2048-point partial views cropped from 16384-point synthetic clouds:
     the eval forward (coarse (48, 448, 3), rebuild (48, 16384, 3), finite,
     its launch counts, ms), then 3 train steps (forward in train mode,
     ``get_loss``, backward, AdamW over every parameter): the launch counts
     of one (FPS 2048→512→128 and 2048→224, kNN k=16 over 2048 and 512
     points and the k=8 token graphs, Chamfer 448 x 16384 and 16384 x
     16384), finite loss terms, every parameter changed, ms per step (mean
     of 10 after a warm-up), clouds/s, peak memory and a profile over 3
     steps (device busy, idle share);
 29. AdaPoinTr at the width of its PCN configuration (embed 384, 6 + 8
     blocks, 512 queries, 16384 points, the fc decoder) at batch 48: as
     phase 28, with the train outputs (pred_coarse, denoised_coarse,
     denoised_fine, pred_fine) and the loss's kNN k=32 of 64 denoise centres
     over 16384 points; the query ranking's parameters get no gradient and
     stay bit-unchanged; then the fold decoder (64 points a query) at full
     width, batch 16: one train step, whose loss asks the kNN kernel for
     k=64 of the 64 denoise centres over the 16384 ground-truth points (its
     two-keys-a-lane instance), its launch counts, finite terms; and its
     ``get_loss`` on the card against the CPU on the same outputs (rtol
     1e-4);
 30. AdaPoinTr at full width with every local block style (attn-graph,
     attn-rw_deform, attn-deform, attn-deform_graph, graph; the encoder by
     concat, the decoder's self-attention one by one with the denoise
     split, its cross-attention by concat) at batch 16: one train step,
     finite, a nonzero gradient in each of the 9 deform blocks' offset
     MLPs;
 31. completion card vs CPU at batch 4, both models from the same weights,
     inputs and denoise draw: eval outputs within rtol 1e-3 / atol 2e-3
     (AdaPoinTr's queries aligned first: its ranking's stable sort may order
     near-equal ranks differently), loss terms within rtol 1e-3 / atol
     2e-3, the gradients' global norm within rtol 1e-2;
 32. EMD (plain tensor code): card vs CPU at (4, 1024, 1024), the costs
     within rtol 1e-4, the gradients within 1e-2 of the largest, and
     ``Metrics.get(require_emd=True)``; the plain version's forward and
     forward + backward time at (1, 16384, 16384) and (32, 2048, 2048);
 33. bf16 cls PEFT step: ``cfgs/unify_synthetic_cls.yaml`` with ``if_half:
     True`` set in memory, batch 120, as phase 10 (launch counts, changed
     and bit-unchanged tensors, a replayed step, ms per step, peak,
     profile); then the
     float32 and bf16 steps timed in turns in this process (f32, bf16,
     bf16, f32), and both profiled: the GEMM rows by kind (float32 SIMT:
     ``sgemm``/``ffma``/``simt``; tensor core: ``bf16``/``nvjet``/``gmma``/
     ``tensorop``); the bf16 step must run tensor-core GEMMs and spend less
     device time in SIMT GEMMs than the float32 one;
 34. bf16 pretask train step (``cfgs/pretask_synthetic.yaml``, ``if_half``),
     batch 64: as phase 33;
 35. bf16 pretrain step (``cfgs/pretrain_synthetic.yaml``, ``if_half``),
     batch 128: as phase 33;
 36. bf16 card vs CPU, both in bf16 from the same weights and draws: the
     cls downstream-pass logits at batch 8 within 2e-2 of the largest
     logit, the cls PEFT step without the noisy passes (batch 8), the
     pretask step (batch 4) and the pretrain step (batch 4): loss terms and
     the gradients' global norm within rtol 2e-2 (the bound
     ``tests/test_torch_port_half.py`` sets); the noisy cls PEFT step's
     gaps printed, not held (its rectify sort and FPS re-sampling reorder
     near ties under bf16 rounding, as the CPU tests hold the passes one
     by one for);
36b. the noisy bf16 cls PEFT step's passes one by one, card vs CPU (both
     bf16, train mode, dropout and drop-path off, batch 8, phase 12's
     draws): rectify on the corrupted clouds, completion on the CPU's
     rectified cloud, downstream on the CPU's re-sampled cloud; each pass's
     outputs (rectification vectors; centres and rebuild; logits) within
     2e-2 of their largest, and the counts of rectify sort ranks and FPS
     re-sampling picks that differ between card and CPU printed;
 37. legacy pretask train: ``Point_MAE_pretask`` at the width of
     ``cfgs/pretask.yaml`` (its synthetic twin with the model's NAME set in
     memory), batch 64: as phase 7 (launch counts of one step, finite
     terms, trainable tensors changed, frozen ones bit-unchanged, ms, peak)
     and a profile;
 38. legacy card vs CPU at batch 4: as phase 9, at its bounds;
 39. legacy CLI: ``upp_torch.main`` trains the legacy model for one epoch
     on a 48-cloud synthetic split (batch 24), then ``--test --ckpts <its
     ckpt-last.pth>``: the TEST RESULTS table, nothing missing;
 40. ``AdapterSuper``/``AdapterSuperF`` at width 384 on the card against
     the CPU (rtol 1e-4), with and without ``sample_embed_dim``; and
     ``runner_vis.test_net`` with 2 items on the card and on the CPU: the
     saved clouds (FPS outputs) equal;
 41. the patch denoiser's kernels against their plain versions (batch 1):
     FPS variant 6 (N > 16384, a 16-block cluster a cloud) index-identical
     at 16385 → 512, 50000 → 150, 150000 → 50000 and 30000 → 10000 (these
     two on the patch layout ``patch_based_denoise`` gives them, the first
     also on a noisy sphere cloud in random order), 10000 → 30, masked
     20000 → 256, its limit 262144 → 256 and a 60000-point tie cloud →
     6000, each with its instance (points a thread, warps a block, x y z
     in registers or shared memory), µs a round and the share of
     warp-rounds that skipped their points (``fps_cuda.cluster_skip_stats``,
     whose indices must equal ``fps_idx``'s); the large-k kNN (``csrc/knn_select.cu``) index-identical
     with bit-equal distances and ``knn_points``' gather equal at (1, 150,
     50000, k=1000), (1, 30, 10000, 1000), (4, 64, 16385, 65), (2, 8, 2048,
     1024), (1, 4, 100000, 500) and its limits (1, 4, 2^20, 1024), on noisy
     sphere clouds, tie clouds and coarse tie clouds (the 27-point grid),
     each with the blocks a query and threads it launched with and, from
     a counting launch, the boundary bin's keys after pass 1 against the
     kernel's candidates and the queries that took the overflow path (every
     query of a coarse tie cloud at the denoise shapes, 100000 and 2^20
     must); kernel ms by CUDA events and µs by ``torch.profiler``, plain
     and ``torch.cdist`` + ``topk`` ms; every FPS variant run over phases 2
     and 41;
 42. ``utils/denoise.patch_based_denoise`` with an affine stand-in for the
     denoiser network at 50000 and 10000 points: launch counts (FPS 2,
     large-k kNN 1), ms a cloud and of each step, the 10000-point result
     bit-equal to the port's CPU run;
 43. ``utils/profiling.profile_train_step`` on the cls config at batch 120
     with the deep rows (the table printed), and a ``maybe_trace`` of one
     annotated PEFT step holding the ``annotate`` ranges;
 44. ``remat_blocks``: the cls PEFT step at batch 120, float32 and bf16,
     with and without remat, from the same weights and draws (deterministic
     algorithms, warn only): gradients, updated parameters and BatchNorm
     buffers bit-equal; ms per step and peak memory;
 45. ``save_checkpoint`` of the flagship classifier with ``block=True`` and
     ``block=False`` (the training thread's wait), then
     ``wait_for_pending_saves``; the files equal;
 46. fsdp two ranks, one card: ``Point_MAE`` at the width of
     ``cfgs/pretrain.yaml`` (12 + 4 blocks of 384), global batch 128 (64 a
     rank), two gloo processes sharing the card, replicated and ZeRO-3
     (``upp_torch.parallel.fsdp``) from the same weights: two sharded steps
     held to the replicated ones at ``DIST_TOL`` (loss, gradients gathered
     whole, updated parameters within 2.004 lr a step, running
     statistics), the ranks bit-equal; ms per step, each rank's parameter
     and AdamW moment bytes and peak memory, sharded against replicated;
     then a blocking checkpoint of the sharded run (gathered on every
     rank), a resume into a fresh sharded model whose next step's loss
     equals the continuing run's (rtol 1e-4), and the ``.pth`` loaded with
     ``strict=True`` into a one-process model and optimizer whose own state
     dicts equal it tensor for tensor;
 47. tp two ranks, one card: the cls steps of phase 26 at the full width of
     ``cfgs/unify_synthetic_cls.yaml`` and batch 120 under dp1 x tp2
     (``upp_torch.parallel.tensor``; each rank on all 120 clouds, 3 of the 6
     heads and half of each MLP), gradients and parameters gathered whole,
     held to phase 26's one-process steps at its bounds (``cls clean``
     tensor by tensor, ``cls peft`` and ``cls joint`` by loss and gradient
     norm), the ranks bit-equal;
 48. ``upp_torch.dryrun.dryrun_multichip(2)`` on the card (gloo ranks
     sharing it: its three ``OK`` lines, each loss within 1e-3 of the data
     parallel one) and ``upp_torch.dryrun.entry()``: the full-width noisy
     forward at batch 8, finite logits (8, 40), ms;
 49. two node groups: phase 13's CLI command with ``--deterministic`` under
     ``torch.distributed.run --nnodes 2 --node_rank {0,1} --nproc_per_node
     1`` (rank 1's local rank is 0) and under ``--standalone
     --nproc_per_node 2``, both over gloo on the card, side by side: their
     ``ckpt-last.pth`` equal bit for bit. With four cards or more, ZeRO-3
     over four NCCL ranks (as phase 46) and dp2 x tp2 over NCCL (as phase
     47) run too; else a line says why not.
Phase 2 times ``torch.topk(torch.cdist(q, p).square(), k, largest=False)``
beside each kNN path shape (the ``kernels`` line's ``library_ms`` of knn).
Phase 2 also holds FPS and kNN at every seg shape at batch 30, on the seg
clouds and on tie-heavy grid clouds of 2048 points; FPS, kNN and Chamfer at
the pretrain shapes (batch 128; Chamfer over 4864 clouds of 32 points) and
the fine-tune shapes (batch 40), and every shape of the PoinTr and AdaPoinTr
steps at batch 48 (kNN k=32 over 16384 points, Chamfer 16384 x 16384), on
synthetic and tie-heavy grid clouds; kNN at k = 33, 42, 48 and 64 (the
kernel's second instance) at N = 64, 1024, 2048 and 16384 (64 queries,
batch 16), with the fold decoder's shapes (kNN k=64 of 64 over 16384,
Chamfer 4096 x 4096 and 32768 x 16384), on synthetic and tie clouds; and
every shape of the legacy pretask step at batch 64 (FPS 1076→64, 1024→64,
64→32; kNN k=32 over 1076 and 1024, k=8 of 32 over 64, k=6 of 32 over 32,
k=4 of 52 over 1024). Launch counts are reset right before each path run
(4, 5, 7, 8, 10, 11, 14, 15, 16, 19, 20, 22, 28, 29, 30, 33-35, 37) and
read right after; the kernel-vs-plain comparisons do not count. Before the
last line it prints the ``kernels`` JSON line (FPS and kNN launches of one
cls train step, of one seg PEFT train step, of one pretrain train step and
of one fine-tune cls train step; Chamfer's of one pretask and of one
pretrain train step; all three kernels' of one PoinTr and of one AdaPoinTr
train step, of one legacy pretask train step and of the bf16 cls, pretask
and pretrain train steps; each entry names its ``path``) and the card's
name and power limit; the ``kernels`` line also has fps and knn_select
entries for one ``patch_based_denoise`` of 50000 points (phase 42's
launches, phase 41's times of the path's layouts; knn's and knn_select's
``library_ms`` is ``torch.cdist`` + ``topk``; knn_select's ``device_ms`` is
phase 41's profiler time); fps, knn and chamfer entries for rank 0 of
phase 46's ZeRO-3 pretrain step (64 clouds a rank; its Chamfer over 2432
clouds of 32) and fps and knn for rank 0 of phase 47's dp1 x tp2 cls PEFT
step (120 clouds), launches counted in those rank processes; the last line
is the ``{"ok": true,
"device": ...}`` JSON object.
"""

from __future__ import annotations

import contextlib
import copy
import gc
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
B_COMP = 48             # total_bs of the PCN configs (PoinTr repository, cfgs/PCN_models)
B_COMP_CPU = 4          # completion card-vs-CPU comparison batch
B_STYLES = 16           # AdaPoinTr with every local block style, and its fold decoder
B_WIDE = 16             # kNN at 32 < k <= 64
N_GT = 16384            # PCN's complete clouds
N_PARTIAL = 2048        # PCN's partial clouds
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
# the completion family at the PCN shapes (2048-point partials, 16384-point
# ground truth); every kNN here is idx-only
GROUPER_CALLS = Counter({                     # DGCNNGrouper: edge-convs k=16, FPS 2048→512→128
    ("knn", 2048, 2048, 16, False): 1, ("fps", 2048, 512, False): 1,
    ("knn", 512, 2048, 16, False): 1, ("knn", 512, 512, 16, False): 1,
    ("fps", 512, 128, False): 1, ("knn", 128, 512, 16, False): 1})
POINTR_EVAL_CALLS = GROUPER_CALLS + Counter({
    ("knn", 128, 128, 8, False): 1,           # encoder0's token graph
    ("knn", 224, 224, 8, False): 1, ("knn", 224, 128, 8, False): 1,   # decoder0's
    ("fps", 2048, 224, False): 1})            # the input's half of the coarse output
POINTR_TRAIN_CALLS = POINTR_EVAL_CALLS + Counter({
    ("chamfer", 448, 16384, False): 1, ("chamfer", 16384, 16384, False): 1})
ADA_COMMON_CALLS = GROUPER_CALLS + Counter({
    ("knn", 128, 128, 10, False): 1,          # encoder0's graph attention
    ("fps", 2048, 256, False): 1})            # half the 768 candidate queries
ADA_EVAL_CALLS = ADA_COMMON_CALLS + Counter({
    ("knn", 512, 512, 10, False): 1, ("knn", 512, 128, 10, False): 1})   # decoder0's graphs
ADA_TRAIN_CALLS = ADA_COMMON_CALLS + Counter({
    ("fps", 2048, 64, False): 1,              # the denoise queries
    ("knn", 576, 128, 10, False): 1,          # decoder0's cross graph (its self graph: the
                                              # denoise split's masked top-k, plain torch)
    ("knn", 64, 16384, 32, False): 1,         # the loss's denoise targets
    ("chamfer", 2048, 2048, False): 1, ("chamfer", 512, 16384, False): 1,
    ("chamfer", 16384, 16384, False): 1})
ADA_FOLD_CALLS = ADA_COMMON_CALLS + Counter({
    ("fps", 2048, 64, False): 1, ("knn", 576, 128, 10, False): 1,
    ("knn", 64, 16384, 64, False): 1,         # the loss's denoise targets, 64 a centre
    ("chamfer", 4096, 4096, False): 1, ("chamfer", 512, 16384, False): 1,
    ("chamfer", 32768, 16384, False): 1})
# kNN past 32 neighbours (the kernel's two-keys-a-lane instance): 64 queries
# over N points, with the gather, and the fold decoder's loss shapes
KNN_WIDE_CALLS = tuple(("knn", 64, n, k, True) for n in (64, 1024, 2048, 16384)
                       for k in (33, 42, 48, 64)) + (
    ("knn", 64, 16384, 64, False), ("chamfer", 4096, 4096, False),
    ("chamfer", 32768, 16384, False))
# Point_MAE_pretask (the legacy pretask model) at the width of cfgs/pretask.yaml
LEGACY_TRAIN_CALLS = Counter({
    ("fps", 8192, 1024, True): 2,             # viewpoint crop, both halves
    # the whole 1076-point cloud's tokens, FPS of the 64 centres to 32, and
    # the propagation of every token onto those (k=8); again after the drop
    ("fps", 1076, 64, False): 1, ("knn", 64, 1076, 32, True): 1,
    ("fps", 1024, 64, False): 1, ("knn", 64, 1024, 32, True): 1,
    ("fps", 64, 32, False): 2, ("knn", 32, 64, 8, False): 2,
    # mask_prompter
    ("fps", 32, 32, False): 1, ("knn", 32, 32, 16, True): 1,
    ("knn", 32, 32, 16, False): 1, ("knn", 1076, 32, 16, False): 1,
    ("knn", 52, 1024, 4, True): 1,            # noise supervision (K=4)
    ("knn", 32, 32, 6, False): 1,             # mask-token propagate
    ("chamfer", 32, 1024, False): 1, ("chamfer", 1024, 1024, False): 1,
    ("chamfer", 2048, 8192, False): 1,
})
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
    # k > 64 or N > 16384: XLA top_k in JAX, where the Pallas kNN kernel
    # refuses k > 42 (upp_tpu/ops/knn_pallas.py:250-261)
    "knn_select": ("upp_torch/csrc/knn_select.cu", "upp_tpu/ops/knn_pallas.py:48"),
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
        ("knn_select", knn_cuda, "knn_select",
         lambda query, points, k: ("knn_select", query.shape[1], points.shape[1], k)),
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
    The launches the run reports are the recorder's ``launches.*``
    counters (``upp_torch.utils.profiling``), which the wrappers keep
    whatever stands in for them."""

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

            setattr(mod, attr, rec)
            self.orig.append(f0)
        return self

    def __exit__(self, *exc):
        for (_, mod, attr, _), f0 in zip(self.wrappers, self.orig):
            setattr(mod, attr, f0)


def reset_counts():
    from upp_torch.utils import profiling
    profiling.reset()


def read_counts():
    from upp_torch.utils import profiling
    counts = profiling.counts()
    return {name: counts.get("launches." + name, 0) for name, _, _, _ in _wrappers()}


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
    Chamfer over 4864 clouds; and a rank's half of both, phase 46) and
    fine-tune cls (batch 40) paths."""
    return ([(c, B_PRETRAIN) for c in sorted(PRETRAIN_CALLS)]
            + [(c, B_REBUILD) for c in PRETRAIN_CHAMFER]
            + [(c, B_PRETRAIN // N_RANKS) for c in sorted(PRETRAIN_CALLS)]
            + [(c, B_REBUILD // N_RANKS) for c in PRETRAIN_CHAMFER]
            + [(c, B_FT) for c in sorted(set(FT_CALLS) | set(FT_EVAL_CALLS))])


def completion_shapes():
    """Every kernel shape of the PoinTr and AdaPoinTr train and eval steps."""
    return sorted(set(POINTR_TRAIN_CALLS) | set(ADA_EVAL_CALLS) | set(ADA_TRAIN_CALLS))


def kernel_shapes():
    """(call, batch) of every kernel shape the paths run: the classification
    shapes at batch 120, the pretask and legacy pretask ones at batch 64, the
    segmentation ones at batch 30, the pretrain and fine-tune ones, the
    completion ones at batch 48, kNN past k=32 and the fold decoder's at
    batch 16."""
    cls = set(CLEAN_CALLS) | set(ROBUST_CALLS)
    pretask = set(PRETASK_TRAIN_CALLS) | set(PRETASK_EVAL_CALLS) | set(LEGACY_TRAIN_CALLS)
    return ([(c, B) for c in sorted(cls)] + [(c, B_PRETASK) for c in sorted(pretask)]
            + [(c, B_SEG) for c in seg_shapes()] + baseline_shapes()
            + [(c, B_COMP) for c in completion_shapes()]
            + [(c, B_WIDE) for c in KNN_WIDE_CALLS])


def fps_masks(xyz, gen):
    """(valid, start) of a masked FPS call: the viewpoint crop's kept points
    and the nearest of them to the viewpoint, as ``corrupt_batch`` gives."""
    from upp_torch.ops.corrupt import _crop_masks
    d, crop = _crop_masks(xyz, xyz.shape[1] // 4, None, gen)
    valid = ~crop
    return valid, torch.where(valid, d, torch.inf).argmin(1)


def _check_fps(call, clouds, gen, reps=10, plain_reps=2, masks=None):
    """Kernel vs plain at ``call`` on ``clouds``; a masked call takes
    ``masks`` (valid, start) or draws them from ``gen``. The plain run that
    checks the kernel is the plain version's warm-up, or with ``plain_reps``
    1 its timed run (the denoise shapes' plain loops take seconds)."""
    from upp_torch.ops import fps_cuda
    from upp_torch.ops.fps import fps_plain_idx
    from upp_torch.ops.geometry import index_points
    _, n, s, masked = call
    xyz = clouds[:, :n].contiguous()
    valid = start = None
    if masked:
        valid, start = masks or fps_masks(xyz, gen)
    k_idx = fps_cuda.fps_idx(xyz, s, valid, start)
    out = []
    plain_ms = cuda_ms(lambda: out.append(fps_plain_idx(xyz, s, valid, start)), reps=1, warmup=0)
    p_idx = out[0]
    if not torch.equal(k_idx.long(), p_idx):
        bad = (k_idx.long() != p_idx).sum().item()
        raise AssertionError(f"FPS {call}: {bad} indices differ from the plain version")
    err = (index_points(xyz, k_idx.long()) - index_points(xyz, p_idx)).abs().max().item()
    FPS_N_RUN.add(n)
    ms = cuda_ms(lambda: fps_cuda.fps_idx(xyz, s, valid, start), reps=reps)
    if plain_reps > 1:
        plain_ms = cuda_ms(lambda: fps_plain_idx(xyz, s, valid, start), reps=plain_reps,
                           warmup=0)
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
FPS_N_RUN = set()              # N of every FPS check (phases 2 and 41)


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


def coarse_tie_clouds(bsz, n, gen):
    """[bsz, n, 3] on the card: points drawn from the 27 points of the grid
    {-1, 0, 1}^3, so thousands share each squared distance from a query at
    N >= 10000 (csrc/knn_select.cu's overflow path)."""
    return torch.randint(-1, 2, (bsz, n, 3), generator=gen, device=gen.device).float()


def kernel_device_us(fn, kernel, reps=20, tries=3):
    """Device µs a launch of the kernel named ``kernel``: the median of the
    launches' durations that ``torch.profiler`` recorded over ``reps``
    calls (it may drop some, or all of a window: then the window is
    profiled again, up to ``tries`` times); raises if it recorded none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        spans = sorted(e.time_range.elapsed_us() for e in prof.events()
                       if e.device_type == DeviceType.CUDA and kernel in e.name)
        if spans:
            return float(np.median(spans))
    raise AssertionError(f"the profiler recorded no launch of {kernel} in {tries} windows")


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


def phase_kernels(clouds, seg_clouds, comp_clouds, card):
    """Kernel vs plain on the card at every path shape (the seg shapes on
    the seg clouds, the pretrain Chamfer on ``rebuild_clouds``, the
    completion shapes on the 16384-point ground-truth clouds). Returns
    per-shape rows."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    # the wide kNN calls read the 16384-point clouds, the fold's Chamfer
    # 32768 points: each cloud, then itself at half the scale
    wide = torch.cat([comp_clouds[:B_WIDE], 0.5 * comp_clouds[:B_WIDE]], 1)
    rebuild = rebuild_clouds(clouds)
    sources = {B_SEG: seg_clouds, B_REBUILD: rebuild, B_REBUILD // N_RANKS: rebuild,
               B_COMP: comp_clouds, B_WIDE: wide}
    rows = []
    for call, bsz in kernel_shapes():
        src = sources.get(bsz, clouds)[:bsz].contiguous()
        err, ms, plain_ms = _check(call, src, gen)
        nbytes, ops = bound_parts(call, bsz)
        rows.append({"call": list(call), "batch": bsz, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "bytes": nbytes, "ops": ops})
        lib = ""
        if call[0] == "knn":
            rows[-1]["library_ms"] = knn_library_ms(call, src)
            lib = f", cdist + topk {rows[-1]['library_ms']:.4f} ms"
        print(f"[kernel] {call}: max_abs_err {err:.3g}, kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms{lib}, bound {bound_ms(nbytes, ops):.4f} ms "
              f"(B={bsz}; {card})", flush=True)
    return rows


def knn_library_ms(call, clouds):
    """ms of ``torch.topk(torch.cdist(q, p).square(), k, largest=False)`` at
    a kNN call's shape, on the inputs ``_check_knn`` gives the kernel: one
    PyTorch call computing the kNN (the yardstick of the ``kernels`` line's
    ``library_ms``; the port never calls it)."""
    _, s, n, k, _ = call
    points = clouds[:, :n].contiguous()
    query = clouds[:, :s].contiguous()
    return cuda_ms(lambda: torch.topk(torch.cdist(query, points).square(), k, largest=False),
                   reps=10)


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
    cases += [("completion ties", call, tie_clouds(B_COMP, N_GT, gen))
              for call in completion_shapes()]
    cases += [("wide ties", call, tie_clouds(B_WIDE, max(call[1:3]), gen))
              for call in KNN_WIDE_CALLS]
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
    # variant 6 (N > 16384) runs in phase 41, which checks all seven
    if set(variants.values()) != set(range(fps_cuda.num_variants() - 1)):
        raise AssertionError(f"FPS variants run {set(variants.values())}, of "
                             f"{fps_cuda.num_variants() - 1} below 16384 points")
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
# GEMM kernels by kind, from their names: float32 on the SIMT cores, or on
# the tensor cores (cuBLAS's Hopper "nvjet" kernels, CUTLASS/xmma bf16 ones)
SIMT_GEMM = ("sgemm", "ffma", "simt")
TC_GEMM = ("bf16", "nvjet", "gmma", "tensorop", "16816", "hmma")
GEMM = ("gemm", "nvjet", "xmma", "cutlass")


def gemm_kind(key):
    """"simt", "tensor core" or None (not a GEMM) for a kernel's name."""
    k = key.lower()
    if not any(g in k for g in GEMM):
        return None
    if any(g in k for g in SIMT_GEMM):
        return "simt"
    return "tensor core" if any(g in k for g in TC_GEMM) else "other"


def profile_steps(step, name, step_ms, card, bsz=B, steps=3, rows=10, ranges=()):
    """``torch.profiler`` over ``steps`` steps: the device's busy time per
    step (the self device time of its own events: kernels, copies, memsets),
    the wall time per step, the idle share against both the profiled and the
    unprofiled (``step_ms``) step, the FPS, kNN and Chamfer kernels' share,
    the GEMMs' device time by kind (``gemm_kind``) and the largest GEMM rows,
    and the largest rows; for each ``record_function`` name in ``ranges``,
    its calls per step and the device time of what it launched. Returns
    {"busy": device ms per step, "gemm": {kind: ms per step}, "spans":
    {name: (calls, device ms) per step} of ``ranges``}, empty when the
    profiler saw no device time."""
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
    gemm = Counter()
    for e in events:
        kind = gemm_kind(e.key)
        if kind:
            gemm[kind] += dev_us(e) / 1e3 / steps
    print(f"[{name} profile] GEMMs by kind, ms/step: "
          + ", ".join(f"{k} {v:.3f}" for k, v in sorted(gemm.items())), flush=True)
    for e in [e for e in events if gemm_kind(e.key)][:5]:
        print(f"[{name} profile]   GEMM {gemm_kind(e.key):11s} {dev_us(e) / 1e3 / steps:8.3f} "
              f"ms/step  {e.key[:90]}", flush=True)
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
    return {"busy": busy, "gemm": gemm, "spans": spans}


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
    """The ``kernels`` JSON entry of one kernel on one path: ms, plain,
    library (where every call has one) and bound summed over one step's
    calls (``table``, at batch ``bsz``) from the per-shape rows."""
    src, replaces = KERNEL_SOURCES[name]
    mine = [(r, table[tuple(r["call"])]) for r in rows
            if r["call"][0] == name and r["batch"] == bsz and tuple(r["call"]) in table]
    t_bytes = sum(r["bytes"] * c for r, c in mine) / HBM_BYTES_PER_S * 1e3
    t_ops = sum(r["ops"] * c for r, c in mine) / F32_FLOP_PER_S * 1e3
    lib = [r.get("library_ms") for r, _ in mine]
    return {"name": name, "path": path, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows if r["call"][0] == name),
            "ms": sum(r["ms"] * c for r, c in mine),
            **({"device_ms": sum(r["device_us"] * c for r, c in mine) / 1e3}
               if mine and all("device_us" in r for r, _ in mine) else {}),
            "plain_ms": sum(r["plain_ms"] * c for r, c in mine),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": (None if None in lib
                           else sum(x * c for x, (_, c) in zip(lib, mine)))}


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


def phase_pretask_card_vs_cpu(clouds, config, card, device, tag="pretask", rtol=1e-3,
                              atol=2e-3, grad_rtol=1e-2):
    """One train step at batch 4 on the card and on the CPU from the same
    weights and draws (drawn on the CPU), dropout and drop-path off: the
    loss terms within ``rtol``/``atol``, the trainable gradients' global
    norm within ``grad_rtol``."""
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
    print(f"[{tag} card vs cpu] recall card {card_t['recall']:.4f}, cpu {cpu_t['recall']:.4f} "
          "(a flipped near-tie in the hard drop shows here)", flush=True)
    for k in ("cropping_coarse", "cropping_dense", "dense", "noise_loss"):
        if not np.isclose(card_t[k], cpu_t[k], rtol=rtol, atol=atol):
            raise AssertionError(f"{tag} card vs CPU: {k} {card_t[k]} vs {cpu_t[k]}")
    if not np.isclose(card_g, cpu_g, rtol=grad_rtol, atol=0.0):
        raise AssertionError(f"{tag} card vs CPU: grad norm {card_g} vs {cpu_g}")
    diff = max(abs(card_t[k] - cpu_t[k]) / max(abs(cpu_t[k]), 1e-12)
               for k in ("cropping_coarse", "cropping_dense", "dense", "noise_loss"))
    print(f"[{tag} card vs cpu] B={bsz}: loss terms within rel {diff:.3g} (rtol {rtol:g}, "
          f"atol {atol:g}); trainable grad norm card {card_g:.6g}, cpu {cpu_g:.6g} "
          f"(rtol {grad_rtol:g}) ({card})", flush=True)


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
    check_replayed_step("cls train (PEFT)", train_step, model, (pts, lab), counts)
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
    train_step(pts, lab)                        # the joint key's capture
    check_replayed_step("cls train (joint)", train_step, model, (pts, lab), joint_counts)
    joint_ms = cuda_ms(lambda: train_step(pts, lab), reps=10, warmup=1)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[cls train] joint: launches of one step {joint_counts}; loss {vals['loss']:.4f}; "
          f"kNN backward calls {dict(bwd.calls)}, {bwd_ms:.3f} ms a step estimated from "
          f"phase 3's calls timed alone; {n_moved} tensors changed, the head and {n_fixed} "
          f"others bit-unchanged; {joint_ms:.2f} ms/step, {B / joint_ms * 1e3:.1f} clouds/s, "
          f"peak {peak_gib:.2f} GiB (B={B}; {card})", flush=True)
    profile_steps(lambda: train_step(pts, lab), "cls train joint", joint_ms, card)
    # a replayed step has no kNN backward range: its device time is read
    # from eager steps
    with KnnBackwardRecorder(), eager_steps():
        eager_ms = cuda_ms(lambda: train_step(pts, lab), reps=3, warmup=1)
        prof = profile_steps(lambda: train_step(pts, lab), "cls train joint eager", eager_ms,
                             card, ranges=("knn_backward",))
    seen = prof["spans"]["knn_backward"][0] if prof else None
    if prof and seen != sum(bwd.calls.values()):
        print(f"[cls train joint profile] the profile saw {seen:g} kNN "
              f"backward calls a step of the step's {sum(bwd.calls.values())}: its device "
              "time not measured", flush=True)
    return counts, step_ms


def cpu_draws(bsz):
    """Every random draw of a cls train step at batch ``bsz``, made on the
    CPU from a seed (card and CPU then see the same corruption)."""
    from upp_torch.train.pipeline import CorruptDraws, point_all_for
    gen = torch.Generator().manual_seed(SEED + 5)
    v = torch.randn((bsz, 3), generator=gen)
    return CorruptDraws(
        viewpoints=v / torch.linalg.norm(v, dim=-1, keepdim=True),
        lidar_idx=torch.randint(0, NPOINTS, (48,), generator=gen),
        lidar_factor=1.2 + 0.3 * torch.rand((48,), generator=gen),
        shell_normal=torch.randn((bsz, 24, 3), generator=gen),
        aug_scale=2 / 3 + (3 / 2 - 2 / 3) * torch.rand((bsz, 1, 3), generator=gen),
        aug_shift=0.2 * (2 * torch.rand((bsz, 1, 3), generator=gen) - 1),
        # the FPS-column pick of a step without the noisy passes
        choice=torch.randperm(point_all_for(NPOINTS, N_POINTS), generator=gen)[:NPOINTS])


def phase_cls_card_vs_cpu(clouds, labels, config, card, device, stages=None, tag="cls",
                          rtol=1e-3, atol=2e-3, grad_rtol=1e-2, hold=True):
    """One cls train step at batch 8 in each of ``stages``, (name, trainable
    list or None for every parameter), the PEFT and joint stages unless
    given, on the card and on the CPU, from the same weights and draws
    (drawn on the CPU), dropout and drop-path off, without the gradient clip
    (the norm compared is the gradients' own): the loss within
    ``rtol``/``atol``, the norm within ``grad_rtol``; with ``hold`` False
    the gaps are printed and only finiteness is held."""
    from upp_torch.train.pipeline import CorruptDraws
    from upp_torch.train.runner_cls import JOINT_PEFT_LIST, PEFT_LIST
    stages = stages or (("PEFT", PEFT_LIST), ("joint", JOINT_PEFT_LIST))
    config = copy.deepcopy(config)
    config.grad_norm_clip = None
    bsz = B_CPU
    draws = cpu_draws(bsz)
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
        if not np.isfinite([card_l, card_g, cpu_l, cpu_g]).all():
            raise AssertionError(f"{tag} card vs CPU ({stage}): not finite: {results}")
        if hold and not np.isclose(card_l, cpu_l, rtol=rtol, atol=atol):
            raise AssertionError(f"{tag} card vs CPU ({stage}): loss {card_l} vs {cpu_l}")
        if hold and not np.isclose(card_g, cpu_g, rtol=grad_rtol, atol=0.0):
            raise AssertionError(f"{tag} card vs CPU ({stage}): grad norm {card_g} vs {cpu_g}")
        bounds = (f"rtol {rtol:g}, atol {atol:g}" if hold else "not held: its near ties "
                  "reorder")
        print(f"[{tag} card vs cpu] {stage}, B={bsz}: loss card {card_l:.6f}, cpu {cpu_l:.6f} "
              f"(rel {abs(card_l - cpu_l) / abs(cpu_l):.3g}; {bounds}), acc {card_a:.1f} / "
              f"{cpu_a:.1f}; trainable grad norm card {card_g:.6g}, cpu {cpu_g:.6g} (rel "
              f"{abs(card_g - cpu_g) / cpu_g:.3g}{f'; rtol {grad_rtol:g}' if hold else ''}) "
              f"({card})", flush=True)


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
    step reaches changed and every other one bit-unchanged; a replayed step
    held to the first (``check_replayed_step``); ms per step
    (mean of 10 after a warm-up), peak memory and a profile over 3 steps.
    Returns (launch counts of one step, the eval step)."""
    model, train_step, eval_step = seg_setup(config, device, unify)
    return phase_train(name, train_step, model, batch, card, want, B_SEG,
                       graphed=True), eval_step


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


@contextlib.contextmanager
def eager_steps():
    """Every ``cuda_graphs`` call inside (a ``GraphedStep``'s, a pass's) runs
    eager, as a key's first call does (the kNN backward's profiler ranges
    exist only there)."""
    from upp_torch.utils import cuda_graphs
    reason = cuda_graphs.eager_reason
    cuda_graphs.eager_reason = lambda *a, **kw: "chip_smoke"
    try:
        yield
    finally:
        cuda_graphs.eager_reason = reason


def check_replayed_step(name, step, model, batch, want):
    """One train step of a key already captured (its first call ran eager,
    its second captured): one replay and no eager step, the ``launches.*``
    of the eager step (``want``), no host sync, finite metrics, every
    tensor with a gradient changed and every other one bit-unchanged."""
    from upp_torch.utils import profiling
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    reset_counts()
    with profiling.tracing():
        out = step(*batch)
    (unit,) = profiling.units()
    counts = read_counts()
    graph = {k: v for k, v in unit["counts"].items() if k.startswith("cuda_graph.")}
    syncs = unit["counts"].get("host_syncs", 0)
    if counts != want or graph != {"cuda_graph.replays": 1} or syncs:
        raise AssertionError(f"{name}, replayed: launches {counts} (eager {want}), "
                             f"{graph}, {syncs} host syncs")
    vals = {k: float(v) for k, v in out.items()}
    if not all(np.isfinite(v) for v in vals.values()):
        raise AssertionError(f"{name}, replayed: not finite: {vals}")
    used = {n for n, p in model.named_parameters() if p.grad is not None}
    n_moved, n_fixed = _check_moves(f"{name}, replayed", model, before, used)
    print(f"[{name}] a replayed step: 1 replay, launches {counts} as the eager step's, 0 "
          f"host syncs, " + ", ".join(f"{k} {v:.4f}" for k, v in vals.items())
          + f"; {n_moved} tensors with a gradient changed, {n_fixed} others bit-unchanged",
          flush=True)


def phase_train(name, step, model, batch, card, want, bsz, graphed=False):
    """3 train steps: the launch counts of one (``want``), finite metrics,
    every tensor with a gradient changed and every other one bit-unchanged;
    with ``graphed`` (a step of ``cuda_graphs.GraphedStep``: the first runs
    eager, the second captures) a fourth, replayed, held to the first by
    ``check_replayed_step``; ms per step (mean of 10 after a warm-up),
    clouds/s, peak memory and a profile over 3 steps. Returns the launch
    counts; ``phase_train.last`` holds (ms per step, peak GiB, the
    profile)."""
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
    if graphed:
        check_replayed_step(name, step, model, batch, counts)
    step_ms = cuda_ms(lambda: step(*batch), reps=10, warmup=1)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[{name}] launches of one step {counts}; {n_moved} tensors with a gradient "
          f"changed, {n_fixed} others bit-unchanged; {step_ms:.2f} ms/step, "
          f"{bsz / step_ms * 1e3:.1f} clouds/s, peak {peak_gib:.2f} GiB (B={bsz}; {card})",
          flush=True)
    prof = profile_steps(lambda: step(*batch), name, step_ms, card, bsz=bsz)
    phase_train.last = (step_ms, peak_gib, prof)
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


def phase_pretrain_card_vs_cpu(clouds, config, card, device, tag="pretrain", rtol=1e-3,
                               atol=2e-3, grad_rtol=1e-2):
    """One pretrain step at batch 4 on the card and on the CPU from the
    same weights, group split and augmentation draws (drawn on the CPU),
    drop-path off: the loss within ``rtol``/``atol``, the gradients'
    global norm within ``grad_rtol``."""
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
    if not np.isclose(card_l, cpu_l, rtol=rtol, atol=atol):
        raise AssertionError(f"{tag} card vs CPU: loss {card_l} vs {cpu_l}")
    if not np.isclose(card_g, cpu_g, rtol=grad_rtol, atol=0.0):
        raise AssertionError(f"{tag} card vs CPU: grad norm {card_g} vs {cpu_g}")
    print(f"[{tag} card vs cpu] B={bsz}: loss card {card_l:.6f}, cpu {cpu_l:.6f} (rtol "
          f"{rtol:g}, atol {atol:g}); grad norm card {card_g:.6g}, cpu {cpu_g:.6g} (rtol "
          f"{grad_rtol:g}) ({card})", flush=True)


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
                         card, FT_CALLS, B_FT, graphed=True)
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


# ---------------------------------------------------------------------------
# phases 25-27: data parallelism (upp_torch.parallel)

DIST_DIR = os.path.join(CLI_DIR, "dist")
N_RANKS = 2             # ranks of phases 26-27
# Phases 26-27 hold each step of the ranks to one process's. Two kinds of
# step (float32 on the card; the ranks' GEMMs see 60 or 64 rows where one
# process sees 120 or 128, and BatchNorm's statistics come through
# all-reduces, so the rounding differs):
# * continuous ones, whose discrete choices (FPS, kNN, the group split) see
#   the input clouds alone: the cls PEFT step without the noisy passes
#   (crop-free FPS subsample, the downstream pass with its cross-rank
#   propagation gather, BatchNorms, dropout, drop-path) and the pretrain
#   step. Loss rtol 1e-4; each gradient tensor's relative norm 1e-3; a
#   gradient that is zero in exact arithmetic (a bias right before a
#   train-mode BatchNorm: below 1e-4 of the largest in one process) is
#   float32 noise, held below 1e-4 of the largest; running statistics
#   rtol 1e-4 / atol 1e-6; an updated parameter within 2.004 lr (AdamW's
#   first step moves an element by at most lr either way).
# * the flagship noisy cls steps, PEFT and joint: the rectify pass nudges
#   the points and sorts them by score, and the completion pass re-samples
#   them by FPS, so a last-bit difference in a score or a coordinate
#   reorders near ties and picks other points (tests/test_torch_port_dist.py
#   holds this step exactly in float64, where no tie moves). They are held
#   to the bounds of the card-vs-CPU phase 12, which meets the same near
#   ties: loss rtol 1e-3 / atol 2e-3, the trainable gradients' global norm
#   rtol 1e-2.
DIST_TOL = {"loss": 1e-4, "grad": 1e-3, "grad_floor": 1e-4, "running_rtol": 1e-4,
            "running_atol": 1e-6, "noisy_loss_rtol": 1e-3, "noisy_loss_atol": 2e-3,
            "noisy_norm_rtol": 1e-2}
DIST_CONTINUOUS = ("cls clean", "pretrain")
DIST_NOISY = ("cls peft", "cls joint")


def _child_env(**extra):
    """The environment of a child process: this one's, without a process
    group's variables unless given; every rank runs on this host, so gloo
    and NCCL connect over the loopback interface unless told otherwise."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    env.setdefault("NCCL_SOCKET_IFNAME", "lo")
    env.update(extra)
    return env


def _run_children(children, timeout):
    """Run (name, command, environment) children at once, each in a session
    of its own with its output in ``DIST_DIR/<name>.log``; wait for all,
    kill every one left (its whole session) at the deadline or when one
    fails, and raise with the failed one's log tail."""
    import signal
    os.makedirs(DIST_DIR, exist_ok=True)
    procs = []
    try:
        for name, cmd, env in children:
            log = os.path.join(DIST_DIR, f"{name}.log")
            with open(log, "w") as f:
                procs.append((name, log, subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT,
                                                          env=env, start_new_session=True)))
        deadline = time.time() + timeout
        for name, log, p in procs:
            try:
                p.wait(timeout=max(deadline - time.time(), 1.0))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"{name}: no exit within {timeout} s; log tail "
                                     f"{open(log).read()[-3000:]}") from None
            if p.returncode != 0:
                raise AssertionError(f"{name}: exit {p.returncode}; log tail "
                                     f"{open(log).read()[-3000:]}")
    finally:
        for _, _, p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()


def _free_port() -> str:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return str(sock.getsockname()[1])


def phase_dist_world1(card, peft_ms):
    """Phase 25: phase 13's CLI command with ``--deterministic`` under
    ``python -m torch.distributed.run --standalone --nproc_per_node 1
    --launcher pytorch`` (NCCL, a world of one: no collective runs) and,
    side by side, without the launcher: their ``ckpt-last.pth`` must be
    equal bit for bit (model and optimizer). Without ``--deterministic``
    the atomic scatter-adds of the backwards make runs differ in their low
    bits, and the noisy passes' near ties (phase 26) can turn that into
    other sampled points. Then the cls PEFT train step at batch 120 through
    the launched code path, timed as phase 10 times it."""
    import glob
    cfg = os.path.join(CLI_DIR, "cls_cli_train.yaml")
    argv = ["--peft_model", "--config", cfg, "--joint_optimization", "1", "--deterministic"]
    torchrun = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc_per_node", "1"]
    t0 = time.time()
    _run_children([("world1_cli", torchrun + ["-m", "upp_torch.main", "--launcher", "pytorch",
                                              *argv, "--exp_name", "chip_smoke_world1"],
                    _child_env()),
                   ("plain_cli", [sys.executable, "-m", "upp_torch.main", *argv,
                                  "--exp_name", "chip_smoke_plain"], _child_env())],
                  timeout=300)
    cli_s = time.time() - t0

    def last(exp):
        path = sorted(glob.glob(f"experiments/cls_cli_train/plain-network/peft-{exp}/*/"
                                "ckpt-last.pth"))[-1]
        return torch.load(path, map_location="cpu", weights_only=True)

    launched, plain = last("chip_smoke_world1"), last("chip_smoke_plain")
    tensors = [(f"base_model.{k}", v, plain["base_model"][k])
               for k, v in launched["base_model"].items()]
    tensors += [(f"optimizer.{i}.{k}", v, plain["optimizer"]["state"][i][k])
                for i, st in launched["optimizer"]["state"].items() for k, v in st.items()]
    differ = [n for n, a, b in tensors if not torch.equal(a, b)]
    if (differ or launched["epoch"] != 2 or plain["epoch"] != 2
            or launched["base_model"].keys() != plain["base_model"].keys()
            or launched["optimizer"]["state"].keys() != plain["optimizer"]["state"].keys()):
        raise AssertionError(f"dist world1: the launched run's ckpt-last differs from the plain "
                             f"run's in {len(differ)} tensors {differ[:5]}, epochs "
                             f"{launched['epoch']} / {plain['epoch']}")
    out = os.path.join(DIST_DIR, "world1_time.json")
    _run_children([("world1_time", torchrun + [os.path.abspath(__file__), "--dist-worker",
                                               "time", out], _child_env())], timeout=300)
    timed = json.load(open(out))
    if timed["counts"]:
        raise AssertionError(f"dist world1: collectives ran in a world of one: {timed['counts']}")
    print(f"[dist world1] phase 13's CLI with --deterministic under torchrun --nproc_per_node 1 "
          f"--launcher pytorch (NCCL) and without the launcher: ckpt-last equal bit for bit "
          f"({len(tensors)} tensors, model and AdamW moments, epoch {launched['epoch']}); both "
          f"runs {cli_s:.1f} s of wall time side by side; cls PEFT train step at B={B} through "
          f"the launched code path (backend {timed['backend']}, world {timed['world']}, no "
          f"collective): {timed['ms']:.2f} ms/step, phase 10 {peft_ms:.2f} ms/step ({card})",
          flush=True)


def _whole(model, full):
    """(gradients, parameters with a gradient, running statistics) of
    ``model`` on the CPU, each split tensor gathered whole by ``full(name,
    tensor)`` (a collective: every rank calls it)."""
    grads, params = {}, {}
    for n, p in model.named_parameters():
        if p.grad is not None:
            grads[n] = full(n, p.grad).to("cpu", copy=True)
            params[n] = full(n, p.detach()).to("cpu", copy=True)
    return grads, params, {k: v.to("cpu", copy=True) for k, v in model.state_dict().items()
                           if "running_" in k}


def dist_steps(device, timed=False, tp=False):
    """This process's share of phases 26-27's steps, each from the seeded
    weights on this rank's rows of the global batches: the cls PEFT step at
    batch 120 without the noisy passes (``cls clean``), with them (``cls
    peft``), and the joint step after ``set_trainable(JOINT_PEFT_LIST)`` on
    the live optimizer (``cls joint``); the pretrain step at batch 128.
    For each: the global loss, the collectives by kind, the averaged
    gradients, the parameters with a gradient and the running statistics
    after the step (on the CPU), the learning rate; with ``timed`` also ms
    per step (mean of 5 after a warm-up). The cls steps run without the
    gradient clip, as phase 12's: a clipped norm would hide the gradients'
    own. With ``tp`` (phase 47) the cls steps alone, under a grid of
    ``world // 2`` data ranks x 2 model ranks (``upp_torch.parallel.tensor``),
    the split tensors gathered whole, and the kernels' launches of the
    ``cls peft`` step."""
    from upp_torch.parallel import tensor
    from upp_torch.parallel.dist import COUNTS, clear_grid, data_info, make_grid, model_group
    from upp_torch.train.optim import set_trainable
    from upp_torch.train.runner_cls import JOINT_PEFT_LIST, PEFT_LIST
    from upp_torch.utils.config import cfg_from_yaml_file
    if tp:
        make_grid(2)
    rank, world = data_info()
    clouds_np, labels_np = synthetic_clouds(B_PRETRAIN)

    def mine(a, n):
        b = n // world
        return torch.from_numpy(a[:n][rank * b:(rank + 1) * b]).to(device)

    out = {}

    def run(name, step, model, lr, *batch):
        COUNTS.clear()
        reset_counts()
        m = step(*batch)
        torch.cuda.synchronize()
        launches = read_counts()
        full = (lambda n, t: tensor.full_tensor(model, n, t)) if tp else (lambda n, t: t)
        grads, params, running = _whole(model, full)
        out[name] = {"loss": float(m["loss"]), "counts": dict(COUNTS), "lr": lr,
                     "grads": grads, "params": params, "running": running,
                     "launches": launches}
        if timed:
            out[name]["ms"] = cuda_ms(lambda: step(*batch), reps=3 if tp else 5, warmup=1)

    pts, lab = mine(clouds_np, B), mine(labels_np, B)
    for name, noisy, switch in (("cls clean", False, False), ("cls peft", True, False),
                                ("cls joint", True, True)):
        config = cfg_from_yaml_file(CFG)
        config.noisy_train = noisy
        config.grad_norm_clip = None    # the gradients compared are the step's own
        model, _, step = cls_train_setup(config, device, PEFT_LIST)
        if tp:
            tensor.shard_model(model, model_group())
        if switch:
            set_trainable(model, JOINT_PEFT_LIST)
        run(name, step, model, float(config.optimizer.kwargs.lr), pts, lab)
        del model, step
    if tp:
        out["passes"] = tp_passes(device, mine(clouds_np, B))
        clear_grid()
        torch.cuda.empty_cache()
        return out
    pre_cfg = cfg_from_yaml_file(PRETRAIN_CFG)
    model, step = pretrain_setup(pre_cfg, device)
    run("pretrain", step, model, float(pre_cfg.optimizer.kwargs.lr), mine(clouds_np, B_PRETRAIN))
    del model, step
    torch.cuda.empty_cache()
    return out


def dist_worker(argv) -> int:
    """A child process of phases 25-27 (``chip_smoke.py --dist-worker``):
    ``time OUT`` under torchrun (a world of one) times the cls PEFT train
    step at batch 120; ``ranks BACKEND OUT_DIR`` is one rank of phase 26 or
    27 (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_*`` set by the
    parent) and saves ``dist_steps`` to ``OUT_DIR/rank<r>.pt``; ``tp
    BACKEND OUT_DIR`` the same for phase 47 (``dist_steps(tp=True)``),
    ``fsdp BACKEND OUT_DIR`` for phase 46 (``fsdp_steps``)."""
    from upp_torch import resolve_device
    from upp_torch.parallel.dist import COUNTS, get_dist_info, init_dist
    if argv[0] == "time":
        device = resolve_device(init_dist("pytorch", "cuda"))
        from upp_torch.train.runner_cls import PEFT_LIST
        from upp_torch.utils.config import cfg_from_yaml_file
        clouds_np, labels_np = synthetic_clouds(B)
        _, _, step = cls_train_setup(cfg_from_yaml_file(CFG), device, PEFT_LIST)
        pts, lab = torch.from_numpy(clouds_np).to(device), torch.from_numpy(labels_np).to(device)
        COUNTS.clear()
        ms = cuda_ms(lambda: step(pts, lab), reps=10, warmup=1)
        with open(argv[1], "w") as f:
            json.dump({"ms": ms, "counts": dict(COUNTS), "world": get_dist_info()[1],
                       "backend": torch.distributed.get_backend()}, f)
    else:
        backend, out_dir = argv[1], argv[2]
        device = resolve_device(init_dist("pytorch", "cuda", backend=backend))
        out = os.path.join(out_dir, f"rank{get_dist_info()[0]}.pt")
        if argv[0] == "fsdp":
            torch.save(fsdp_steps(device, out_dir), out)
        else:
            torch.save(dist_steps(device, timed=True, tp=argv[0] == "tp"), out)
    torch.distributed.destroy_process_group()
    return 0


def _grad_norm(grads):
    return sum(float((g.double() ** 2).sum()) for g in grads.values()) ** 0.5


def _hold_dist(tag, name, ref, ranks, steps=1, hold_noisy=True):
    """One step of ``N_RANKS`` ranks against one process at ``DIST_TOL``
    (``DIST_CONTINUOUS`` tensor by tensor, ``DIST_NOISY`` by loss and
    gradient norm; without ``hold_noisy`` those two are printed, not
    held), and the ranks against each other bit for bit; the parameters
    after ``steps`` steps from the same weights are held within 2.004 lr a
    step. Returns a summary."""
    got = ranks[0][name]
    want = ref[name]
    for other in ranks[1:]:
        o = other[name]
        for part in ("grads", "params", "running"):
            bad = [k for k in got[part] if not torch.equal(got[part][k], o[part][k])]
            if bad or got[part].keys() != o[part].keys():
                raise AssertionError(f"{tag} {name}: ranks differ in {part} {bad[:5]}")
        if o["loss"] != got["loss"]:
            raise AssertionError(f"{tag} {name}: ranks' losses {got['loss']} vs {o['loss']}")
    if got["grads"].keys() != want["grads"].keys():
        raise AssertionError(f"{tag} {name}: tensors with a gradient differ")
    norm, norm_ref = _grad_norm(got["grads"]), _grad_norm(want["grads"])
    whole = sum(float(((got["grads"][k] - g).double() ** 2).sum())
                for k, g in want["grads"].items()) ** 0.5 / norm_ref
    c = got["counts"]
    tail = (f"collectives a step: {c.get('forward', 0)} forward ({c.get('forward_bytes', 0)} "
            f"B), {c.get('backward', 0)} backward ({c.get('backward_bytes', 0)} B), "
            f"{c.get('gradients', 0)} gradient all-reduce ({c.get('gradients_bytes', 0)} B), "
            + "".join(f"{c[k]} {k} ({c[k + '_bytes']} B), " for k in ("fsdp", "tp") if k in c)
            + f"{c.get('host', 0)} for the logged metrics; {got['ms']:.2f} ms/step")
    if name in DIST_NOISY:
        if hold_noisy and not np.isclose(got["loss"], want["loss"],
                                         rtol=DIST_TOL["noisy_loss_rtol"],
                                         atol=DIST_TOL["noisy_loss_atol"]):
            raise AssertionError(f"{tag} {name}: loss {got['loss']} vs one process {want['loss']}")
        if hold_noisy and not np.isclose(norm, norm_ref, rtol=DIST_TOL["noisy_norm_rtol"],
                                         atol=0.0):
            raise AssertionError(f"{tag} {name}: gradient norm {norm} vs one process {norm_ref}")
        held = "" if hold_noisy else ", printed, not held: the passes are held one by one"
        return (f"{name}: loss {got['loss']:.6f} vs one process {want['loss']:.6f} (rtol 1e-3, "
                f"atol 2e-3{held}); trainable gradient norm {norm:.6g} vs {norm_ref:.6g} (rtol "
                f"1e-2), the gradients {whole:.3g} apart (whole relative norm: other points "
                f"picked at the near ties); {tail}")
    if not np.isclose(got["loss"], want["loss"], rtol=DIST_TOL["loss"], atol=0.0):
        raise AssertionError(f"{tag} {name}: loss {got['loss']} vs one process {want['loss']}")
    top = max(float(g.abs().max()) for g in want["grads"].values())
    worst, worst_k, noise = 0.0, "", 0.0
    for k, g in want["grads"].items():
        if float(g.abs().max()) <= DIST_TOL["grad_floor"] * top:
            noise = max(noise, float(got["grads"][k].abs().max()) / top)
            if noise > DIST_TOL["grad_floor"]:
                raise AssertionError(f"{tag} {name}: vanishing gradient {k} at {noise:.3g}")
            continue
        rel = float((got["grads"][k] - g).norm() / g.norm())
        if rel > worst:
            worst, worst_k = rel, f"{k}, its largest element {float(g.abs().max()) / top:.3g} of the step's"
        if rel > DIST_TOL["grad"]:
            raise AssertionError(f"{tag} {name}: gradient {k} {rel:.3g} from one process")
    lr = want["lr"]
    p_max, flips, total = 0.0, 0, 0
    for k, p in want["params"].items():
        d = (got["params"][k] - p).abs()
        p_max = max(p_max, float(d.max()))
        flips += int((d > 0.1 * lr).sum())
        total += d.numel()
    if p_max > 2.004 * lr * steps:
        raise AssertionError(f"{tag} {name}: a parameter {p_max:.3g} from one process "
                             f"(bound {2.004 * lr * steps:.3g})")
    r_max = 0.0
    for k, v in want["running"].items():
        if not torch.allclose(got["running"][k], v, rtol=DIST_TOL["running_rtol"],
                              atol=DIST_TOL["running_atol"]):
            raise AssertionError(f"{tag} {name}: running statistic {k} differs")
        r_max = max(r_max, float((got["running"][k] - v).abs().max()))
    return (f"{name}: loss {got['loss']:.6f} vs one process {want['loss']:.6f}; gradients "
            f"worst tensor {worst:.3g} ({worst_k}; relative norm; whole {whole:.3g}), vanishing ones "
            f"{noise:.3g} of the largest; parameters within {p_max:.3g} (bound "
            f"{2.004 * lr * steps:.3g}), {flips} of {total} elements more than lr/10 apart; running "
            f"statistics within {r_max:.3g}; {tail}")


def _rank_children(kind, backend, local_ranks, timeout=600):
    """Run ``chip_smoke.py --dist-worker KIND BACKEND DIR`` as
    ``len(local_ranks)`` ranks (rank r on card ``local_ranks[r]``); their
    saved results by rank, and the wall time."""
    world = len(local_ranks)
    out_dir = os.path.join(DIST_DIR, f"{kind}_{backend}{world}")
    os.makedirs(out_dir, exist_ok=True)
    port = _free_port()
    t0 = time.time()
    _run_children([(f"{kind}_rank{r}_{backend}{world}",
                    [sys.executable, os.path.abspath(__file__), "--dist-worker", kind,
                     backend, out_dir],
                    _child_env(RANK=str(r), WORLD_SIZE=str(world),
                               LOCAL_RANK=str(local_ranks[r]), MASTER_ADDR="127.0.0.1",
                               MASTER_PORT=port))
                   for r in range(world)], timeout=timeout)
    return ([torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
             for r in range(world)], time.time() - t0)


def dist_ranks(tag, backend, local_ranks, ref, card):
    """``len(local_ranks)`` rank processes (rank r on card ``local_ranks[r]``)
    over ``backend`` run ``dist_steps``; each step is held to this process's
    (``ref``) at ``DIST_TOL`` and the ranks to each other bit for bit."""
    world = len(local_ranks)
    out_dir = os.path.join(DIST_DIR, f"{backend}{world}")
    os.makedirs(out_dir, exist_ok=True)
    port = _free_port()
    t0 = time.time()
    _run_children([(f"rank{r}_{backend}{world}",
                    [sys.executable, os.path.abspath(__file__), "--dist-worker", "ranks",
                     backend, out_dir],
                    _child_env(RANK=str(r), WORLD_SIZE=str(world),
                               LOCAL_RANK=str(local_ranks[r]), MASTER_ADDR="127.0.0.1",
                               MASTER_PORT=port))
                   for r in range(world)], timeout=600)
    wall_s = time.time() - t0
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=True)
             for r in range(world)]
    for name in DIST_CONTINUOUS + DIST_NOISY:
        print(f"[{tag}] {_hold_dist(tag, name, ref, ranks)}", flush=True)
    share = ("processes time-sharing one card: not a scaling number"
             if len(set(local_ranks)) == 1 else "one card a rank")
    print(f"[{tag}] {world} ranks over {backend}, batches {B} and {B_PRETRAIN} at "
          f"{B // world} and {B_PRETRAIN // world} a rank; ms/step above are rank 0's "
          f"({share}); {wall_s:.1f} s of wall time for the ranks ({card})", flush=True)


def phase_dist_ranks(card, device):
    """Phase 26: ``N_RANKS`` processes share the one card over gloo (passed
    explicitly: NCCL takes one rank a device), each with ``LOCAL_RANK`` 0
    and half of each global batch, against this process's one-process steps
    (``dist_steps``) at ``DIST_TOL``, the ranks equal bit for bit. Phase 27:
    the same over NCCL on two cards, when there are two."""
    ref = dist_steps(device)
    dist_ranks("dist two ranks, one card", "gloo", [0] * N_RANKS, ref, card)
    if torch.cuda.device_count() >= N_RANKS:
        dist_ranks("dist nccl two cards", "nccl", list(range(N_RANKS)), ref, card)
    else:
        print(f"[dist nccl two cards] not run: {torch.cuda.device_count()} card(s) here, "
              f"NCCL needs a card for each of the {N_RANKS} ranks ({card})", flush=True)
    return ref


# ---------------------------------------------------------------------------
# phases 46-49: ZeRO-3 (upp_torch.parallel.fsdp), tensor parallelism
# (upp_torch.parallel.tensor), the dry run (upp_torch.dryrun) and two node groups

TP_NAMES = ("cls clean", "cls peft", "cls joint")


def fsdp_steps(device, out_dir):
    """One rank of phase 46 (or of the four-card run): the pretrain step at
    batch 128 on this rank's rows, from the seeded weights, replicated and
    then ZeRO-3 (``fsdp.shard_model``): each of two steps' loss, collectives,
    gradients and updated parameters gathered whole, running statistics;
    the kernels' launches of the first step; ms per step (3 after a
    warm-up), persistent parameter and moment bytes and peak memory. Then,
    sharded: a blocking checkpoint, a resume into a fresh sharded model and
    the next step of both; on rank 0 the ``.pth`` against a one-process
    model and optimizer loaded from it."""
    from upp_torch.parallel import fsdp
    from upp_torch.parallel.dist import COUNTS, get_dist_info
    from upp_torch.train import checkpoint
    from upp_torch.train.optim import build_optimizer
    from upp_torch.train.runner_cls import init_model
    from upp_torch.train.runner_pretrain import make_pretrain_step
    from upp_torch.utils.config import cfg_from_yaml_file
    rank, world = get_dist_info()
    cfg = cfg_from_yaml_file(PRETRAIN_CFG)
    lr = float(cfg.optimizer.kwargs.lr)
    b = B_PRETRAIN // world
    pts = torch.from_numpy(synthetic_clouds(B_PRETRAIN)[0][rank * b:(rank + 1) * b]).to(device)
    args = types.SimpleNamespace(seed=SEED)

    def setup(shard):
        model = init_model(args, cfg, device)
        opt = build_optimizer(cfg, model, steps_per_epoch=1)
        if shard:
            fsdp.shard_model(model)
        return model, opt, make_pretrain_step(model, opt, cfg, args)

    out = {}
    for mode in ("replicated", "fsdp"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model, opt, step = setup(mode == "fsdp")
        res = out[mode] = {"steps": []}
        for i in range(2):
            COUNTS.clear()
            reset_counts()
            loss = float(step(pts)["loss"])
            torch.cuda.synchronize()
            if i == 0:
                res["launches"] = read_counts()
            grads, params, running = _whole(model, lambda n, t: fsdp.full_tensor(model, n, t))
            res["steps"].append({"loss": loss, "counts": dict(COUNTS), "lr": lr, "grads": grads,
                                 "params": params, "running": running})
        res["ms"] = cuda_ms(lambda: step(pts), reps=3, warmup=1)
        res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        res["param_bytes"], res["moment_bytes"] = fsdp.persistent_bytes(model, opt)
        if mode == "fsdp":
            ckpt_dir = os.path.join(out_dir, "ckpt")
            checkpoint.save_checkpoint(model, opt, 0, "ckpt-last", ckpt_dir, block=True)
            resumed, r_opt, r_step = setup(True)
            res["start_epoch"], _ = checkpoint.resume_checkpoint(
                resumed, r_opt, ckpt_dir, logger="silent", steps_per_epoch=opt.num_steps)
            res["next_loss"] = float(step(pts)["loss"])
            res["resumed_loss"] = float(r_step(pts)["loss"])
            del resumed, r_opt, r_step
            if rank == 0:
                saved = torch.load(os.path.join(ckpt_dir, "ckpt-last.pth"), map_location="cpu",
                                   weights_only=True)
                plain = init_model(args, cfg, device)
                plain.load_state_dict(saved["base_model"], strict=True)
                p_opt = build_optimizer(cfg, plain, steps_per_epoch=1)
                p_opt.load_state_dict(saved["optimizer"])
                mine = [(f"base_model.{k}", v, saved["base_model"][k])
                        for k, v in plain.state_dict().items()]
                state = p_opt.state_dict()
                mine += [(f"optimizer.{i}.{k}", v, saved["optimizer"]["state"][i][k])
                         for i, st in state["state"].items() for k, v in st.items()]
                res["layout"] = {
                    "tensors": len(mine),
                    "differ": [n for n, a, b_ in mine if not torch.equal(a.cpu(), b_.cpu())],
                    "keys_equal": (plain.state_dict().keys() == saved["base_model"].keys()
                                   and state["state"].keys() == saved["optimizer"]["state"].keys())}
                del plain, p_opt
        del model, opt, step
    return out


def tp_passes(device, pts):
    """This rank's part of phase 47's pass-by-pass check: the noisy cls
    step's three passes (``cls_passes``) of a dp1 x tp2 model against the
    one-process model, both from the seeded weights in train mode with
    dropout and drop-path off, on the card, on ``pts`` corrupted with a
    seeded generator; for each output (largest difference, largest
    element, within phase 12's bounds), and the discrete choices that
    differ."""
    from upp_torch.parallel import tensor
    from upp_torch.parallel.dist import model_group
    from upp_torch.train.pipeline import corrupt_batch
    from upp_torch.train.runner_cls import PEFT_LIST
    from upp_torch.utils.config import cfg_from_yaml_file
    config = cfg_from_yaml_file(CFG)
    got = no_dropout(cls_train_setup(config, device, PEFT_LIST)[0]).train()
    tensor.shard_model(got, model_group())
    want = no_dropout(cls_train_setup(config, device, PEFT_LIST)[0]).train()
    points = corrupt_batch(pts, npoints=NPOINTS, n_points_dataset=N_POINTS, noisy_train=True,
                           incomplete_cropping=True,
                           augmentation=config.get("data_augmentation"),
                           generator=torch.Generator(device).manual_seed(SEED + 5))
    outs, counts = cls_passes({"got": (got, device), "want": (want, device)}, points)
    rtol, atol = DIST_TOL["noisy_loss_rtol"], DIST_TOL["noisy_loss_atol"]
    return {"outs": {n: ((g - w).abs().max().item(), w.abs().max().item(),
                         bool(torch.allclose(g, w, rtol=rtol, atol=atol)))
                     for n, (g, w) in outs.items()}, "counts": counts}


def phase_fsdp(card, backend="gloo", local_ranks=(0,) * N_RANKS,
               tag="fsdp two ranks, one card"):
    """Phase 46 (and the four-card ZeRO-3 run): ``fsdp_steps`` on
    ``len(local_ranks)`` ranks; the sharded steps held to the replicated
    ones. Returns rank 0's launches of the sharded step."""
    ranks, wall_s = _rank_children("fsdp", backend, list(local_ranks))
    world = len(local_ranks)
    rep0 = ranks[0]["replicated"]
    for i in range(2):
        name = f"pretrain step {i + 1}"
        ref = {name: {**rep0["steps"][i], "ms": rep0["ms"]}}
        got = [{name: {**r["fsdp"]["steps"][i], "ms": r["fsdp"]["ms"]}} for r in ranks]
        print(f"[{tag}] sharded vs replicated, {_hold_dist(tag, name, ref, got, steps=i + 1)}",
              flush=True)
    for r, res in enumerate(ranks):
        f, p = res["fsdp"], res["replicated"]
        if f["param_bytes"] > 0.6 * p["param_bytes"] or f["moment_bytes"] > 0.6 * p["moment_bytes"]:
            raise AssertionError(f"{tag}: rank {r} holds {f['param_bytes']} parameter and "
                                 f"{f['moment_bytes']} moment bytes, replicated "
                                 f"{p['param_bytes']} and {p['moment_bytes']}")
        print(f"[{tag}] rank {r}: parameters {f['param_bytes'] / 1e6:.2f} MB and AdamW moments "
              f"{f['moment_bytes'] / 1e6:.2f} MB between steps (replicated "
              f"{p['param_bytes'] / 1e6:.2f} and {p['moment_bytes'] / 1e6:.2f} MB); peak "
              f"{f['peak_gib']:.2f} GiB (replicated {p['peak_gib']:.2f}); {f['ms']:.2f} ms/step "
              f"(replicated {p['ms']:.2f}); kernel launches of a sharded step {f['launches']}",
              flush=True)
    f0 = ranks[0]["fsdp"]
    lay = f0["layout"]
    if f0["start_epoch"] != 1 or not np.isclose(f0["resumed_loss"], f0["next_loss"],
                                                rtol=DIST_TOL["loss"], atol=0.0):
        raise AssertionError(f"{tag}: resume at epoch {f0['start_epoch']}, next loss "
                             f"{f0['resumed_loss']} vs the continuing run's {f0['next_loss']}")
    if lay["differ"] or not lay["keys_equal"]:
        raise AssertionError(f"{tag}: the sharded .pth differs from a one-process save of its "
                             f"state in {lay['differ'][:5]} (keys equal: {lay['keys_equal']})")
    print(f"[{tag}] checkpoint: gathered on every rank, written by rank 0; loaded strictly into "
          f"a one-process model and optimizer whose state dicts equal it in all "
          f"{lay['tensors']} tensors; resumed into ZeRO-3 at epoch {f0['start_epoch']}, next "
          f"step loss {f0['resumed_loss']:.6f} vs the continuing run's {f0['next_loss']:.6f}; "
          f"{world} ranks over {backend}, batch {B_PRETRAIN} at {B_PRETRAIN // world} a rank, "
          f"{wall_s:.1f} s of wall time for the ranks ({card})", flush=True)
    return f0["launches"]


def phase_tp(card, ref, backend="gloo", local_ranks=(0,) * N_RANKS,
             tag="tp two ranks, one card"):
    """Phase 47 (and the four-card dp2 x tp2 run): ``dist_steps(tp=True)``
    on ``len(local_ranks)`` ranks held to the one-process steps ``ref``
    (phase 26's) at its bounds. Returns rank 0's launches of the cls PEFT
    step."""
    ranks, wall_s = _rank_children("tp", backend, list(local_ranks))
    world = len(local_ranks)
    for name in TP_NAMES:
        print(f"[{tag}] {_hold_dist(tag, name, ref, ranks, hold_noisy=False)}", flush=True)
    passes = ranks[0]["passes"]
    bad = [(r, n) for r, res in enumerate(ranks)
           for n, (_, _, ok) in res["passes"]["outs"].items() if not ok]
    if bad:
        raise AssertionError(f"{tag}: passes with their input handed across differ from one "
                             f"process in (rank, output) {bad}: "
                             f"{[res['passes']['outs'] for res in ranks]}")
    print(f"[{tag}] the noisy step's passes on rank 0's rows (each rank holds its own), "
          f"each on the one-process model's input, dropout and drop-path off: "
          + ", ".join(f"{n} {d:.3g} (largest {t:.3g})" for n, (d, t, _) in passes["outs"].items())
          + f" apart, within rtol {DIST_TOL['noisy_loss_rtol']} / atol "
          f"{DIST_TOL['noisy_loss_atol']}; differing from one process: "
          f"{_choices(passes['counts'])}", flush=True)
    print(f"[{tag}] dp{world // 2} x tp2 over {backend}: batch {B} at {B // (world // 2)} a "
          f"data rank, 3 of the 6 heads and half of each MLP a model rank; ms/step above are "
          f"rank 0's; {wall_s:.1f} s of wall time for the ranks ({card})", flush=True)
    return ranks[0]["cls peft"]["launches"]


def phase_dryrun(card):
    """Phase 48: the port's dry run and entry on the card."""
    from upp_torch import dryrun
    t0 = time.time()
    losses = dryrun.dryrun_multichip(N_RANKS)
    dry_s = time.time() - t0
    fn, args = dryrun.entry()
    logits = fn(*args)
    torch.cuda.synchronize()
    if logits.shape != (8, 40) or not torch.isfinite(logits).all():
        raise AssertionError(f"dryrun entry: logits {tuple(logits.shape)}, finite "
                             f"{bool(torch.isfinite(logits).all())}")
    ms = cuda_ms(lambda: fn(*args), reps=3, warmup=1)
    del fn, args
    print(f"[dryrun] dryrun_multichip({N_RANKS}): losses {losses}, {dry_s:.1f} s of wall time; "
          f"entry(): full-width noisy forward at batch 8, logits (8, 40) finite, {ms:.2f} ms "
          f"({card})", flush=True)


def _last_ckpt(exp):
    import glob
    path = sorted(glob.glob(f"experiments/cls_cli_train/plain-network/peft-{exp}/*/"
                            "ckpt-last.pth"))[-1]
    return torch.load(path, map_location="cpu", weights_only=True)


def phase_two_node_groups(card):
    """Phase 49: phase 13's CLI command with ``--deterministic`` under two
    node groups and under one node of two ranks, gloo on the card; their
    ``ckpt-last.pth`` must be equal bit for bit."""
    cfg = os.path.join(CLI_DIR, "cls_cli_train.yaml")
    argv = ["-m", "upp_torch.main", "--launcher", "pytorch", "--dist_backend", "gloo",
            "--peft_model", "--config", cfg, "--joint_optimization", "1", "--deterministic"]
    run = [sys.executable, "-m", "torch.distributed.run"]
    port = _free_port()
    t0 = time.time()
    _run_children([(f"node{r}", run + ["--nnodes", "2", "--node_rank", str(r),
                                        "--nproc_per_node", "1", "--master_addr", "127.0.0.1",
                                        "--master_port", port] + argv
                    + ["--exp_name", "chip_smoke_nodes"], _child_env()) for r in (0, 1)]
                  + [("one_node", run + ["--standalone", "--nproc_per_node", "2"] + argv
                      + ["--exp_name", "chip_smoke_one_node"], _child_env())], timeout=420)
    wall_s = time.time() - t0
    nodes, one = _last_ckpt("chip_smoke_nodes"), _last_ckpt("chip_smoke_one_node")
    tensors = [(f"base_model.{k}", v, one["base_model"][k]) for k, v in nodes["base_model"].items()]
    tensors += [(f"optimizer.{i}.{k}", v, one["optimizer"]["state"][i][k])
                for i, st in nodes["optimizer"]["state"].items() for k, v in st.items()]
    differ = [n for n, a, b in tensors if not torch.equal(a, b)]
    if (differ or nodes["epoch"] != 2 or one["epoch"] != 2
            or nodes["base_model"].keys() != one["base_model"].keys()
            or nodes["optimizer"]["state"].keys() != one["optimizer"]["state"].keys()):
        raise AssertionError(f"two node groups: ckpt-last differs from one node's in "
                             f"{len(differ)} tensors {differ[:5]}, epochs {nodes['epoch']} / "
                             f"{one['epoch']}")
    print(f"[two node groups] phase 13's CLI with --deterministic under --nnodes 2 "
          f"--nproc_per_node 1 (rank 1 at local rank 0) and under --standalone "
          f"--nproc_per_node 2, gloo on the card: ckpt-last equal bit for bit ({len(tensors)} "
          f"tensors, model and AdamW moments, epoch {nodes['epoch']}); both runs "
          f"{wall_s:.1f} s of wall time side by side ({card})", flush=True)


def phase_four_cards(card, ref):
    """ZeRO-3 over four NCCL ranks and dp2 x tp2 over NCCL, a card a rank,
    when there are four cards."""
    n = torch.cuda.device_count()
    if n < 4:
        print(f"[four cards] not run: {n} card(s) here; ZeRO-3 over four NCCL ranks and "
              f"dp2 x tp2 need a card a rank ({card})", flush=True)
        return
    phase_fsdp(card, "nccl", (0, 1, 2, 3), "fsdp nccl four cards")
    phase_tp(card, ref, "nccl", (0, 1, 2, 3), "dp2 x tp2 nccl four cards")


# ---------------------------------------------------------------------------
# phases 28-32: point cloud completion (PoinTr, AdaPoinTr) and EMD

# PoinTr's published PCN configuration: the model of cfgs/PCN_models/PoinTr.yaml
# in the PoinTr repository (the keys the port reads)
POINTR_PCN = {"NAME": "PoinTr", "num_pred": 14336, "num_query": 224, "knn_layer": 1,
              "trans_dim": 384}
# AdaPoinTr's: the model of cfgs/PCN_models/AdaPoinTr.yaml in the PoinTr
# repository (the keys the port reads; it groups with the DGCNN grouper, as
# the JAX package does, not the source's center_num hierarchy)
ADAPOINTR_PCN = {
    "NAME": "AdaPoinTr", "num_query": 512, "num_points": 16384, "decoder_type": "fc",
    "encoder_config": {"embed_dim": 384, "depth": 6, "num_heads": 6,
                       "block_style_list": ["attn-graph"] + ["attn"] * 5,
                       "combine_style": "concat"},
    "decoder_config": {"embed_dim": 384, "depth": 8, "num_heads": 6,
                       "self_attn_block_style_list": ["attn-graph"] + ["attn"] * 7,
                       "self_attn_combine_style": "concat",
                       "cross_attn_block_style_list": ["attn-graph"] + ["attn"] * 7,
                       "cross_attn_combine_style": "concat"}}
# AdaPoinTr at the same width with every local block style: the encoder
# combines by concat, the decoder's self-attention one by one (rw_deform
# takes no denoise split, so it sits in the encoder), its cross-attention
# by concat
ADAPOINTR_STYLES = copy.deepcopy(ADAPOINTR_PCN)
ADAPOINTR_STYLES["encoder_config"]["block_style_list"] = [
    "attn-graph", "attn-rw_deform", "attn-deform", "attn-deform_graph", "graph", "attn"]
ADAPOINTR_STYLES["decoder_config"].update(
    self_attn_block_style_list=["attn-graph", "attn-deform", "attn-deform_graph", "graph"]
    + ["attn"] * 4,
    self_attn_combine_style="onebyone",
    cross_attn_block_style_list=["attn-graph", "attn-deform", "attn-deform_graph", "deform",
                                 "deform_graph", "graph", "attn", "attn"],
    cross_attn_combine_style="concat")
LOSS_TERMS = {"PoinTr": ("sparse", "dense"), "AdaPoinTr": ("denoised", "recon")}


def completion_batch(n, device):
    """(partial [n, 2048, 3], gt [n, 16384, 3]) on ``device``: ``Synthetic``
    clouds of 16384 points as the ground truth, and as the partial view the
    points left after cropping each cloud's 4096 nearest a random viewpoint,
    FPS-resampled to 2048 (``ops/corrupt.py::partial_point_cloud``)."""
    from upp_torch.data.synthetic import SyntheticDataset
    from upp_torch.ops.corrupt import partial_point_cloud
    from upp_torch.utils.config import ConfigDict
    ds = SyntheticDataset(ConfigDict(N_POINTS=N_GT, NUM_CATEGORY=6, SIZE=n, subset="train"))
    gt = torch.from_numpy(np.stack([ds[i][2][0] for i in range(n)]).astype(np.float32))
    gt = gt.to(device)
    with torch.no_grad():
        partial = partial_point_cloud(gt, N_GT // 4, N_PARTIAL,
                                      generator=torch.Generator(device=device).manual_seed(SEED))
    return partial.contiguous(), gt


def completion_model(cfg, device):
    """The model of ``cfg`` with seeded weights, made on the CPU and moved."""
    from upp_torch.models import build_model_from_cfg
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        model = build_model_from_cfg(cfg)
    return model.to(device)


def completion_setup(cfg, device):
    """(model, train step): ``step(partial, gt, noise=None)`` runs the model
    in train mode, ``get_loss``, the backward of the two terms' sum and
    AdamW (lr 5e-4, weight decay 5e-4) over every parameter, and returns the
    terms; AdaPoinTr's denoise noise is ``noise`` or a draw from a seeded
    generator. ``step.shapes`` holds the last forward's output shapes."""
    model = completion_model(cfg, device)
    optimizer = torch.optim.AdamW(model.parameters(), lr=5e-4, weight_decay=5e-4)
    gen = torch.Generator(device=device).manual_seed(SEED + 9)
    ada = cfg["NAME"] == "AdaPoinTr"

    def step(partial, gt, noise=None):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        kw = {}
        if ada:
            kw = {"denoise_noise": noise} if noise is not None else {"generator": gen}
        out = model(partial, **kw)
        step.shapes = [tuple(o.shape) for o in out]
        terms = model.get_loss(out, gt)
        (terms[0] + terms[1]).backward()
        optimizer.step()
        return dict(zip(LOSS_TERMS[cfg["NAME"]], (t.detach() for t in terms)))

    return model, step


def phase_completion(name, cfg, comp, card, device, eval_want, train_want, eval_shapes,
                     train_shapes):
    """The eval forward at batch 48 (launch counts, output shapes, finite,
    ms), then ``phase_train``: 3 train steps, launch counts of one, finite
    loss terms, every parameter with a gradient changed and the others
    bit-unchanged, ms per step, clouds/s, peak, a profile. Returns the
    launch counts of one train step."""
    partial, gt = comp
    model, step = completion_setup(cfg, device)
    model.eval()

    @torch.inference_mode()
    def evaluate():
        return model(partial)

    reset_counts()
    with Recorder() as rec:
        out = evaluate()
        torch.cuda.synchronize()
    eval_counts = check_calls(f"{name} eval", rec, eval_want)
    if [tuple(o.shape) for o in out] != eval_shapes or not all(torch.isfinite(o).all()
                                                                 for o in out):
        raise AssertionError(f"{name} eval: outputs {[tuple(o.shape) for o in out]} "
                             f"(want {eval_shapes}) or not finite")
    eval_ms = cuda_ms(evaluate, reps=5, warmup=1)
    print(f"[{name} eval] launches {eval_counts}; outputs {[tuple(o.shape) for o in out]}, "
          f"finite; {eval_ms:.2f} ms/batch, {B_COMP / eval_ms * 1e3:.1f} clouds/s "
          f"(B={B_COMP}; {card})", flush=True)
    counts = phase_train(f"{name} train", step, model, (partial, gt), card, train_want, B_COMP)
    if step.shapes != train_shapes:
        raise AssertionError(f"{name} train: outputs {step.shapes}, want {train_shapes}")
    print(f"[{name} train] train-mode outputs {step.shapes}", flush=True)
    return counts


def phase_adapointr_fold(comp, card, device):
    """The fold decoder (``decoder_type: fold``, 64 points a query) at the
    PCN width, batch 16: one train step, whose loss takes each denoise
    centre's 64 nearest ground-truth points through the kNN kernel's
    two-keys-a-lane instance; its launch counts and finite terms. Then
    ``get_loss`` of a small fold model on the card and on the CPU on the
    same outputs and ground truth: both terms within rtol 1e-4."""
    cfg = {**ADAPOINTR_PCN, "decoder_type": "fold"}
    model, step = completion_setup(cfg, device)
    partial, gt = comp[0][:B_STYLES], comp[1][:B_STYLES]
    reset_counts()
    with Recorder() as rec:
        terms = step(partial, gt)
        torch.cuda.synchronize()
    counts = check_calls("adapointr fold", rec, ADA_FOLD_CALLS)
    vals = {k: float(v) for k, v in terms.items()}
    if not all(np.isfinite(v) for v in vals.values()):
        raise AssertionError(f"adapointr fold: loss terms not finite: {vals}")
    fold_ms = cuda_ms(lambda: step(partial, gt), reps=3, warmup=1)
    small = {"NAME": "AdaPoinTr", "num_query": 8, "decoder_type": "fold",
             "encoder_config": {"embed_dim": 48, "depth": 1},
             "decoder_config": {"embed_dim": 48, "depth": 1}}
    gen = torch.Generator().manual_seed(SEED)
    ret = tuple(torch.randn((2, n, 3), generator=gen) for n in (8, 4, 4 * 64, 8 * 64))
    cloud = torch.randn((2, 1024, 3), generator=gen)
    with torch.no_grad():
        got = completion_model(small, device).get_loss(tuple(r.to(device) for r in ret),
                                                       cloud.to(device))
        want = completion_model(small, torch.device("cpu")).get_loss(ret, cloud)
    for g, w in zip(got, want):
        if not torch.allclose(g.cpu(), w, rtol=1e-4, atol=0.0):
            raise AssertionError(f"adapointr fold get_loss card vs CPU: {got} vs {want}")
    print(f"[adapointr fold] train step at batch {B_STYLES}: launches {counts}, k=64 loss kNN "
          f"{rec.calls[('knn', 64, N_GT, 64, False)]} call; terms "
          + ", ".join(f"{k} {v:.4f}" for k, v in vals.items())
          + f"; {fold_ms:.2f} ms/step; get_loss card {[float(g) for g in got]}, cpu "
          f"{[float(w) for w in want]} (rtol 1e-4) ({card})", flush=True)


def phase_adapointr_styles(comp, card, device):
    """AdaPoinTr at full width with every local block style, one train step
    at batch 16: finite loss terms, the three kernels launched, and a
    nonzero gradient in every deform block's offset MLP."""
    from upp_torch.models.deform_attn import (DeformableGraphAttention,
                                              DeformableLocalAttention,
                                              DeformableLocalCrossAttention)
    partial, gt = (t[:B_STYLES] for t in comp)
    model, step = completion_setup(ADAPOINTR_STYLES, device)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with Recorder() as rec:
        terms = step(partial, gt)
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    vals = {k: float(v) for k, v in terms.items()}
    if (not all(np.isfinite(v) for v in vals.values())
            or min(counts[k] for k in ("fps", "knn", "chamfer")) < 1):
        raise AssertionError(f"adapointr styles: terms {vals}, launches {counts}")
    deform = [(n, m) for n, m in model.named_modules() if isinstance(
        m, (DeformableLocalAttention, DeformableLocalCrossAttention, DeformableGraphAttention))]
    norms = {}
    for n, m in deform:
        mlp = (m.linear_offset if isinstance(m, DeformableGraphAttention)
               else m.resample.linear_offset)
        for pn, p in mlp.named_parameters():
            if p.grad is None or not float(p.grad.norm()) > 0.0:
                raise AssertionError(f"adapointr styles: no gradient in {n} offset MLP {pn}")
        norms[n] = float(torch.sqrt(sum((p.grad ** 2).sum() for p in mlp.parameters())))
    if len(deform) != 9:
        raise AssertionError(f"adapointr styles: {len(deform)} deform blocks, want 9")
    print(f"[adapointr styles] encoder {ADAPOINTR_STYLES['encoder_config']['block_style_list']} "
          f"(concat), decoder self "
          f"{ADAPOINTR_STYLES['decoder_config']['self_attn_block_style_list']} (onebyone), "
          f"cross {ADAPOINTR_STYLES['decoder_config']['cross_attn_block_style_list']} "
          f"(concat): one train step, terms {vals}, launches {counts}, kernel calls "
          f"{dict(rec.calls)}, {ms:.1f} ms of host time with its first-call costs, peak "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; offset-MLP gradient norms "
          + ", ".join(f"{n} {v:.3g}" for n, v in norms.items())
          + f" (B={B_STYLES}; {card})", flush=True)


def _align_queries(card_out, cpu_out, per_query):
    """AdaPoinTr's eval outputs (coarse [B, Q, 3], rebuild [B, Q*r, 3]) of
    the card with the CPU's rows put in the card's query order: the query
    ranking's stable sort may order two near-equal ranks differently on the
    two devices. Each card centre takes the nearest CPU centre, which must
    make a permutation. Returns (aligned CPU outputs, queries moved)."""
    coarse_c, _ = card_out
    coarse_h, rebuild_h = cpu_out
    perm = torch.cdist(coarse_c.double(), coarse_h.double()).argmin(-1)      # [B, Q]
    if not all(torch.equal(p.sort().values, torch.arange(p.numel())) for p in perm):
        raise AssertionError("completion card vs CPU: the kept queries differ")
    bsz, q = perm.shape
    coarse = torch.gather(coarse_h, 1, perm[..., None].expand(-1, -1, 3))
    rebuild = torch.gather(rebuild_h.reshape(bsz, q, per_query, 3), 1,
                           perm[..., None, None].expand(-1, -1, per_query, 3))
    moved = int((perm != torch.arange(q)).sum())
    return (coarse, rebuild.reshape(bsz, -1, 3)), moved


def phase_completion_card_vs_cpu(comp, card, device):
    """Both models at batch 4 on the card and on the CPU from the same
    weights, inputs and denoise draw (drawn on the CPU): eval outputs
    within rtol 1e-3 / atol 2e-3, train-mode loss terms within rtol 1e-3 /
    atol 2e-3, the gradients' global norm within rtol 1e-2."""
    partial, gt = (t[:B_COMP_CPU].cpu() for t in comp)
    noise = torch.randn((B_COMP_CPU, 64, 3), generator=torch.Generator().manual_seed(SEED + 11))
    for cfg in (POINTR_PCN, ADAPOINTR_PCN):
        name = cfg["NAME"]
        results = []
        for dev in (device, torch.device("cpu")):
            model = completion_model(cfg, dev).eval()
            with torch.inference_mode():
                ev = [o.cpu() for o in model(partial.to(dev))]
            model.train()
            kw = {"denoise_noise": noise.to(dev)} if name == "AdaPoinTr" else {}
            terms = model.get_loss(model(partial.to(dev), **kw), gt.to(dev))
            (terms[0] + terms[1]).backward()
            gnorm = torch.sqrt(sum((p.grad.double() ** 2).sum() for p in model.parameters()
                                   if p.grad is not None))
            results.append((ev, [float(t.detach()) for t in terms], float(gnorm)))
        (ev_c, t_c, g_c), (ev_h, t_h, g_h) = results
        moved = 0
        if name == "AdaPoinTr":
            ev_h, moved = _align_queries(ev_c, ev_h,
                                         int(cfg["num_points"]) // int(cfg["num_query"]))
        diff = max((a - b).abs().max().item() for a, b in zip(ev_c, ev_h))
        if not all(a.shape == b.shape and torch.allclose(a, b, rtol=1e-3, atol=2e-3)
                   for a, b in zip(ev_c, ev_h)):
            raise AssertionError(f"{name} card vs CPU: eval outputs differ by {diff}")
        if not np.allclose(t_c, t_h, rtol=1e-3, atol=2e-3):
            raise AssertionError(f"{name} card vs CPU: loss terms {t_c} vs {t_h}")
        if not np.isclose(g_c, g_h, rtol=1e-2, atol=0.0):
            raise AssertionError(f"{name} card vs CPU: grad norm {g_c} vs {g_h}")
        print(f"[completion card vs cpu] {name} B={B_COMP_CPU}: eval max |diff| {diff:.3g} "
              f"(rtol 1e-3, atol 2e-3; {moved} queries ranked in another order); loss terms "
              f"card {t_c}, cpu {t_h} (rtol 1e-3, atol 2e-3); grad norm card {g_c:.6g}, cpu "
              f"{g_h:.6g} (rtol 1e-2) ({card})", flush=True)


def phase_emd(card, device):
    """EMD card vs CPU at (4, 1024, 1024): the per-cloud costs within rtol
    1e-4, the gradients of a weighted sum within 1e-2 of the largest
    element (the exp(level * d) of the sharpest rounds magnifies the
    devices' last-bit differences in d), ``Metrics.get(require_emd=True)``
    within rtol 1e-4; then the plain version's time on the card."""
    from upp_torch.ops.emd import earth_mover_distance
    from upp_torch.train.metrics import Metrics
    gen = torch.Generator().manual_seed(SEED + 12)
    a = torch.randn((4, 1024, 3), generator=gen)
    b = torch.randn((4, 1024, 3), generator=gen)
    w = torch.rand((4,), generator=gen)
    res = []
    for dev in (device, torch.device("cpu")):
        x, y = a.to(dev).requires_grad_(True), b.to(dev).requires_grad_(True)
        cost = earth_mover_distance(x, y, reduce_mean=False)
        (cost * w.to(dev)).sum().backward()
        res.append((cost.detach().cpu(), x.grad.cpu(), y.grad.cpu(),
                    Metrics.get(a.to(dev) * 0.1, b.to(dev) * 0.1, require_emd=True)))
    (c_c, gx_c, gy_c, m_c), (c_h, gx_h, gy_h, m_h) = res
    if not torch.allclose(c_c, c_h, rtol=1e-4, atol=0.0):
        raise AssertionError(f"EMD card vs CPU: costs {c_c} vs {c_h}")
    g_err = max((g - h).abs().max().item() / h.abs().max().item()
                for g, h in ((gx_c, gx_h), (gy_c, gy_h)))
    if g_err > 1e-2:
        raise AssertionError(f"EMD card vs CPU: gradients differ by {g_err} of the largest")
    if not np.allclose(m_c, m_h, rtol=1e-4, atol=0.0):
        raise AssertionError(f"EMD card vs CPU: Metrics.get {m_c} vs {m_h}")
    print(f"[emd card vs cpu] B=4, 1024 x 1024: costs max rel diff "
          f"{((c_c - c_h).abs() / c_h.abs()).max().item():.3g} (rtol 1e-4); gradients max "
          f"|diff| {g_err:.3g} of the largest (bound 1e-2); Metrics.get card {m_c}, cpu {m_h} "
          f"({card})", flush=True)
    for bsz, n in ((1, N_GT), (32, N_PARTIAL)):
        g = torch.Generator(device=device).manual_seed(SEED + 13)
        x = torch.randn((bsz, n, 3), generator=g, device=device)
        y = torch.randn((bsz, n, 3), generator=g, device=device)
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            fwd_ms = cuda_ms(lambda: earth_mover_distance(x, y), reps=3, warmup=1)
        xg = x.clone().requires_grad_(True)
        both_ms = cuda_ms(lambda: earth_mover_distance(xg, y).backward(), reps=3, warmup=1)
        print(f"[emd time] plain EMD ({bsz}, {n}, {n}): forward {fwd_ms:.2f} ms, forward + "
              f"backward {both_ms:.2f} ms, peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f}"
              f" GiB (CUDA events; {card})", flush=True)

# ---------------------------------------------------------------------------
# phases 33-40: bf16 block stacks (if_half), the legacy pretask model,
# AdapterSuper and the visualisation runner


def half_config(config):
    """A copy of ``config`` with the model's ``if_half: True``."""
    half = copy.deepcopy(config)
    half.model.if_half = True
    return half


def phase_half(name, setup, config, batch, card, device, want, bsz, graphed=False):
    """The bf16 train step of ``config`` with ``if_half`` as ``phase_train``
    (launch counts, changed and bit-unchanged tensors, with ``graphed`` a
    replayed step, ms, peak, profile),
    then the float32 and bf16 steps timed in turns in this process and the
    float32 one profiled: the bf16 step must run tensor-core GEMMs and spend
    less device time in float32 SIMT GEMMs. ``setup(config, device)`` gives
    (model, step). Returns the bf16 step's launch counts."""
    model16, step16 = setup(half_config(config), device)
    counts = phase_train(f"{name} bf16", step16, model16, batch, card, want, bsz, graphed)
    _, peak16, prof16 = phase_train.last
    model32, step32 = setup(config, device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step32(*batch)
    torch.cuda.synchronize()
    peak32 = torch.cuda.max_memory_allocated() / 2 ** 30
    times = {"f32": [], "bf16": []}
    for kind in ("f32", "bf16", "bf16", "f32"):
        step = step32 if kind == "f32" else step16
        times[kind].append(cuda_ms(lambda: step(*batch), reps=10, warmup=1))
    prof32 = profile_steps(lambda: step32(*batch), f"{name} f32", times["f32"][-1], card,
                           bsz=bsz)
    print(f"[{name} bf16 vs f32] ms/step in turns: f32 {times['f32'][0]:.2f}, bf16 "
          f"{times['bf16'][0]:.2f}, bf16 {times['bf16'][1]:.2f}, f32 {times['f32'][1]:.2f}; "
          f"peak bf16 {peak16:.2f} GiB, f32 {peak32:.2f} GiB (B={bsz}; {card})", flush=True)
    if prof16 and prof32:
        tc16, simt16 = prof16["gemm"]["tensor core"], prof16["gemm"]["simt"]
        simt32 = prof32["gemm"]["simt"]
        print(f"[{name} bf16 vs f32] device busy bf16 {prof16['busy']:.3f}, f32 "
              f"{prof32['busy']:.3f} ms/step; GEMMs bf16: tensor core {tc16:.3f}, SIMT "
              f"{simt16:.3f}; f32: SIMT {simt32:.3f} ms/step", flush=True)
        if tc16 <= 0.0 or simt16 >= simt32:
            raise AssertionError(f"{name} bf16: GEMMs {dict(prof16['gemm'])} against the f32 "
                                 f"step's {dict(prof32['gemm'])}")
    del model16, model32
    return counts


def phase_half_cls_logits(clouds, config, card, device):
    """The bf16 classifier's downstream-pass logits at batch 8 on the card
    and on the CPU, from the same weights and points: within 2e-2 of the
    largest logit (``tests/test_torch_port_half.py``'s bound)."""
    from upp_torch.ops.fps import fps
    from upp_torch.train.runner_cls import init_model
    args = types.SimpleNamespace(seed=SEED)
    with torch.inference_mode():
        points, _ = fps(clouds[:B_CPU], NPOINTS)
        card_l = init_model(args, config, device)(points).cpu()
        cpu_l = init_model(args, config, torch.device("cpu"))(points.cpu())
    diff, top = (card_l - cpu_l).abs().max().item(), cpu_l.abs().max().item()
    if not diff <= 2e-2 * top:
        raise AssertionError(f"cls bf16 card vs CPU: logits differ by {diff} (largest {top})")
    print(f"[cls bf16 card vs cpu] B={B_CPU}: downstream logits max |diff| {diff:.3g}, "
          f"{diff / top:.3g} of the largest (bound 2e-2) ({card})", flush=True)


def cls_passes(models, pts):
    """The noisy cls step's three passes of ``PointMAEUnify`` one by one,
    ``models["got"]`` against ``models["want"]`` (each a (model, device)),
    no gradient: rectify on ``pts``, completion on ``want``'s rectified
    cloud, downstream on ``want``'s re-sampled cloud, so that no pass
    inherits the previous pass's reordering. Returns ({output: (got, want)
    on the CPU}: the rectification vectors, the completion's centres and
    rebuild, the logits; {discrete choice: (differing, of)}: the rectify
    score sort's ranks, the points its top-5% drop drops on one side only,
    the completion's FPS picks of the rebuild and of the joined cloud)."""
    outs, counts = {}, {}
    with torch.no_grad():
        vec = {k: m.rectify_vectors(pts.to(d)) for k, (m, d) in models.items()}
        outs["rectify vectors"] = (vec["got"].cpu(), vec["want"].cpu())
        rect = {k: m.drop_noisiest(pts.to(d), vec[k], NPOINTS) for k, (m, d) in models.items()}
        order = {k: rect[k][1].cpu() for k in models}
        counts["rectify ranks"] = (int((order["got"] != order["want"]).sum()),
                                   order["want"].numel())
        keep = int(NPOINTS * 0.95)
        counts["rectify drop"] = (sum(len(set(a[:-keep].tolist()) - set(b[:-keep].tolist()))
                                      for a, b in zip(order["got"], order["want"])),
                                  (order["want"].shape[1] - keep) * order["want"].shape[0])
        cloud = rect["want"][0]
        comp = {k: m.complete_and_resample(cloud.to(d), NPOINTS)
                for k, (m, d) in models.items()}
        for name, got, want in zip(("completion centres", "rebuild"), comp["got"][1],
                                   comp["want"][1]):
            outs[name] = (got.cpu(), want.cpu())
        for name, got, want in zip(("fps picks of the rebuild", "fps picks of the cloud"),
                                   comp["got"][2], comp["want"][2]):
            if want is not None:
                counts[name] = (int((got.cpu() != want.cpu()).sum()), want.numel())
        cloud = comp["want"][0]
        logits = {k: m(cloud.to(d)) for k, (m, d) in models.items()}
        outs["downstream logits"] = (logits["got"].cpu(), logits["want"].cpu())
    return outs, counts


def _choices(counts):
    return ", ".join(f"{n} of {of} {name}" for name, (n, of) in counts.items())


def phase_half_cls_passes(clouds, config, card, device):
    """Phase 36b: the noisy bf16 cls PEFT step's three passes of
    ``PointMAEUnify`` one by one (``cls_passes``), on the card and on the
    CPU, both bf16 in train mode (dropout and drop-path off) from the same
    weights, at batch 8, the CPU's inputs handed across, on the
    CPU-corrupted clouds (phase 12's draws). Each pass's outputs within
    2e-2 of their largest (the bound of phase 36). Prints how many of the
    rectify sort's ranks, its top-5% drop and the completion's FPS picks
    differ between card and CPU. Returns the counts."""
    from upp_torch.train.pipeline import corrupt_batch
    from upp_torch.train.runner_cls import init_model
    args = types.SimpleNamespace(seed=SEED)
    half = half_config(config)
    cpu = torch.device("cpu")
    models = {k: (no_dropout(init_model(args, half, d)).train(), d)
              for k, d in (("got", device), ("want", cpu))}
    pts = corrupt_batch(clouds[:B_CPU].cpu(), npoints=NPOINTS, n_points_dataset=N_POINTS,
                        noisy_train=True, incomplete_cropping=True,
                        augmentation=half.get("data_augmentation"), draws=cpu_draws(B_CPU))
    outs, counts = cls_passes(models, pts)
    held = []
    for name, (got, want) in outs.items():
        diff, top = (got - want).abs().max().item(), want.abs().max().item()
        if not (np.isfinite(diff) and diff <= 2e-2 * top):
            raise AssertionError(f"cls bf16 passes card vs CPU: {name} differs by {diff} "
                                 f"(largest {top}) with its input handed across")
        held.append(f"{name} {diff / top:.3g}")
    print(f"[cls bf16 passes card vs cpu] B={B_CPU}, each pass on the CPU's input: "
          f"{', '.join(held)} of the largest (bound 2e-2); differing between card and CPU: "
          f"{_choices(counts)} ({card})", flush=True)
    return counts


def legacy_config(pretask_config):
    """The pretask config with the legacy model ``Point_MAE_pretask``."""
    legacy = copy.deepcopy(pretask_config)
    legacy.model.NAME = "Point_MAE_pretask"
    return legacy


def phase_legacy_cli(card):
    """``upp_torch.main`` trains ``Point_MAE_pretask`` for one epoch on a
    48-cloud synthetic split, batch 24, then ``--test --ckpts`` its
    ``ckpt-last.pth``: the TEST RESULTS table, no missing key."""
    import glob
    import yaml
    from upp_torch.main import main as upp_main
    cfg = yaml.safe_load(open(PRETASK_CFG))
    cfg["model"]["NAME"] = "Point_MAE_pretask"
    for split in ("train", "val", "test"):
        cfg["dataset"][split]["_base_"] = {"NAME": "Synthetic", "N_POINTS": N_POINTS,
                                           "NUM_CATEGORY": 6, "SIZE": CLI_CLOUDS}
    cfg.update(total_bs=CLI_BS, max_epoch=0)
    os.makedirs(CLI_DIR, exist_ok=True)
    paths = {}
    for name in ("legacy_cli_train", "legacy_cli_test"):
        paths[name] = os.path.join(CLI_DIR, f"{name}.yaml")
        with open(paths[name], "w") as f:
            yaml.safe_dump(cfg, f)
    t0 = time.time()
    best = upp_main(["--config", paths["legacy_cli_train"], "--exp_name", "chip_smoke"])
    train_s = time.time() - t0
    last = sorted(glob.glob("experiments/legacy_cli_train/**/ckpt-last.pth", recursive=True))[-1]
    saved = torch.load(last, map_location="cpu", weights_only=True)["base_model"]
    if not any(k.startswith("mask_prompter.") for k in saved) or not np.isfinite(best.cd):
        raise AssertionError(f"legacy CLI: cd {best.cd}, keys {sorted(saved)[:5]}")
    t0 = time.time()
    cd = upp_main(["--test", "--config", paths["legacy_cli_test"], "--ckpts", last,
                   "--exp_name", "chip_smoke"])
    test_s = time.time() - t0
    log = open(sorted(glob.glob("experiments/legacy_cli_test/**/legacy_cli_test.log",
                                recursive=True))[-1]).read()
    if "TEST RESULTS" not in log or "missing_keys" in log or not np.isfinite(cd.cd):
        raise AssertionError(f"legacy CLI test: log tail {log[-2000:]}")
    print(f"[legacy cli] {CLI_CLOUDS} clouds, batch {CLI_BS}, one epoch: best CD {best.cd:.4f}, "
          f"{train_s:.1f} s; --test --ckpts ckpt-last.pth: CD {cd.cd:.4f}, {test_s:.1f} s "
          f"({card})", flush=True)


def phase_tools(clouds, card, device):
    """``AdapterSuper``/``AdapterSuperF`` at width 384 on the card against
    the CPU (rtol 1e-4, atol 1e-5), with and without ``sample_embed_dim``;
    ``runner_vis.test_net`` with 2 items on the card and on the CPU, from
    the same seeded ``Point_MAE``: equal saved clouds (FPS outputs)."""
    from upp_torch.models.adapter_super import AdapterSuper, AdapterSuperF
    from upp_torch.train import runner_vis
    from upp_torch.utils.config import ConfigDict, cfg_from_yaml_file
    x = clouds[:8, :65].repeat(1, 1, 128)             # [8, 65, 384]
    for cls in (AdapterSuper, AdapterSuperF):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(SEED)
            mod = cls(384, 64).eval()
        for sample in (None, 16):
            with torch.no_grad():
                got = copy.deepcopy(mod).to(device)(x, sample_embed_dim=sample).cpu()
                want = mod(x.cpu(), sample_embed_dim=sample)
            if not torch.allclose(got, want, rtol=1e-4, atol=1e-5):
                raise AssertionError(f"{cls.__name__} card vs CPU: {(got - want).abs().max()}")
        print(f"[adapter super] {cls.__name__} (384, 64) on [8, 65, 384]: card vs CPU within "
              f"rtol 1e-4, atol 1e-5, with all and with 16 bottleneck channels ({card})",
              flush=True)
    pre = cfg_from_yaml_file(PRETRAIN_CFG)
    config = ConfigDict.from_nested({
        "model": pre.model, "npoints": NPOINTS,
        "dataset": {"test": {"_base_": {"NAME": "Synthetic", "N_POINTS": N_POINTS,
                                        "NUM_CATEGORY": 6, "SIZE": 2},
                             "others": {"subset": "test"}}}})
    dirs = {}
    for dev in ("cuda", "cpu"):
        dirs[dev] = os.path.join(CLI_DIR, f"vis_{dev}")
        args = types.SimpleNamespace(seed=SEED, ckpts=None, device=dev,
                                     experiment_path=dirs[dev], log_name="chip_smoke_vis")
        if runner_vis.test_net(args, config, max_items=2) != 2:
            raise AssertionError(f"runner_vis on {dev}: not 2 items")
    for i in range(2):
        a, b = (np.load(os.path.join(dirs[d], "vis", f"input-{i:03d}.npy")) for d in dirs)
        if a.shape != (NPOINTS, 3) or not np.array_equal(a, b):
            raise AssertionError(f"runner_vis: item {i} differs between card and CPU")
    print(f"[runner vis] test_net, 2 items: the card's input-000/001.npy ({NPOINTS} points) "
          f"equal the CPU's ({card})", flush=True)


# ---------------------------------------------------------------------------
# phases 41-45: patch denoising (FPS past 16384 points, the large-k kNN),
# the profiling tools, remat_blocks and the asynchronous checkpoint writer

# FPS variant 6 (csrc/fps.cu, a cluster of 16 blocks a cloud) at the patch
# denoiser's shapes (utils/denoise.py, the PU-Net test clouds of 10K and 50K
# points: seeds N -> 3N/1000, re-sampling 3N -> N), at 16385 and at its limit
DENOISE_FPS_CALLS = (("fps", 16385, 512, False), ("fps", 50000, 150, False),
                     ("fps", 150000, 50000, False), ("fps", 30000, 10000, False),
                     ("fps", 10000, 30, False), ("fps", 20000, 256, True),
                     ("fps", 262144, 256, False))
# the large-k kNN (csrc/knn_select.cu): the denoiser's patches at 50K and 10K
# points, k = 65 past the small kernel at N = 16385, k = 1024, an N past one
# SM's shared memory, and the kernel's limits
DENOISE_KNN_CALLS = ((1, 150, 50000, 1000), (1, 30, 10000, 1000), (4, 64, 16385, 65),
                     (2, 8, 2048, 1024), (1, 4, 100000, 500), (1, 4, 2 ** 20, 1024))
# the shapes at which every query of a coarse tie cloud must take the
# kernel's overflow path (more keys in the boundary bin than its candidates)
DENOISE_KNN_OVERFLOW = ((1, 150, 50000, 1000), (1, 30, 10000, 1000), (1, 4, 100000, 500),
                        (1, 4, 2 ** 20, 1024))
DENOISE_50K = Counter({("fps", 50000, 150, False): 1, ("fps", 150000, 50000, False): 1,
                       ("knn_select", 150, 50000, 1000): 1})
DENOISE_10K = Counter({("fps", 10000, 30, False): 1, ("fps", 30000, 10000, False): 1,
                       ("knn_select", 30, 10000, 1000): 1})


class AffineDenoiser:
    """The stand-in for a score-based denoiser (the repo has no denoiser
    network): every patch point moves to ``0.9 p + 0.01``."""

    def denoise_langevin_dynamics(self, patches, step_size, denoise_knn, step_decay,
                                  num_steps):
        return patches * 0.9 + 0.01


def scan_cloud(n, seed, device):
    """[n, 3]: points on the unit sphere with N(0, 0.01^2) noise (a noisy
    scan of a surface, as the PU-Net test clouds are)."""
    rng = np.random.default_rng(seed)
    p = rng.standard_normal((n, 3))
    p /= np.linalg.norm(p, axis=1, keepdims=True)
    return torch.from_numpy((p + 0.01 * rng.standard_normal((n, 3))).astype(np.float32)
                            ).to(device)


def patch_cloud(n, seed, device):
    """[1, 3n, 3]: the re-sampling FPS's input of ``patch_based_denoise`` on
    ``scan_cloud(n, seed)`` with the affine stand-in: its 3n / 1000 seeds'
    patches of 1000 nearest points, end to end (the port's FPS and kNN on
    the card build it, as the path does)."""
    from upp_torch.ops.knn import knn_points
    from upp_torch.utils.denoise import farthest_point_sampling
    pcl = scan_cloud(n, seed, device)[None]
    seeds, _ = farthest_point_sampling(pcl, 3 * n // 1000)
    _, _, patches = knn_points(seeds, pcl, 1000)
    den = AffineDenoiser().denoise_langevin_dynamics(patches[0], 0.2, 4, 0.95, 30)
    return den.reshape(1, -1, 3).contiguous()


def phase_denoise_kernels(card):
    """Phase 41: FPS variant 6 and the large-k kNN against their plain
    versions on the card at the denoise shapes (batch 1 unless given): the
    re-sampling FPS calls (3N -> N) on the patch layout the denoiser gives
    them (``patch_cloud``), the others on noisy-sphere clouds, the
    150000-point call also on the same cloud in random order, and tie-heavy
    grid clouds. FPS indices equal, each call's instance of variant 6, µs a
    round and the share of warp-rounds that skipped their points; kNN
    indices equal, distances bit-equal, the gathered xyz equal, also on
    coarse tie clouds, whose queries must take the kernel's overflow path
    at ``DENOISE_KNN_OVERFLOW``'s shapes. Kernel (events and profiler),
    plain and ``torch.cdist`` + ``topk`` ms. Then every FPS variant must
    have run over phases 2 and 41. Returns per-shape rows (of the path's
    layouts)."""
    from upp_torch.ops import fps_cuda, knn_cuda
    from upp_torch.ops.geometry import index_points
    from upp_torch.ops.knn import knn_plain, knn_points
    gen = torch.Generator(device="cuda").manual_seed(SEED + 41)
    rows = []
    cases = [("patches", call, patch_cloud(call[1] // 3, i, "cuda")) if call[1] == 3 * call[2]
             else ("", call, scan_cloud(call[1], i, "cuda")[None].contiguous())
             for i, call in enumerate(DENOISE_FPS_CALLS)]
    cases.append(("random order", ("fps", 150000, 50000, False),
                  scan_cloud(150000, len(cases), "cuda")[None].contiguous()))
    cases.append(("ties", ("fps", 60000, 6000, False), tie_clouds(1, 60000, gen)))
    for kind, call, cloud in cases:
        if fps_cuda.variant(call[1]) != 6 and call[1] > 16384:
            raise AssertionError(f"FPS at N={call[1]}: variant {fps_cuda.variant(call[1])}")
        masks = fps_masks(cloud, gen) if call[3] else (None, None)
        err, ms, plain_ms = _check_fps(call, cloud, gen, reps=3 if call[2] > 5000 else 10,
                                       plain_reps=1, masks=masks)
        nbytes, ops = bound_parts(call, 1)
        if kind != "random order":    # the path's layouts (and the ties') give the rows
            rows.append({"call": list(call), "batch": 1, "max_abs_err": err, "ms": ms,
                         "plain_ms": plain_ms, "library_ms": None, "bytes": nbytes, "ops": ops})
        skip = ""
        if call[1] > fps_cuda.MAX_BLOCK_N:
            idx, skipped, total = fps_cuda.cluster_skip_stats(cloud, call[2], *masks)
            if not torch.equal(idx, fps_cuda.fps_idx(cloud, call[2], *masks)):
                raise AssertionError(f"FPS {call} {kind}: the counting launch's indices differ")
            p, w, regs = fps_cuda.cluster_shape(call[1])
            skip = (f", P={p} in {w} warps a block, x y z in "
                    f"{'registers' if regs else 'shared memory'}, {skipped} of {total} "
                    f"warp-rounds skipped ({skipped / max(total, 1):.4f})")
        print(f"[denoise kernel{' ' + kind if kind else ''}] {call}: identical to plain, "
              f"variant {fps_cuda.variant(call[1])}{skip}, kernel {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms, {ms / max(call[2] - 1, 1) * 1e3:.3f} us a round, bound "
              f"{bound_ms(nbytes, ops):.4f} ms (B=1; {card})", flush=True)
    for i, (bsz, s, n, k) in enumerate(DENOISE_KNN_CALLS):
        clusters, threads = knn_cuda.select_plan(bsz * s, n)
        for kind in ("", "ties", "coarse ties"):
            if kind == "ties":
                points = tie_clouds(bsz, n, gen)
            elif kind:
                points = coarse_tie_clouds(bsz, n, gen)
            else:
                points = torch.stack([scan_cloud(n, 100 + 10 * i + b, "cuda") for b in range(bsz)])
            query = points[:, :s].contiguous()
            kd, ki = knn_cuda.knn_select(query, points, k)
            pd, pi = knn_plain(query, points, k)
            gd, gi, gn = knn_points(query, points, k)
            sd, si, stats = knn_cuda.select_stats(query, points, k)
            torch.cuda.synchronize()
            if not (torch.equal(ki.long(), pi) and torch.equal(kd, pd)):
                raise AssertionError(f"knn_select {(bsz, s, n, k)} {kind}: "
                                     f"{int((ki.long() != pi).sum())} indices differ, distances "
                                     f"{(kd - pd).abs().max().item()} apart")
            if not (torch.equal(gi, pi) and torch.equal(gn, index_points(points, pi))):
                raise AssertionError(f"knn_points {(bsz, s, n, k)} {kind}: gather differs")
            if not (torch.equal(si, ki) and torch.equal(sd, kd)):
                raise AssertionError(f"knn_select {(bsz, s, n, k)} {kind}: the counting "
                                     f"launch's outputs differ")
            refined = int((stats[:, 1] > 0).sum())
            if kind == "coarse ties" and (bsz, s, n, k) in DENOISE_KNN_OVERFLOW and \
                    refined != bsz * s:
                raise AssertionError(f"knn_select {(bsz, s, n, k)} coarse ties: {refined} of "
                                     f"{bsz * s} queries took the overflow path")
            ms = cuda_ms(lambda: knn_cuda.knn_select(query, points, k), reps=20)
            us = kernel_device_us(lambda: knn_cuda.knn_select(query, points, k),
                                  "knn_select_kernel")
            plain_ms = cuda_ms(lambda: knn_plain(query, points, k), reps=3)
            lib_ms = cuda_ms(lambda: torch.topk(torch.cdist(query, points).square(), k,
                                                largest=False), reps=10)
            call = ("knn", s, n, k, False)
            nbytes, ops = bound_parts(call, bsz)
            if not kind:
                rows.append({"call": ["knn_select", s, n, k], "batch": bsz, "max_abs_err": 0.0,
                             "ms": ms, "device_us": us, "plain_ms": plain_ms,
                             "library_ms": lib_ms, "bytes": nbytes, "ops": ops})
            print(f"[denoise kernel{' ' + kind if kind else ''}] knn_select (B={bsz}, S={s}, "
                  f"N={n}, k={k}): identical to plain, distances bit-equal, gather equal, "
                  f"C={clusters} blocks of {threads} threads a query; boundary bin after pass 1 "
                  f"up to {int(stats[:, 0].max())} keys against {knn_cuda.SELECT_CANDIDATES} "
                  f"candidates, {refined} of {bsz * s} queries refined (up to "
                  f"{int(stats[:, 1].max())} passes); kernel {ms:.4f} ms (events), {us:.1f} us "
                  f"(device), plain {plain_ms:.3f} ms, cdist + topk {lib_ms:.3f} ms, bound "
                  f"{bound_ms(nbytes, ops):.4f} ms ({card})", flush=True)
    variants = sorted({fps_cuda.variant(n) for n in FPS_N_RUN})
    print(f"[kernel variants] FPS variants run in phases 2 and 41: {variants}", flush=True)
    if variants != list(range(fps_cuda.num_variants())):
        raise AssertionError(f"FPS variants run {variants}, of {fps_cuda.num_variants()}")
    # variant 6's three instances (csrc/fps.cu kClusterShapes; the CPU tests
    # hold the count): (points a thread, x y z in registers)
    instances = sorted({fps_cuda.cluster_shape(n)[::2] for n in FPS_N_RUN
                        if n > fps_cuda.MAX_BLOCK_N})
    print(f"[kernel variants] FPS variant 6 instances run: {instances}", flush=True)
    if len(instances) != 3:
        raise AssertionError(f"FPS variant 6 instances run {instances}, of 3")
    return rows


def phase_denoise(card, device):
    """Phase 42: ``patch_based_denoise`` with the affine stand-in on the
    card at N = 50000 and 10000 (the defaults: patch 1000, seed_k 3), each
    run a path run (counts reset before it, read after; FPS and the large-k
    kNN must launch); each of its four steps timed alone; the 10000-point
    output bit-equal to the port's CPU run. Returns the 50K run's counts."""
    from upp_torch.ops.knn import knn_points
    from upp_torch.utils.denoise import farthest_point_sampling, patch_based_denoise
    stub = AffineDenoiser()
    counts = {}
    for n, want in ((50000, DENOISE_50K), (10000, DENOISE_10K)):
        pcl = scan_cloud(n, n, device)
        reset_counts()
        with Recorder() as rec:
            out = patch_based_denoise(stub, pcl)
            torch.cuda.synchronize()
        counts[n] = check_calls(f"denoise {n}", rec, want)
        if out.shape != (n, 3) or not torch.isfinite(out).all():
            raise AssertionError(f"denoise {n}: output {tuple(out.shape)}")
        seeds, _ = farthest_point_sampling(pcl[None], 3 * n // 1000)
        _, _, patches = knn_points(seeds, pcl[None], 1000)
        den = stub.denoise_langevin_dynamics(patches[0], 0.2, 4, 0.95, 30)
        flat = den.reshape(1, -1, 3).contiguous()
        steps = {"seed fps": lambda: farthest_point_sampling(pcl[None], 3 * n // 1000),
                 "patch knn": lambda: knn_points(seeds, pcl[None], 1000),
                 "denoiser (stand-in)": lambda: stub.denoise_langevin_dynamics(
                     patches[0], 0.2, 4, 0.95, 30),
                 "re-sampling fps": lambda: farthest_point_sampling(flat, n)}
        ms = {k: cuda_ms(f, reps=3, warmup=1) for k, f in steps.items()}
        total = cuda_ms(lambda: patch_based_denoise(stub, pcl), reps=3, warmup=1)
        extra = ""
        if n == 10000:
            cpu_out = patch_based_denoise(stub, pcl.cpu())
            if not torch.equal(out.cpu(), cpu_out):
                raise AssertionError(f"denoise {n}: card and CPU differ by "
                                     f"{(out.cpu() - cpu_out).abs().max().item()}")
            extra = "; equal to the CPU's bit for bit"
        print(f"[denoise] N={n}: launches {counts[n]}; {total:.2f} ms a cloud; steps "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items()) + f"{extra} ({card})",
              flush=True)
    return counts[50000]


def phase_profiling(config, card):
    """Phase 43: ``profile_train_step`` on the cls config at batch 120 with
    the deep rows, and a ``maybe_trace`` of one annotated PEFT step whose
    trace must hold the ``annotate`` ranges."""
    import glob
    from upp_torch.train.runner_cls import PEFT_LIST
    from upp_torch.utils.profiling import annotate, maybe_trace, profile_train_step
    t0 = time.time()
    rows = profile_train_step(CFG, iters=5, batch_size=B, deep=True)
    print(f"[profiling] profile_train_step({CFG}, batch {B}, --deep): "
          + ", ".join(f"{k.strip()} {v:.2f} ms" for k, v in rows.items())
          + f"; {time.time() - t0:.1f} s ({card})", flush=True)
    if len(rows) != 8 or not rows["full train step"] > 0:
        raise AssertionError(f"profile_train_step: rows {rows}")
    _, _, step = cls_train_setup(config, torch.device("cuda"), PEFT_LIST)
    clouds = torch.from_numpy(synthetic_clouds(B)[0]).cuda()
    labels = torch.zeros(B, dtype=torch.long, device="cuda")
    step(clouds, labels)
    trace_dir = os.path.join(CLI_DIR, "trace")
    with maybe_trace(trace_dir):
        with annotate("cls train step"):
            with annotate("step body"):
                step(clouds, labels)
            torch.cuda.synchronize()
    files = sorted(glob.glob(os.path.join(trace_dir, "trace-*.json")))
    names = {e.get("name") for e in json.load(open(files[-1]))["traceEvents"]} if files else set()
    if not {"cls train step", "step body"} <= names:
        raise AssertionError(f"maybe_trace: {files}, no annotate ranges in the trace")
    kernels = sum(1 for n in names if n and ("fps_kernel" in n or "knn_kernel" in n))
    print(f"[profiling] maybe_trace: {os.path.basename(files[-1])}, "
          f"{os.path.getsize(files[-1]) / 2 ** 20:.1f} MiB, with the two annotate ranges and "
          f"{kernels} FPS/kNN kernel names ({card})", flush=True)


def phase_remat(config, card, device):
    """Phase 44: the cls PEFT step at batch 120, float32 and bf16, with and
    without ``remat_blocks``, from the same weights and draws, under
    ``torch.use_deterministic_algorithms`` (warn only): gradients, the
    parameters after the step and BatchNorm buffers bit-equal with and
    without remat; ms per step and peak memory of each."""
    from upp_torch.train.runner_cls import PEFT_LIST
    clouds = torch.from_numpy(synthetic_clouds(B)[0]).to(device)
    labels = torch.from_numpy(synthetic_clouds(B)[1]).to(device)
    report = []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for kind, cfg in (("f32", config), ("bf16", half_config(config))):
            results = {}
            for remat in (False, True):
                c = copy.deepcopy(cfg)
                c.model.remat_blocks = remat
                model, _, step = cls_train_setup(c, device, PEFT_LIST)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                step(clouds, labels)
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
                grads = {n: p.grad.clone() for n, p in model.named_parameters()
                         if p.grad is not None}
                state = {k: v.clone() for k, v in model.state_dict().items()}
                ms = cuda_ms(lambda: step(clouds, labels), reps=5, warmup=1)
                results[remat] = (grads, state, peak, ms)
                del model, step
            (g0, s0, p0, t0), (g1, s1, p1, t1) = results[False], results[True]
            bad = [k for k in g0 if not torch.equal(g0[k], g1[k])]
            bad += [k for k in s0 if not torch.equal(s0[k], s1[k])]
            if bad or g0.keys() != g1.keys():
                raise AssertionError(f"remat {kind}: {len(bad)} tensors differ, {bad[:5]}")
            report.append(f"{kind}: {t0:.2f} -> {t1:.2f} ms/step, peak {p0:.2f} -> {p1:.2f} GiB")
    finally:
        torch.use_deterministic_algorithms(False)
    print(f"[remat] cls PEFT step, B={B}, without -> with remat_blocks: {'; '.join(report)}; "
          f"gradients, parameters and BatchNorm buffers bit-equal ({card})", flush=True)


def phase_async_checkpoints(config, card, device):
    """Phase 45: ``save_checkpoint`` of the flagship classifier after an
    AdamW step, with ``block=True`` (the write) and ``block=False`` (the
    time the training thread waits: the snapshot on the card), then
    ``wait_for_pending_saves``; the two files hold equal tensors."""
    from upp_torch.train import checkpoint as ckpt
    from upp_torch.train.runner_cls import PEFT_LIST
    model, optimizer, step = cls_train_setup(config, device, PEFT_LIST)
    clouds = torch.from_numpy(synthetic_clouds(B)[0]).to(device)
    step(clouds, torch.zeros(B, dtype=torch.long, device=device))
    out_dir = os.path.join(CLI_DIR, "ckpt_async")
    times = {}
    for block in (True, False, True, False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.save_checkpoint(model, optimizer, 1, f"ckpt-{'sync' if block else 'async'}",
                             out_dir, logger="silent", block=block)
        times.setdefault(block, []).append((time.perf_counter() - t0) * 1e3)
        t1 = time.perf_counter()
        ckpt.wait_for_pending_saves()
        times.setdefault(f"join {block}", []).append((time.perf_counter() - t1) * 1e3)
    a, b = (torch.load(os.path.join(out_dir, f"ckpt-{n}.pth"), map_location="cpu",
                       weights_only=True) for n in ("sync", "async"))
    if not all(torch.equal(v, b["base_model"][k]) for k, v in a["base_model"].items()):
        raise AssertionError("async checkpoint: the files differ")
    size = os.path.getsize(os.path.join(out_dir, "ckpt-sync.pth")) / 2 ** 20
    print(f"[async checkpoints] {size:.1f} MiB checkpoint (B={B} cls model + AdamW): the "
          f"training thread waits block=True {times[True][0]:.1f}, {times[True][1]:.1f} ms; "
          f"block=False {times[False][0]:.1f}, {times[False][1]:.1f} ms (then "
          f"wait_for_pending_saves {times['join False'][0]:.1f}, {times['join False'][1]:.1f} "
          f"ms); files equal ({card})", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    from upp_torch import resolve_device
    from upp_torch.ops import cuda_build
    from upp_torch.train.pipeline import corrupt_batch
    from upp_torch.train.runner_cls import PEFT_LIST, init_model, make_eval_step
    from upp_torch.utils import cuda_graphs, profiling
    from upp_torch.utils.config import ConfigDict, cfg_from_yaml_file

    device = resolve_device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[card] {kind}; nvidia-smi: {card}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)

    # 1. build
    t0 = time.time()
    usage = cuda_build.build(["fps", "knn", "chamfer", "knn_select"])
    print(f"[build] fps.cu + knn.cu + chamfer.cu + knn_select.cu built in "
          f"{time.time() - t0:.1f} s "
          f"({card})", flush=True)
    for name, lines in usage.items():
        for kernel in lines.split("; "):
            print(f"[ptxas] {name}.cu {kernel}", flush=True)

    clouds_np, labels_np = synthetic_clouds(B_PRETRAIN)
    all_clouds = torch.from_numpy(clouds_np).to(device)
    clouds = all_clouds[:B]
    labels = torch.from_numpy(labels_np).to(device)[:B]
    seg = seg_batch(B_SEG, device)
    comp = completion_batch(B_COMP, device)

    # 2. kernels vs plain, ties and edges, host cost; 3. kNN backward
    with torch.inference_mode():
        rows = phase_kernels(all_clouds, seg[0], comp[1], card)
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
    if not torch.equal(eval_step(clouds), preds):       # a replay
        raise AssertionError("clean eval: the replayed step's predictions differ")
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

    # phase 4 left a graph of the downstream pass at this shape, whose
    # replay the Recorder's wrappers would not see: the path runs eager
    cuda_graphs.clear(model)
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
    # the warm-up captured the passes: the next step replays them
    reset_counts()
    robust_step(clouds, gen)
    torch.cuda.synchronize()
    replays = profiling.counts().get("cuda_graph.replays", 0)
    if replays != 3 or read_counts() != robust_counts:
        raise AssertionError(f"robust inference, replayed: {replays} replays, launches "
                             f"{read_counts()} != {robust_counts}")
    with torch.inference_mode():
        replayed = model(points, denoise=True, completion_prompt=True, point_num=NPOINTS)
    if not torch.equal(replayed, logits):
        raise AssertionError(f"robust inference: replayed logits differ by "
                             f"{(replayed - logits).abs().max().item()}")
    print(f"[robust] launches of one step {robust_counts}, the same in a step of "
          f"{replays} replays, logits bit-equal replayed; {robust_ms:.2f} ms/batch, "
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
    cls_counts, peft_ms = phase_cls_train(clouds, labels, config, card, device, backward_ms)
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

    # 25. world of one under the launcher, 26. two ranks on one card (gloo),
    # 27. two ranks on two cards (NCCL)
    phase_dist_world1(card, peft_ms)
    dist_ref = phase_dist_ranks(card, device)

    # 28. PoinTr, 29. AdaPoinTr (and its fold decoder's kNN limit), 30. AdaPoinTr
    # with every local style, 31. completion card vs CPU, 32. EMD
    pointr_counts = phase_completion(
        "pointr", POINTR_PCN, comp, card, device, POINTR_EVAL_CALLS, POINTR_TRAIN_CALLS,
        [(B_COMP, 448, 3), (B_COMP, N_GT, 3)], [(B_COMP, 448, 3), (B_COMP, N_GT, 3)])
    ada_counts = phase_completion(
        "adapointr", ADAPOINTR_PCN, comp, card, device, ADA_EVAL_CALLS, ADA_TRAIN_CALLS,
        [(B_COMP, 512, 3), (B_COMP, N_GT, 3)],
        [(B_COMP, 512, 3), (B_COMP, 64, 3), (B_COMP, 64 * 32, 3), (B_COMP, N_GT, 3)])
    phase_adapointr_fold(comp, card, device)
    phase_adapointr_styles(comp, card, device)
    phase_completion_card_vs_cpu(comp, card, device)
    phase_emd(card, device)

    # 33-35. bf16 block stacks (if_half): the cls PEFT, pretask and pretrain
    # train steps, each beside its float32 step; 36. bf16 card vs CPU
    cls_half = phase_half("cls train PEFT", lambda c, d: cls_train_setup(c, d, PEFT_LIST)[::2],
                          config, (clouds, labels), card, device, ROBUST_CALLS, B, graphed=True)
    pretask_half = phase_half("pretask train", lambda c, d: pretask_setup(c, d)[::2],
                              pretask_config, (clouds[:B_PRETASK],), card, device,
                              PRETASK_TRAIN_CALLS, B_PRETASK)
    pre_half = phase_half("pretrain train", pretrain_setup, pre_cfg, (all_clouds,), card,
                          device, PRETRAIN_CALLS + PRETRAIN_CHAMFER, B_PRETRAIN)
    half_bounds = dict(rtol=2e-2, atol=0.0, grad_rtol=2e-2)
    phase_half_cls_logits(clouds, half_config(config), card, device)
    clean_half = half_config(config)
    clean_half.noisy_train = False
    phase_cls_card_vs_cpu(clouds, labels, clean_half, card, device,
                          stages=(("PEFT", PEFT_LIST),), tag="cls bf16 clean", **half_bounds)
    phase_cls_card_vs_cpu(clouds, labels, half_config(config), card, device,
                          stages=(("PEFT", PEFT_LIST),), tag="cls bf16", hold=False)
    phase_half_cls_passes(clouds, config, card, device)
    phase_pretask_card_vs_cpu(clouds, half_config(pretask_config), card, device,
                              tag="pretask bf16", **half_bounds)
    phase_pretrain_card_vs_cpu(all_clouds, half_config(pre_cfg), card, device,
                               tag="pretrain bf16", **half_bounds)

    # 37. legacy pretask train, 38. legacy card vs CPU, 39. legacy CLI
    legacy = legacy_config(pretask_config)
    leg_model, _, leg_step, _ = pretask_setup(legacy, device)
    legacy_counts = phase_train("legacy pretask train", leg_step, leg_model,
                                (clouds[:B_PRETASK],), card, LEGACY_TRAIN_CALLS, B_PRETASK)
    del leg_model, leg_step
    phase_pretask_card_vs_cpu(clouds, legacy, card, device, tag="legacy")
    phase_legacy_cli(card)

    # 40. AdapterSuper and the visualisation runner
    phase_tools(clouds, card, device)

    # 41. the denoise kernels, 42. denoising, 43. profiling, 44. remat_blocks,
    # 45. asynchronous checkpoints
    with torch.inference_mode():
        denoise_rows = phase_denoise_kernels(card)
    denoise_counts = phase_denoise(card, device)
    phase_profiling(config, card)
    phase_remat(config, card, device)
    phase_async_checkpoints(config, card, device)

    # 46. ZeRO-3 pretrain step, 47. dp1 x tp2 cls steps, 48. the dry run and
    # entry, 49. the cls CLI under two node groups; four cards: NCCL fsdp4 and
    # dp2 x tp2
    fsdp_counts = phase_fsdp(card)
    tp_counts = phase_tp(card, dist_ref)
    phase_dryrun(card)
    phase_two_node_groups(card)
    phase_four_cards(card, dist_ref)

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
    kernels += [kernel_entry(k, rows, POINTR_TRAIN_CALLS, pointr_counts[k], B_COMP,
                             "pointr train step") for k in ("fps", "knn", "chamfer")]
    kernels += [kernel_entry(k, rows, ADA_TRAIN_CALLS, ada_counts[k], B_COMP,
                             "adapointr train step") for k in ("fps", "knn", "chamfer")]
    kernels += [kernel_entry(k, rows, LEGACY_TRAIN_CALLS, legacy_counts[k], B_PRETASK,
                             "legacy pretask train step") for k in ("fps", "knn", "chamfer")]
    kernels += [kernel_entry(k, rows, ROBUST_CALLS, cls_half[k], B, "cls train step bf16")
                for k in ("fps", "knn")]
    kernels += [kernel_entry(k, rows, PRETASK_TRAIN_CALLS, pretask_half[k], B_PRETASK,
                             "pretask train step bf16") for k in ("fps", "knn", "chamfer")]
    kernels += [kernel_entry(k, rows, PRETRAIN_CALLS, pre_half[k], B_PRETRAIN, "pretrain bf16")
                for k in ("fps", "knn")]
    kernels += [kernel_entry("chamfer", rows, PRETRAIN_CHAMFER, pre_half["chamfer"],
                             B_REBUILD, "pretrain bf16")]
    kernels += [kernel_entry(k, denoise_rows, DENOISE_50K, denoise_counts[k], 1, "denoise 50K")
                for k in ("fps", "knn_select")]
    kernels += [kernel_entry(k, rows, PRETRAIN_CALLS, fsdp_counts[k], B_PRETRAIN // N_RANKS,
                             "pretrain fsdp, rank 0 of 2") for k in ("fps", "knn")]
    kernels += [kernel_entry("chamfer", rows, PRETRAIN_CHAMFER, fsdp_counts["chamfer"],
                             B_REBUILD // N_RANKS, "pretrain fsdp, rank 0 of 2")]
    kernels += [kernel_entry(k, rows, ROBUST_CALLS, tp_counts[k], B,
                             "cls train step dp1xtp2, rank 0 of 2") for k in ("fps", "knn")]
    print("[kernels] ms/plain_ms/bound_ms summed over one step's calls of each entry's path: "
          f"fps and knn over one cls train step (B={B}, the robust step's calls), one seg "
          f"PEFT train step (B={B_SEG}), one pretrain train step (B={B_PRETRAIN}) and one "
          f"fine-tune cls train step (B={B_FT}); chamfer over one pretask train step "
          f"(B={B_PRETASK}) and one pretrain train step (its {B_REBUILD} clouds of 32); all "
          f"three over one PoinTr and one AdaPoinTr train step (B={B_COMP}), one legacy "
          f"pretask train step (B={B_PRETASK}) and the bf16 (if_half) cls, pretask and "
          f"pretrain train steps; fps and knn_select over one patch_based_denoise of 50000 "
          f"points (B=1); knn's and knn_select's library_ms: torch.cdist + topk; all three "
          f"over rank 0's ZeRO-3 "
          f"pretrain step (B={B_PRETRAIN // N_RANKS} a rank) and fps and knn over rank 0's "
          f"dp1 x tp2 cls PEFT step (B={B}), launched in those rank processes; launches "
          f"from those runs; {card}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(dist_worker(sys.argv[2:]) if sys.argv[1:2] == ["--dist-worker"] else main())
