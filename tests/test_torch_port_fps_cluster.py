"""The schedule of FPS variant 6 (``csrc/fps.cu``, N > 16384), on the CPU.

The kernel cannot run here, so these tests hold a plain PyTorch model of its
round to the reference: each warp keeps a contiguous run of indices, the
run's bounding box, its largest running distance and its best key; a round
first bounds the new centre's squared distance to the box (``clamp(c, lo,
hi) - c``, squared and summed one rounded float32 operation at a time) and
leaves the run untouched, offering its kept key, when that bound is at least
the run's largest running distance. The model's indices must equal
``fps_plain_idx`` and the JAX package's ``fps_pallas_idx`` (interpret mode)
on clouds laid out as the patch denoiser lays them out (patches of nearest
neighbours end to end, where runs do skip), in random order, on tie grids,
with a validity mask and with an explicit start. ``hypothesis`` holds the
bound itself: it never exceeds a member point's computed distance.
"""

import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from upp_tpu.ops.fps_pallas import fps_pallas_idx
from upp_torch.ops import fps_cuda
from upp_torch.ops.fps import fps_plain_idx

CSRC = Path(__file__).resolve().parents[1] / "upp_torch" / "csrc"
BIG = 1e10


def sq_dist(dx, dy, dz):
    """(dx*dx + dy*dy) + dz*dz, one float32 operation at a time."""
    return dx * dx + dy * dy + dz * dz


def box_bound(lo, hi, c):
    """Squared distance of the centre ``c`` [..., 3] to the box [lo, hi]:
    the kernel's ``lb``."""
    e = torch.minimum(torch.maximum(c, lo), hi) - c
    return sq_dist(e[..., 0], e[..., 1], e[..., 2])


def cluster_fps_model(xyz, n_samples, run_len, valid=None, start_idx=None):
    """The kernel's schedule over runs of ``run_len`` indices: (idx [B, S]
    int64, skipped run-rounds, run-rounds), counting runs that hold points
    that can be chosen."""
    B, N, _ = xyz.shape
    R = -(-N // run_len)
    pad = R * run_len - N
    init = torch.full((B, N), BIG, dtype=torch.float32)
    if valid is not None:
        init = torch.where(valid, init, -1.0)
    if start_idx is not None:
        init[torch.arange(B), start_idx] = 2 * BIG
    dist = torch.cat([init, torch.full((B, pad), -torch.inf)], 1).reshape(B, R, run_len)
    pts = torch.cat([xyz.float(), torch.zeros(B, pad, 3)], 1).reshape(B, R, run_len, 3)
    member = (dist >= 0)[..., None]
    lo = torch.where(member, pts, torch.inf).amin(2)                # [B, R, 3]
    hi = torch.where(member, pts, -torch.inf).amax(2)
    holds = (lo <= hi).all(-1)
    explicit = (init > 1.5 * BIG).float().argmax(1)
    first = (init > 0).float().argmax(1)
    cur = torch.where((init > 1.5 * BIG).any(1), explicit,
                      torch.where((init > 0).any(1), first, 0))
    run_max, run_arg = dist.max(2)                                   # first maximum of a run
    rows = torch.arange(B)
    idx = torch.empty((B, n_samples), dtype=torch.long)
    skipped = total = 0
    for i in range(n_samples):
        idx[:, i] = cur
        if i + 1 == n_samples:
            break
        c = xyz[rows, cur].float()                                   # [B, 3]
        work = box_bound(lo, hi, c[:, None]) < run_max               # [B, R]
        skipped += int((~work & holds).sum())
        total += int(holds.sum())
        e = pts - c[:, None, None]
        d = torch.minimum(dist, sq_dist(e[..., 0], e[..., 1], e[..., 2]))
        dist = torch.where(work[..., None], d, dist)
        new_max, new_arg = dist.max(2)
        run_max = torch.where(work, new_max, run_max)
        run_arg = torch.where(work, new_arg, run_arg)
        best = run_max.argmax(1)                                     # first maximum: lowest run
        cur = best * run_len + run_arg[rows, best]
    return idx, skipped, total


def patch_cloud(n, patch, seed):
    """[1, 3n, 3]: ``3 n // patch`` patches of the ``patch`` nearest points of
    FPS seeds of a noisy sphere cloud of n points, end to end, moved by the
    affine stand-in for the denoiser network (``utils/denoise.py``'s
    re-sampling input)."""
    rng = np.random.default_rng(seed)
    p = rng.standard_normal((n, 3))
    p /= np.linalg.norm(p, axis=1, keepdims=True)
    cloud = torch.from_numpy((p + 0.01 * rng.standard_normal((n, 3))).astype(np.float32))
    seeds = cloud[fps_plain_idx(cloud[None], 3 * n // patch)[0]]
    d = ((cloud[None] - seeds[:, None]) ** 2).sum(-1)
    near = torch.sort(d, dim=1, stable=True).indices[:, :patch]
    return (cloud[near].reshape(1, -1, 3) * 0.9 + 0.01).contiguous()


def random_order(cloud, seed):
    perm = torch.from_numpy(np.random.default_rng(seed).permutation(cloud.shape[1]))
    return cloud[:, perm].contiguous()


def grid_cloud(B, n, distinct, seed):
    """[B, n, 3]: ``distinct`` points of the grid of multiples of 1/8 and
    repeats of them in a random order: every squared distance exact, real
    ties everywhere."""
    rng = np.random.default_rng(seed)
    base = rng.integers(-8, 9, size=(B, distinct, 3)).astype(np.float32) / 8
    pick = rng.integers(0, distinct, size=(B, n - distinct))
    cloud = np.concatenate([base, np.take_along_axis(base, pick[..., None], 1)], 1)
    order = rng.permuted(np.tile(np.arange(n), (B, 1)), axis=1)
    return torch.from_numpy(np.take_along_axis(cloud, order[..., None], 1))


def reference(xyz, n_samples, valid=None, start_idx=None):
    """fps_plain_idx, after holding it to the JAX package's kernel."""
    want = fps_plain_idx(xyz, n_samples, valid, start_idx)
    jax_idx, _ = fps_pallas_idx(jnp.asarray(xyz.numpy()), n_samples,
                                None if valid is None else jnp.asarray(valid.numpy()),
                                interpret=True,
                                start_idx=None if start_idx is None
                                else jnp.asarray(start_idx.numpy()))
    np.testing.assert_array_equal(np.asarray(jax_idx), want.numpy())
    return want


@functools.cache
def patches():
    return patch_cloud(1024, 256, 0)                    # [1, 3072, 3]


def _case(name):
    """(xyz, n_samples, valid, start_idx) of each case."""
    cloud = patches()
    if name == "patches":
        return cloud, 1024, None, None
    if name == "random order":
        return random_order(cloud, 1), 1024, None, None
    if name == "ties":
        return grid_cloud(2, 2048, 700, 2), 800, None, None
    xyz = torch.cat([cloud, random_order(cloud, 3)])
    valid = torch.from_numpy(np.random.default_rng(4).random((2, cloud.shape[1])) > 0.3)
    start = None
    if name == "start":
        start = torch.tensor([int(np.flatnonzero(v)[5]) for v in valid.numpy()])
    return xyz, 600, valid, start


# the kernel's runs are 32 P points (P = 8, 16: see
# test_run_lengths_cover_the_kernels_instances); 64 makes many small runs,
# 768 spans several of the patch clouds' patches
RUN_LENGTHS = (64, 256, 512, 768)


@pytest.mark.parametrize("name", ["patches", "random order", "ties", "masked", "start"])
def test_schedule_index_exact_vs_plain_and_pallas(name):
    xyz, s, valid, start = _case(name)
    want = reference(xyz, s, valid, start)
    for run_len in RUN_LENGTHS:
        got, skipped, total = cluster_fps_model(xyz, s, run_len, valid, start)
        np.testing.assert_array_equal(got.numpy(), want.numpy(), err_msg=f"run_len {run_len}")
        if name == "patches" and run_len == 256:
            # runs of a patch are spatially tight: skipping must happen for
            # the equality above to test it
            assert skipped > 0.5 * total, (skipped, total)


def test_random_order_barely_skips():
    """On a cloud in random order every box spans the cloud: the skip share
    falls far below the patch layout's."""
    _, patch_skip, patch_total = cluster_fps_model(patches(), 1024, 256)
    _, rand_skip, rand_total = cluster_fps_model(random_order(patches(), 1), 1024, 256)
    assert rand_skip / rand_total < 0.25 * patch_skip / patch_total


@settings(max_examples=300, deadline=None, database=None)
@given(st.lists(st.tuples(*[st.floats(-2.0 ** 64, 2.0 ** 64, width=32)] * 3), min_size=1, max_size=24),
       st.tuples(*[st.floats(-2.0 ** 64, 2.0 ** 64, width=32)] * 3),
       st.tuples(*[st.floats(0, 2.0 ** 10, width=32)] * 6),
       st.sampled_from([1.0, 1e-6, 1e6, 1e-30]))
def test_box_bound_never_exceeds_a_member_distance(points, centre, grow, scale):
    """For any float32 box around member points (their own box or one
    enlarged) and any centre, the bound is at most each member's distance,
    all in rounded float32."""
    pts = torch.tensor(points, dtype=torch.float32) * scale
    c = torch.tensor(centre, dtype=torch.float32) * scale
    g = torch.tensor(grow, dtype=torch.float32) * scale
    lo = pts.amin(0) - g[:3]
    hi = pts.amax(0) + g[3:]
    for box in ((pts.amin(0), pts.amax(0)), (lo, hi)):
        lb = box_bound(*box, c)
        e = pts - c
        d = sq_dist(e[:, 0], e[:, 1], e[:, 2])
        assert bool((lb <= d).all()), (box, c, lb, d)


def test_run_lengths_cover_the_kernels_instances():
    """The model runs the kernel's run lengths (32 P of each variant 6
    instance), and the last instance holds exactly fps_cuda.MAX_N
    points."""
    text = (CSRC / "fps.cu").read_text()
    shapes = re.findall(r"\{fps_cluster_kernel<(\d+), (\d+), (true|false)>, (\d+), (\d+), "
                        r"(true|false)\}", text)
    assert len(shapes) == 3
    for p, w, regs, p2, w2, regs2 in shapes:
        assert (p, w, regs) == (p2, w2, regs2)
        assert 32 * int(p) in RUN_LENGTHS
    blocks = re.findall(r"constexpr int kClusterBlocks = (\d+);", text)
    p, w = int(shapes[-1][0]), int(shapes[-1][1])
    assert int(blocks[0]) * 32 * p * w == fps_cuda.MAX_N


def test_skip_stats_entry_checks_before_the_device():
    """The measurement entry takes CUDA tensors of variant 6's sizes only,
    and checks that before it loads the library."""
    with pytest.raises(ValueError, match="CUDA tensor"):
        fps_cuda.cluster_skip_stats(torch.zeros(1, 20000, 3), 8)
    with pytest.raises(ValueError, match="outside"):
        fps_cuda.cluster_skip_stats(torch.zeros(1, fps_cuda.MAX_N + 1, 3), 8)
