"""The tie rule and the launch plan of the port's Chamfer kernel, on the CPU.

The CUDA kernel evaluates each (x, y) pair once, in one role or the other,
and merges partial results of many blocks by a minimum over packed
(distance bits, index) keys; it must still give exactly the indices and
distances of its plain PyTorch version (``nn_both_plain``), which these
tests hold to the JAX package's Pallas kernel in interpret mode on clouds
of multiples of 1/8 full of repeated points (every squared distance exact:
real ties, the lowest index wins). The launch plan's roles, tiles and splits
are checked as a pure function, and replayed block by block in PyTorch: the
keys merged over the plan's blocks must give the plain version's outputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upp_tpu.ops.chamfer_pallas import _nn_both_impl
from upp_torch.ops import chamfer, chamfer_cuda

_BIG = 1e30


def _grid_cloud(B, n, distinct, seed):
    """[B, n, 3] float32: ``distinct`` grid points per cloud and n - distinct
    repeats of them, in a random order."""
    rng = np.random.default_rng(seed)
    base = rng.integers(-8, 9, size=(B, distinct, 3)).astype(np.float32) / 8
    pick = rng.integers(0, distinct, size=(B, n - distinct))
    cloud = np.concatenate([base, np.take_along_axis(base, pick[..., None], 1)], 1)
    order = rng.permuted(np.tile(np.arange(n), (B, 1)), axis=1)
    return np.take_along_axis(cloud, order[..., None], 1)


def _t(a):
    return None if a is None else torch.tensor(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _case(n, m, masked, seed):
    """Tie clouds x [3, n, 3] and y [3, m, 3]; masked: random validity, the
    second cloud with no valid y and the third with no valid x."""
    x = _grid_cloud(3, n, max(1, n // 2), seed)
    y = _grid_cloud(3, m, max(1, m // 3), seed + 1)
    vx = vy = None
    if masked:
        rng = np.random.default_rng(seed + 2)
        vx, vy = rng.random((3, n)) > 0.3, rng.random((3, m)) > 0.3
        vy[1] = False
        vx[2] = False
    return x, y, vx, vy


SHAPES = [(1, 1), (1, 200), (200, 1), (37, 256), (256, 37), (130, 130)]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n,m", SHAPES)
def test_nn_both_plain_ties_exact_vs_pallas(n, m, masked):
    x, y, vx, vy = _case(n, m, masked, 10)
    want = _nn_both_impl(jnp.asarray(x), jnp.asarray(y), _j(vx), _j(vy), interpret=True)
    got = chamfer.nn_both_plain(_t(x), _t(y), _t(vx), _t(vy))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_roles_swap_bit_for_bit():
    """The kernel's premise: a pair's distance is the same bits with the
    roles swapped (fl(a - b) = -fl(b - a)), penalties included."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 70, 3)).astype(np.float32)
    y = rng.standard_normal((2, 90, 3)).astype(np.float32)
    vx, vy = rng.random((2, 70)) > 0.3, rng.random((2, 90)) > 0.3
    d1, i1, d2, i2 = chamfer.nn_both_plain(_t(x), _t(y), _t(vx), _t(vy))
    e2, j2, e1, j1 = chamfer.nn_both_plain(_t(y), _t(x), _t(vy), _t(vx))
    for a, b in ((d1, e1), (i1, j1), (d2, e2), (i2, j2)):
        assert torch.equal(a, b)


def _replay(plan, x, y, vx, vy):
    """The kernel's plan in PyTorch: per block (resident tile, swept split)
    the pair distances of its points, the row minimum with the swept side's
    penalty and the column minimum with the resident side's, packed as
    (distance bits << 32 | index) and merged over blocks by a minimum."""
    B = x.shape[0]
    res, swp, rv, sv = (y, x, vy, vx) if plan.swap else (x, y, vx, vy)
    R, S = plan.resident, plan.swept
    top = torch.iinfo(torch.int64).max
    rkeys = torch.full((B, R), top)
    skeys = torch.full((B, S), top)

    def pen(v, lo, hi):
        return 0.0 if v is None else torch.where(v[:, lo:hi], 0.0, _BIG)

    def key(d, base, i):
        return (d.view(torch.int32).long() << 32) | (base + i)

    for tile in range(plan.tiles):
        r0, r1 = tile * chamfer_cuda.TILE_R, min(R, (tile + 1) * chamfer_cuda.TILE_R)
        for split in range(plan.splits):
            s0, s1 = split * plan.split_len, min(S, (split + 1) * plan.split_len)
            diff = res[:, r0:r1, None, :] - swp[:, None, s0:s1, :]
            sq = diff * diff
            d = (sq[..., 0] + sq[..., 1]) + sq[..., 2]                   # [B, r, s]
            row = d + (pen(sv, s0, s1)[:, None, :] if sv is not None else 0.0)
            col = d + (pen(rv, r0, r1)[:, :, None] if rv is not None else 0.0)
            rmin, rarg = row.min(2)
            cmin, carg = col.min(1)
            rkeys[:, r0:r1] = torch.minimum(rkeys[:, r0:r1], key(rmin, s0, rarg))
            skeys[:, s0:s1] = torch.minimum(skeys[:, s0:s1], key(cmin, r0, carg))

    def unpack(k):
        return (k >> 32).int().view(torch.float32), (k & 0xFFFFFFFF)

    (dr, ir), (ds, is_) = unpack(rkeys), unpack(skeys)
    return (ds, is_, dr, ir) if plan.swap else (dr, ir, ds, is_)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n,m", [(1, 1), (40, 200), (200, 40), (129, 130), (256, 17)])
def test_launch_plan_replayed_equals_plain(monkeypatch, n, m, masked):
    """Small tiles and splits, so the plan has several of each: the keys
    merged over its blocks give the plain version's indices and distances
    (ties to the lowest index across blocks), in either role."""
    monkeypatch.setattr(chamfer_cuda, "TILE_R", 32)
    monkeypatch.setattr(chamfer_cuda, "MIN_SPLIT", 8)
    plan = chamfer_cuda.launch_plan.__wrapped__(2, n, m)
    if n * m > 1:
        assert plan.tiles * plan.splits > 1
    x, y, vx, vy = (_t(a) for a in _case(n, m, masked, 20))
    x, y = x[:2], y[:2]
    vx, vy = (None if v is None else v[:2] for v in (vx, vy))
    got = _replay(plan, x, y, vx, vy)
    want = chamfer.nn_both_plain(x, y, vx, vy)
    for g, w in zip(got, want):
        assert torch.equal(g, w.to(g.dtype))


@pytest.mark.parametrize("B,N,M", [(64, 32, 1024), (64, 1024, 1024), (64, 2048, 8192),
                                   (64, 160, 8192), (8, 1, 1), (8, 1000, 37),
                                   (8, 16384, 2048), (1, 16777216, 1), (65535, 3, 5)])
def test_launch_plan_roles_and_grid(B, N, M):
    plan = chamfer_cuda.launch_plan(B, N, M)
    assert plan.swap == (M > N)
    assert (plan.resident, plan.swept) == ((M, N) if plan.swap else (N, M))
    assert (plan.tiles - 1) * chamfer_cuda.TILE_R < plan.resident <= plan.tiles * chamfer_cuda.TILE_R
    assert plan.split_len % 4 == 0
    assert (plan.splits - 1) * plan.split_len < plan.swept <= plan.splits * plan.split_len
    assert 1 <= plan.splits <= chamfer_cuda.MAX_SPLITS and B <= chamfer_cuda.MAX_B
    assert plan.splits == 1 or plan.split_len >= chamfer_cuda.MIN_SPLIT
    assert plan.grid == (plan.tiles, plan.splits, B)
    assert plan.launches == 2


def test_launch_plan_fills_the_card_at_the_path_shapes():
    """At every pretask Chamfer shape but the smallest the grid has at least
    TARGET_BLOCKS / 2 blocks."""
    for n, m in ((1024, 1024), (2048, 8192), (160, 8192)):
        plan = chamfer_cuda.launch_plan(64, n, m)
        assert np.prod(plan.grid) >= chamfer_cuda.TARGET_BLOCKS // 2, (n, m, plan)
