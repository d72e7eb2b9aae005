"""The schedule of the large-k kNN kernel (``csrc/knn_select.cu``), on the CPU.

The kernel cannot run here, so these tests hold a plain PyTorch model of its
schedule to the reference. A query's cloud is cut into C contiguous shares,
one a block of a thread-block cluster. Every point's key is its squared
distance's float bits above its 20-bit index. Pass 1 counts each share's
first digits (key bits 50..40) and merges the histograms; the bin holding
the k-th key is the boundary. When that bin holds more keys than the
kernel's candidate count, the boundary is refined 8 bits at a time over the
shares (the distance's low bits, then the index's: the index select on
ties), and a last pass marks the points of the boundary's first digit by
their key. Pass 2 gathers, share by share, every key at or below the
boundary prefix; each share sorts its keys and places each one at its index
in its own run plus the count of smaller keys in every other share's run;
the places below k are the answer (the exact-k compaction).

The model must be index-identical to ``knn_plain`` with bit-equal
distances, and set-equal to the JAX package's ``knn_points`` (XLA
``top_k`` over matmul-form distances, which round differently from the
direct differences: distances within 2e-6, as in
``test_torch_port_knn_large.py``) on the denoiser's clouds, patch-ordered
clouds and tie grids that overflow the candidates; index-identical also on
random clouds, at k from 65 to 1024, k = N and N not a multiple of C.
``hypothesis`` holds the select itself: on non-negative float32 values with
many repeats its taken set is the first k of the stable sort.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from upp_tpu.ops.knn import knn_points as j_knn_points
from upp_torch.ops import knn_cuda
from upp_torch.ops.knn import knn_plain

CSRC = Path(__file__).resolve().parents[1] / "upp_torch" / "csrc"
INDEX_BITS = 20
TOP_SHIFT = 40          # the first digit: key bits 50..40
TOP_BINS = 2048
NO_DIGIT = 0xFFFF
CANDIDATES = knn_cuda.SELECT_CANDIDATES
GATHERED = knn_cuda.SELECT_GATHERED


def dist_bits(query, points):
    """[S, N] int64: the float bits of ((qx-px)^2 + (qy-py)^2) + (qz-pz)^2,
    one float32 operation at a time (``knn_plain``'s arithmetic)."""
    q, p = query.float(), points.float()
    dx = q[:, 0, None] - p[None, :, 0]
    dy = q[:, 1, None] - p[None, :, 1]
    dz = q[:, 2, None] - p[None, :, 2]
    return (dx * dx + dy * dy + dz * dz).view(torch.int32).long()


def find_rank(hist, rank):
    """(bin, count below it, count in it) of the bin holding the rank-th
    (from 1) counted key."""
    cum = torch.cumsum(hist, 0)
    b = int(torch.searchsorted(cum, torch.tensor(rank)))
    return b, int(cum[b] - hist[b]), int(hist[b])


def select_row(bits, k, clusters, candidates=CANDIDATES):
    """The kernel's schedule over one query's N distance bits: (the k
    smallest keys ascending, first-bin count, refining passes, the largest
    number of keys one share gathered)."""
    n = bits.numel()
    keys = (bits << INDEX_BITS) | torch.arange(n)
    share = ((n + clusters - 1) // clusters + 3) // 4 * 4
    shares = [(min(n, r * share), min(n, r * share + share)) for r in range(clusters)]
    # pass 1: each share's histogram of first digits, merged
    digits = keys >> TOP_SHIFT
    hist = sum(torch.bincount(digits[a:b], minlength=TOP_BINS) for a, b in shares)
    prefix, below, count = find_rank(hist, k)
    shift, rank = TOP_SHIFT, k - below
    first_count, refines = count, 0
    # the overflow path: 8 bits more of the prefix a pass over the shares
    while count > candidates:
        carry = (keys >> shift) == prefix
        d8 = (keys >> (shift - 8)) & 255
        hist8 = sum(torch.bincount(d8[a:b][carry[a:b]], minlength=256) for a, b in shares)
        f, below, count = find_rank(hist8, rank)
        prefix, shift, rank = (prefix << 8) | f, shift - 8, rank - below
        refines += 1
    top = prefix >> (TOP_SHIFT - shift)
    if refines:
        # the marking pass: the boundary digit's points by their whole key
        mark = torch.where((keys >> shift) <= prefix, 0, NO_DIGIT)
        digits = torch.where(digits == top, mark, digits)
    # pass 2: each share's keys at or below the prefix, sorted
    runs = [torch.sort(keys[a:b][digits[a:b] <= top]).values for a, b in shares]
    assert sum(r.numel() for r in runs) <= k - 1 + candidates
    # each share places its keys: its index plus the smaller keys of its peers
    out = torch.full((k,), -1, dtype=torch.int64)
    for r, run in enumerate(runs):
        place = torch.arange(run.numel())
        for q, peer in enumerate(runs):
            if q != r:
                place = place + torch.searchsorted(peer, run)
        keep = place < k
        out[place[keep]] = run[keep]
    assert (out >= 0).all()
    return out, first_count, refines, max(r.numel() for r in runs)


def select_model(query, points, k, clusters, candidates=CANDIDATES):
    """(d [B,S,k] f32, idx [B,S,k] int64, [(first count, refines, most keys
    a share gathered)] a row) by the schedule."""
    B, S, _ = query.shape
    d = torch.empty((B, S, k), dtype=torch.float32)
    idx = torch.empty((B, S, k), dtype=torch.int64)
    stats = []
    for b in range(B):
        bits = dist_bits(query[b], points[b])
        for s in range(S):
            keys, first, refines, most = select_row(bits[s], k, clusters, candidates)
            d[b, s] = (keys >> INDEX_BITS).to(torch.int32).view(torch.float32)
            idx[b, s] = keys & ((1 << INDEX_BITS) - 1)
            stats.append((first, refines, most))
    return d, idx, stats


def random_cloud(b, n, seed):
    return np.random.default_rng(seed).standard_normal((b, n, 3)).astype(np.float32)


def scan_cloud(n, seed):
    """[n, 3]: the unit sphere with N(0, 0.01^2) noise (``chip_smoke.py``'s)."""
    rng = np.random.default_rng(seed)
    p = rng.standard_normal((n, 3))
    p /= np.linalg.norm(p, axis=1, keepdims=True)
    return (p + 0.01 * rng.standard_normal((n, 3))).astype(np.float32)


def patch_cloud(n, seeds, patch, seed):
    """[1, seeds * patch, 3]: the patch denoiser's layout, each of `seeds`
    points' `patch` nearest neighbours end to end (repeats across patches
    are exact ties)."""
    p = torch.from_numpy(scan_cloud(n, seed))[None]
    _, nb = knn_plain(p[:, :seeds], p, patch)
    return p[0][nb.reshape(-1)][None].numpy()


def grid_cloud(b, n, seed):
    """[b, n, 3] on the integer grid {-1, 0, 1}^3: about n / 27 points at
    each grid point, so hundreds to thousands at each squared distance."""
    return np.random.default_rng(seed).integers(-1, 2, (b, n, 3)).astype(np.float32)


# grid queries whose k-th neighbour's bin overflows the candidates at
# n = 8192: the centre (1820 points at distance 1), faces (1515), an edge (1212)
GRID_QUERIES = np.array([[0, 0, 0], [1, 0, 0], [0, -1, 0], [1, 1, 0]], np.float32)


def check_against_plain(pts, q, k, clusters, candidates=CANDIDATES):
    d, i, stats = select_model(torch.from_numpy(q), torch.from_numpy(pts), k, clusters,
                               candidates)
    pd, pi = knn_plain(torch.from_numpy(q), torch.from_numpy(pts), k)
    assert torch.equal(i, pi)
    assert torch.equal(d.view(torch.int32), pd.view(torch.int32))
    return d, i, stats


def cloud_queries(pts, s):
    return pts[:, :s].copy()


def grid_queries(pts, s):
    return np.broadcast_to(GRID_QUERIES[:s], (pts.shape[0], s, 3)).copy()


CASES = {
    # name: (cloud [B, N, 3], queries [B, S, 3] of it, S, k, C)
    "random k65 C4": (lambda: random_cloud(2, 4096, 0), cloud_queries, 5, 65, 4),
    "random k500 C8, N % C != 0": (lambda: random_cloud(1, 5003, 1), cloud_queries, 4, 500, 8),
    "random k1000 C16": (lambda: random_cloud(1, 8192, 2), cloud_queries, 4, 1000, 16),
    "random k1024 C2": (lambda: random_cloud(2, 3001, 3), cloud_queries, 3, 1024, 2),
    "random k = N C4": (lambda: random_cloud(1, 1000, 4), cloud_queries, 3, 1000, 4),
    "scan k1000 C16": (lambda: scan_cloud(8192, 10)[None], cloud_queries, 4, 1000, 16),
    "patches k1000 C4": (lambda: patch_cloud(4000, 6, 1000, 5), cloud_queries, 6, 1000, 4),
    "grid k1000 C4": (lambda: grid_cloud(1, 8192, 6), grid_queries, 4, 1000, 4),
    "grid k1024 C16, N % C != 0": (lambda: grid_cloud(2, 8191, 7), grid_queries, 3, 1024, 16),
}


@pytest.mark.parametrize("name", list(CASES))
def test_schedule_is_index_identical_to_plain(name):
    cloud, queries, s, k, clusters = CASES[name]
    pts = cloud()
    _, _, stats = check_against_plain(pts, queries(pts, s), k, clusters)
    assert all(most <= GATHERED for _, _, most in stats)
    if name.startswith("grid"):
        # the tie grids overflow the candidates and take the refining passes
        assert all(first > CANDIDATES and refines > 0 for first, refines, _ in stats)


@pytest.mark.parametrize("name", ["scan k1000 C16", "patches k1000 C4", "grid k1000 C4"])
def test_schedule_matches_jax_knn_points(name):
    """The denoiser's clouds (a noisy unit sphere, its patch layout) and a
    tie grid, where the matmul form's rounding stays within 2e-6."""
    cloud, queries, s, k, clusters = CASES[name]
    pts = cloud()
    q = queries(pts, s)
    d, i, _ = select_model(torch.from_numpy(q), torch.from_numpy(pts), k, clusters)
    want_d, want_i, _ = j_knn_points(jnp.asarray(q), jnp.asarray(pts), k)
    np.testing.assert_array_equal(np.sort(i.numpy(), -1), np.sort(np.asarray(want_i), -1))
    np.testing.assert_allclose(d.numpy(), np.asarray(want_d), rtol=0, atol=2e-6)


def test_index_select_on_ties():
    """Few candidates force the refining passes through the distance's low
    bits into the index's: on a tie grid the prefix narrows below bit 20,
    and the taken keys are still the stable sort's first k."""
    pts = grid_cloud(1, 3000, 8)
    _, _, stats = check_against_plain(pts, grid_queries(pts, 2), 700, 4, candidates=8)
    assert all(refines >= 3 for _, refines, _ in stats)   # 40 -> 16: into the index bits


def test_each_share_gathers_at_most_its_buffer():
    """All of a query's gathered keys may lie in one share: a cloud whose
    first share holds every near point keeps them all in that share's
    buffer (kGathered keys), never more."""
    pts = random_cloud(1, 8192, 9)
    pts[0, :2000] *= 1e-3                              # the first share's points near 0
    q = np.zeros((1, 2, 3), np.float32)
    _, _, stats = check_against_plain(pts, q, 1024, 4)
    assert all(1024 <= most <= GATHERED for _, _, most in stats)


values = st.lists(st.sampled_from([0.0, 1e-30, 0.5, 0.5000001, 1.0, 2.0, 3.4e38, np.inf]),
                  min_size=1, max_size=400)


@settings(max_examples=60, deadline=None)
@given(values, st.integers(1, 400), st.sampled_from([1, 2, 4, 8, 16]),
       st.sampled_from([1, 4, 32, CANDIDATES]))
def test_taken_set_is_the_stable_sort_prefix(vals, k, clusters, candidates):
    """Non-negative float32 values with many repeats: the schedule's keys
    are the stable sort's first k, whatever the cluster and candidates."""
    d = torch.tensor(vals, dtype=torch.float32)
    k = min(k, d.numel())
    keys, _, _, _ = select_row(d.view(torch.int32).long(), k, clusters, candidates)
    want = torch.sort(d, stable=True).indices[:k]
    assert torch.equal(keys & ((1 << INDEX_BITS) - 1), want)


@pytest.mark.parametrize("constant,value", [
    ("kTopShift", TOP_SHIFT), ("kTopBins", TOP_BINS), ("kIndexBits", INDEX_BITS)])
def test_model_constants_equal_the_cuda_source(constant, value):
    found = re.findall(rf"constexpr int {constant} = (\d+);",
                       (CSRC / "knn_select.cu").read_text())
    assert found == [str(value)]
