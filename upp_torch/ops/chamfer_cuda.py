"""Binding of the CUDA Chamfer nearest-neighbour kernel (``csrc/chamfer.cu``).

``nn_both`` takes CUDA tensors only; ``ops.chamfer.nn_both`` sends CPU
tensors to the plain PyTorch version instead. The library is built at first
use (see ``cuda_build``), never at import.

One fused kernel evaluates each (x, y) pair once and reduces it in both
directions; a second kernel unpacks the packed (distance, index) keys, so a
call is two launches. ``launch_plan`` chooses the roles and the grid: the
larger cloud is resident (a block holds ``TILE_R`` of its points), the other
is swept, split over blocks when the resident tiles alone would leave the
card short of blocks. The kernel comes in two instances, with and without
validity masks; with the two roles that makes four variants.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from ..utils import profiling
from . import cuda_build

MAX_B = 65535             # csrc/chamfer.cu kMaxB: the batch is the grid's z dimension
MAX_POINTS = 16777216     # csrc/chamfer.cu kMaxPoints: N, M
MAX_SPLITS = 65535        # csrc/chamfer.cu kMaxSplits: the grid's y dimension
TILE_R = 512              # csrc/chamfer.cu kTileR: resident points a block
MIN_SPLIT = 128           # swept points a block at least, when the swept cloud is split
TARGET_BLOCKS = 2048      # split the swept cloud until the grid has about this many blocks


class LaunchPlan(NamedTuple):
    swap: bool            # y resident, x swept (outputs go back to x and y all the same)
    resident: int         # points of the resident cloud
    swept: int            # points of the swept cloud
    tiles: int            # resident tiles of TILE_R points: the grid's x
    splits: int           # splits of the swept cloud: the grid's y
    split_len: int        # swept points a split (a multiple of 4, the last one shorter)
    grid: Tuple[int, int, int]
    launches: int         # kernel launches of one call: fused pass + unpack


@functools.lru_cache(maxsize=256)
def launch_plan(B: int, N: int, M: int) -> LaunchPlan:
    """Roles and grid of one call for x [B,N,3] and y [B,M,3]: the larger
    cloud resident (x when N == M), the swept one split in pieces of at
    least MIN_SPLIT points until the grid has TARGET_BLOCKS blocks."""
    swap = M > N
    resident, swept = (M, N) if swap else (N, M)
    tiles = -(-resident // TILE_R)
    want = -(-TARGET_BLOCKS // (tiles * B))
    splits = max(1, min(want, swept // MIN_SPLIT, MAX_SPLITS))
    split_len = -(-swept // splits)
    split_len = -(-split_len // 4) * 4
    splits = -(-swept // split_len)
    return LaunchPlan(swap, resident, swept, tiles, splits, split_len, (tiles, splits, B), 2)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("chamfer")
    lib.upp_chamfer_nn_both.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                                        + [ctypes.c_void_p] * 6)
    lib.upp_chamfer_nn_both.restype = ctypes.c_int
    lib.upp_chamfer_error_string.argtypes = [ctypes.c_int]
    lib.upp_chamfer_error_string.restype = ctypes.c_char_p
    return lib


def _check_mask(name: str, valid: Optional[torch.Tensor], like: torch.Tensor):
    if valid is None:
        return None
    if valid.dtype != torch.bool or tuple(valid.shape) != tuple(like.shape[:2]):
        raise ValueError(f"nn_both: {name} must be bool {tuple(like.shape[:2])}, got "
                         f"{valid.dtype} {tuple(valid.shape)}")
    if valid.device != like.device or not valid.is_contiguous():
        raise ValueError(f"nn_both: {name} must be contiguous on {like.device}")
    return valid


def nn_both(x: torch.Tensor, y: torch.Tensor,
            valid_x: Optional[torch.Tensor] = None,
            valid_y: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(d1 [B,N] f32, i1 [B,N] i32, d2 [B,M] f32, i2 [B,M] i32) by the
    kernel, for float32 contiguous CUDA ``x`` [B,N,3] and ``y`` [B,M,3] and
    optional bool validity masks [B,N] / [B,M]."""
    for name, t in (("x", x), ("y", y)):
        if t.device.type != "cuda":
            raise ValueError(f"nn_both: {name} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.float32 or t.dim() != 3 or t.shape[-1] != 3:
            raise ValueError(f"nn_both: {name} must be float32 [B, *, 3], got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"nn_both: {name} must be contiguous")
    if x.device != y.device or x.shape[0] != y.shape[0]:
        raise ValueError("nn_both: x and y must share device and batch")
    B, N, _ = x.shape
    M = y.shape[1]
    if not (0 < B <= MAX_B and 0 < N <= MAX_POINTS and 0 < M <= MAX_POINTS):
        raise ValueError(f"nn_both: shape B={B}, N={N}, M={M} outside the kernel's range "
                         f"(1 <= B <= {MAX_B}, 1 <= N, M <= {MAX_POINTS})")
    vx = _check_mask("valid_x", valid_x, x)
    vy = _check_mask("valid_y", valid_y, y)
    plan = launch_plan(B, N, M)
    # one allocation (fewer host calls): the 64-bit keys, then the indices
    # (i1, i2), then the distances (d1, d2), 4 bytes a word
    n_x, total = B * N, B * (N + M)
    buf = torch.empty(4 * total, dtype=torch.int32, device=x.device)
    base = buf.data_ptr()
    err = cuda_build.launch(_lib().upp_chamfer_nn_both, x.device, x.data_ptr(), y.data_ptr(),
                            None if vx is None else vx.data_ptr(),
                            None if vy is None else vy.data_ptr(), B, N, M, int(plan.swap),
                            plan.splits, plan.split_len, base, base + 12 * total,
                            base + 8 * total, base + 12 * total + 4 * n_x,
                            base + 8 * total + 4 * n_x)
    if err != 0:
        msg = _lib().upp_chamfer_error_string(err).decode()
        raise RuntimeError(f"chamfer kernel launch failed: {msg} ({err})")
    profiling.count("launches.chamfer", plan.launches)
    i1, i2 = buf[2 * total:3 * total].split((n_x, total - n_x))
    d1, d2 = buf[3 * total:].view(torch.float32).split((n_x, total - n_x))
    return d1.view(B, N), i1.view(B, N), d2.view(B, M), i2.view(B, M)
