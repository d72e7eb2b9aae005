"""Bindings of the CUDA kNN kernels (``csrc/knn.cu``, ``csrc/knn_select.cu``).

``knn`` and ``knn_select`` take CUDA tensors only and carry no gradient:
they refuse an input that requires one, so gradients go through
``ops.knn``'s autograd Function, which calls them. ``ops.knn`` sends CPU
tensors to the plain PyTorch version instead. The libraries are built at
first use (see ``cuda_build``), never at import.

``knn``'s kernel runs a warp per query, 8 queries per block, over its cloud
staged in shared memory, keeping one (distance, index) key a lane for k <= 32
and two for 32 < k <= 64 (two template instances of one kernel); the library
picks by k. ``knn_select``'s kernel serves the rest up to k = 1024 and
N = 2^20 at few queries: a thread-block cluster per query splits the cloud
among its blocks, finds the boundary of the k smallest keys from a merged
histogram of a wide first digit, and each block sorts its keys at or below
the boundary and places them among its peers' by binary search.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import cuda_build

MAX_K = 64       # csrc/knn.cu kMaxK: two kept keys per lane of the query's warp
MAX_N = 16384    # csrc/knn.cu kMaxN: the cloud is staged in shared memory
SELECT_MAX_K = 1024      # csrc/knn_select.cu kMaxK
SELECT_MAX_N = 1048576   # csrc/knn_select.cu kMaxN: an index fits the key's low 20 bits
SELECT_CANDIDATES = 1024  # csrc/knn_select.cu kCandidates: past it, more passes over the cloud
SELECT_GATHERED = 2048    # csrc/knn_select.cu kGathered: a block's keys in pass 2, at most
SELECT_MAX_STORED_SHARE = 65536  # csrc/knn_select.cu kMaxStoredShare: points a block


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("knn")
    lib.upp_knn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                            ctypes.c_void_p, ctypes.c_void_p]
    lib.upp_knn.restype = ctypes.c_int
    lib.upp_knn_error_string.argtypes = [ctypes.c_int]
    lib.upp_knn_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _select_lib() -> ctypes.CDLL:
    lib = cuda_build.load("knn_select")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.upp_knn_select.argtypes = [ptr, ptr, i32, i32, i32, i32, ptr, ptr, ptr, ptr]
    lib.upp_knn_select.restype = i32
    lib.upp_knn_select_plan.argtypes = [i32, i32, ptr]
    lib.upp_knn_select_plan.restype = None
    lib.upp_knn_select_error_string.argtypes = [ctypes.c_int]
    lib.upp_knn_select_error_string.restype = ctypes.c_char_p
    return lib


def _check_inputs(fn: str, query: torch.Tensor, points: torch.Tensor, k: int,
                  max_k: int, max_n: int) -> None:
    """Raise unless ``query`` [B,S,3] and ``points`` [B,N,3] are float32
    contiguous CUDA tensors without gradient, one device and batch, and
    0 < k <= min(max_k, N), 0 < N <= max_n. The shapes and limits are
    checked first, the device after. Reads no device memory."""
    for name, t in (("query", query), ("points", points)):
        if t.dtype != torch.float32 or t.dim() != 3 or t.shape[-1] != 3:
            raise ValueError(f"{fn}: {name} must be float32 [B, *, 3], got "
                             f"{t.dtype} {tuple(t.shape)}")
    N = points.shape[1]
    if not 0 < N <= max_n:
        raise ValueError(f"{fn}: N={N} outside the kernel's range 1..{max_n}")
    if not 0 < k <= min(max_k, N):
        raise ValueError(f"{fn}: k={k} outside the kernel's range 1..min({max_k}, N={N})")
    for name, t in (("query", query), ("points", points)):
        if t.device.type != "cuda":
            raise ValueError(f"{fn}: {name} must be a CUDA tensor, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
    if query.device != points.device or query.shape[0] != points.shape[0]:
        raise ValueError(f"{fn}: query and points must share device and batch")
    if torch.is_grad_enabled() and (query.requires_grad or points.requires_grad):
        raise RuntimeError(f"{fn}: the kernel carries no gradient; call "
                           "ops.knn.knn / knn_points, whose autograd Function "
                           "has the backward")


def knn(query: torch.Tensor, points: torch.Tensor, k: int, gather: bool
        ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """(sq_dists [B,S,k] f32 ascending, idx [B,S,k] i32, nbr [B,S,k,3] f32 or
    None) by the kernel, for float32 contiguous CUDA ``query`` [B,S,3] and
    ``points`` [B,N,3]. ``gather`` writes the neighbours' xyz."""
    _check_inputs("knn", query, points, k, MAX_K, MAX_N)
    B, S, _ = query.shape
    N = points.shape[1]
    dev = query.device
    d = torch.empty((B, S, k), dtype=torch.float32, device=dev)
    idx = torch.empty((B, S, k), dtype=torch.int32, device=dev)
    nbr = (torch.empty((B, S, k, 3), dtype=torch.float32, device=dev)
           if gather else None)
    err = cuda_build.launch(_lib().upp_knn, dev, query.data_ptr(), points.data_ptr(), B, S,
                            N, k, d.data_ptr(), idx.data_ptr(),
                            nbr.data_ptr() if gather else None)
    if err != 0:
        msg = _lib().upp_knn_error_string(err).decode()
        raise RuntimeError(f"knn kernel launch failed: {msg} ({err})")
    knn.launches += 1
    return d, idx, nbr


knn.launches = 0


def knn_select(query: torch.Tensor, points: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sq_dists [B,S,k] f32 ascending, idx [B,S,k] i32) by the large-k
    kernel, for float32 contiguous CUDA ``query`` [B,S,3] and ``points``
    [B,N,3], k <= 1024, N <= 2^20. A cluster of blocks a query: meant for
    few queries (``knn`` serves the many-query call sites up to k = 64)."""
    d, idx, _ = _select(query, points, k, stats=False)
    knn_select.launches += 1
    return d, idx


knn_select.launches = 0


def select_stats(query: torch.Tensor, points: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``knn_select`` with, for each query, the count of keys in the boundary
    bin after the first pass and the number of refining passes the kernel
    made (more than ``SELECT_CANDIDATES`` in that bin): (d, idx, stats
    [B*S, 2] int64). A measurement entry: the port's paths call
    ``knn_select``; a launch here counts in ``knn_select.launches`` all the
    same."""
    out = _select(query, points, k, stats=True)
    knn_select.launches += 1
    return out


def select_plan(rows: int, n: int) -> Tuple[int, int]:
    """The kernel's launch plan for ``rows`` = B*S queries over clouds of
    ``n`` points: (blocks a query, threads a block). Asks the built library,
    which decides it."""
    out = (ctypes.c_int * 2)()
    _select_lib().upp_knn_select_plan(rows, n, out)
    return out[0], out[1]


def _select(query, points, k, stats):
    _check_inputs("knn_select", query, points, k, SELECT_MAX_K, SELECT_MAX_N)
    B, S, _ = query.shape
    N = points.shape[1]
    dev = query.device
    d = torch.empty((B, S, k), dtype=torch.float32, device=dev)
    idx = torch.empty((B, S, k), dtype=torch.int32, device=dev)
    lib = _select_lib()
    st = torch.zeros((B * S, 2), dtype=torch.int32, device=dev) if stats else None
    err = cuda_build.launch(lib.upp_knn_select, dev, query.data_ptr(), points.data_ptr(),
                            B, S, N, k, d.data_ptr(), idx.data_ptr(),
                            None if st is None else st.data_ptr())
    if err != 0:
        msg = lib.upp_knn_select_error_string(err).decode()
        raise RuntimeError(f"knn_select kernel launch failed: {msg} ({err})")
    return d, idx, None if st is None else st.long()
