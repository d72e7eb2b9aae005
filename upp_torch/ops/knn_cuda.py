"""Binding of the CUDA kNN kernel (``csrc/knn.cu``).

``knn`` takes CUDA tensors only and carries no gradient: it refuses an input
that requires one, so gradients go through ``ops.knn``'s autograd Function,
which calls it. ``ops.knn`` sends CPU tensors to the plain PyTorch version
instead. The library is built at first use (see ``cuda_build``), never at
import.

The kernel runs a warp per query, 8 queries per block, over its cloud staged
in shared memory, keeping one (distance, index) key a lane for k <= 32 and
two for 32 < k <= 64 (two template instances of one kernel); the library
picks by k.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import cuda_build

MAX_K = 64       # csrc/knn.cu kMaxK: two kept keys per lane of the query's warp
MAX_N = 16384    # csrc/knn.cu kMaxN: the cloud is staged in shared memory


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


def knn(query: torch.Tensor, points: torch.Tensor, k: int, gather: bool
        ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """(sq_dists [B,S,k] f32 ascending, idx [B,S,k] i32, nbr [B,S,k,3] f32 or
    None) by the kernel, for float32 contiguous CUDA ``query`` [B,S,3] and
    ``points`` [B,N,3]. ``gather`` writes the neighbours' xyz."""
    for name, t in (("query", query), ("points", points)):
        if t.device.type != "cuda":
            raise ValueError(f"knn: {name} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.float32 or t.dim() != 3 or t.shape[-1] != 3:
            raise ValueError(f"knn: {name} must be float32 [B, *, 3], got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"knn: {name} must be contiguous")
    if query.device != points.device or query.shape[0] != points.shape[0]:
        raise ValueError("knn: query and points must share device and batch")
    if torch.is_grad_enabled() and (query.requires_grad or points.requires_grad):
        raise RuntimeError("knn: the kernel carries no gradient; call "
                           "ops.knn.knn / knn_points, whose autograd Function "
                           "has the backward")
    B, S, _ = query.shape
    N = points.shape[1]
    if not 0 < N <= MAX_N:
        raise ValueError(f"knn: N={N} outside the kernel's range 1..{MAX_N}")
    if not 0 < k <= min(MAX_K, N):
        raise ValueError(f"knn: k={k} outside the kernel's range 1..min({MAX_K}, N={N})")
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
