"""Binding of the CUDA kNN kernel (``csrc/knn.cu``), forward only.

``knn`` takes CUDA tensors only; ``ops.knn`` sends CPU tensors to the plain
PyTorch version instead. The library is built at first use (see
``cuda_build``), never at import.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import cuda_build

MAX_K = 32       # csrc/knn.cu kMaxK: the sorted list lives in registers
MAX_N = 16384    # csrc/knn.cu kMaxN: the cloud is staged in shared memory


def _fn():
    fn = cuda_build.load("knn").upp_knn
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _error(code: int) -> str:
    fn = cuda_build.load("knn").upp_knn_error_string
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return fn(code).decode()


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
        raise NotImplementedError("knn: the CUDA kernel is forward-only; its "
                                  "backward arrives with the training slice")
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
    fn = _fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(query.data_ptr(), points.data_ptr(), B, S, N, k, d.data_ptr(),
                 idx.data_ptr(), nbr.data_ptr() if gather else None, stream)
    if err != 0:
        raise RuntimeError(f"knn kernel launch failed: {_error(err)} ({err})")
    knn.launches += 1
    return d, idx, nbr


knn.launches = 0
