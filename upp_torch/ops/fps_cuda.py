"""Binding of the CUDA furthest-point-sampling kernel (``csrc/fps.cu``).

``fps_idx`` takes CUDA tensors only; ``ops.fps.fps`` sends CPU tensors to the
plain PyTorch version instead. The library is built at first use (see
``cuda_build``), never at import.

The kernel runs one block per cloud and comes in six variants by the
cloud's size N, each thread keeping P points in ceil(N / (32 P)) warps:
0: N <= 32, P = 1; 1: N <= 64, P = 2; 2: N <= 2048, P = 4; 3: N <= 4096,
P = 8; 4: N <= 8192, P = 32 (these with x, y, z and the running distance in
registers); 5: N <= 16384, P = 32 (the distances in registers, x, y, z in
shared memory). ``variant`` asks the library which one serves N.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import cuda_build

_BIG = 1e10          # running-distance start of a valid slot (pointnet2's)
MAX_N = 16384        # csrc/fps.cu kMaxN: the cloud is staged in shared memory


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("fps")
    lib.upp_fps.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.upp_fps.restype = ctypes.c_int
    lib.upp_fps_variant.argtypes = [ctypes.c_int]
    lib.upp_fps_variant.restype = ctypes.c_int
    lib.upp_fps_num_variants.argtypes = []
    lib.upp_fps_num_variants.restype = ctypes.c_int
    lib.upp_fps_error_string.argtypes = [ctypes.c_int]
    lib.upp_fps_error_string.restype = ctypes.c_char_p
    return lib


def variant(n: int) -> int:
    """Index of the kernel variant that serves clouds of ``n`` points (-1:
    none), of ``num_variants()``."""
    return _lib().upp_fps_variant(n)


def num_variants() -> int:
    return _lib().upp_fps_num_variants()


def fps_idx(xyz: torch.Tensor, n_samples: int,
            valid: Optional[torch.Tensor] = None,
            start_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """FPS indices [B, n_samples] int32 of ``xyz`` [B, N, 3] float32 (CUDA,
    contiguous), by the kernel. ``valid`` [B, N] bool and ``start_idx`` [B]
    are encoded into the kernel's initial distance table as the Pallas kernel
    takes them (1e10 valid, -1 invalid, 2e10 explicit start); without either
    the kernel gets no table (every slot valid, start at 0)."""
    if xyz.device.type != "cuda":
        raise ValueError(f"fps_idx: xyz must be a CUDA tensor, got {xyz.device}")
    if xyz.dtype != torch.float32 or xyz.dim() != 3 or xyz.shape[-1] != 3:
        raise ValueError(f"fps_idx: xyz must be float32 [B, N, 3], got "
                         f"{xyz.dtype} {tuple(xyz.shape)}")
    if not xyz.is_contiguous():
        raise ValueError("fps_idx: xyz must be contiguous")
    B, N, _ = xyz.shape
    if not 0 < N <= MAX_N:
        raise ValueError(f"fps_idx: N={N} outside the kernel's range 1..{MAX_N}")
    if n_samples < 1:
        raise ValueError(f"fps_idx: n_samples={n_samples} must be >= 1")
    dev = xyz.device
    init = None
    if valid is not None:
        if valid.device != dev:
            raise ValueError("fps_idx: valid must be on xyz's device")
        init = torch.where(valid.expand(B, N), _BIG, -1.0).float().contiguous()
    if start_idx is not None:
        if start_idx.device != dev:
            raise ValueError("fps_idx: start_idx must be on xyz's device")
        if init is None:
            init = torch.full((B, N), _BIG, dtype=torch.float32, device=dev)
        init.scatter_(1, start_idx.long().expand(B).reshape(B, 1), 2.0 * _BIG)
    idx = torch.empty((B, n_samples), dtype=torch.int32, device=dev)
    err = cuda_build.launch(_lib().upp_fps, dev, xyz.data_ptr(),
                            None if init is None else init.data_ptr(), B, N, n_samples,
                            idx.data_ptr())
    if err != 0:
        msg = _lib().upp_fps_error_string(err).decode()
        raise RuntimeError(f"fps kernel launch failed: {msg} ({err})")
    fps_idx.launches += 1
    return idx


fps_idx.launches = 0
