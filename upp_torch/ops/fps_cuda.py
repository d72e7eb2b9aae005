"""Binding of the CUDA furthest-point-sampling kernel (``csrc/fps.cu``).

``fps_idx`` takes CUDA tensors only; ``ops.fps.fps`` sends CPU tensors to the
plain PyTorch version instead. The library is built at first use (see
``cuda_build``), never at import.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import cuda_build

_BIG = 1e10          # running-distance start of a valid slot (pointnet2's)
MAX_N = 14336        # csrc/fps.cu kMaxN: coordinates + distances in shared memory


def _fn():
    fn = cuda_build.load("fps").upp_fps
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _error(code: int) -> str:
    fn = cuda_build.load("fps").upp_fps_error_string
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return fn(code).decode()


def fps_idx(xyz: torch.Tensor, n_samples: int,
            valid: Optional[torch.Tensor] = None,
            start_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """FPS indices [B, n_samples] int32 of ``xyz`` [B, N, 3] float32 (CUDA,
    contiguous), by the kernel. ``valid`` [B, N] bool and ``start_idx`` [B]
    are encoded into the kernel's initial distance table as the Pallas kernel
    takes them (1e10 valid, -1 invalid, 2e10 explicit start)."""
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
    if valid is None:
        init = torch.full((B, N), _BIG, dtype=torch.float32, device=dev)
    else:
        if valid.device != dev:
            raise ValueError("fps_idx: valid must be on xyz's device")
        init = torch.where(valid.expand(B, N), _BIG, -1.0).float().contiguous()
    if start_idx is not None:
        if start_idx.device != dev:
            raise ValueError("fps_idx: start_idx must be on xyz's device")
        start = start_idx.long().expand(B).reshape(B, 1)
        init.scatter_(1, start, 2.0 * _BIG)
    idx = torch.empty((B, n_samples), dtype=torch.int32, device=dev)
    fn = _fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(xyz.data_ptr(), init.data_ptr(), B, N, n_samples,
                 idx.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"fps kernel launch failed: {_error(err)} ({err})")
    fps_idx.launches += 1
    return idx


fps_idx.launches = 0
