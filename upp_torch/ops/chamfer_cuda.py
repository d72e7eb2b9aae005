"""Binding of the CUDA Chamfer nearest-neighbour kernel (``csrc/chamfer.cu``).

``nn_both`` takes CUDA tensors only; ``ops.chamfer.nn_both`` sends CPU
tensors to the plain PyTorch version instead. The library is built at first
use (see ``cuda_build``), never at import.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import cuda_build

MAX_B = 65535    # csrc/chamfer.cu: the batch is the grid's y dimension


def _fn():
    fn = cuda_build.load("chamfer").upp_chamfer_nn_both
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 5
    fn.restype = ctypes.c_int
    return fn


def _error(code: int) -> str:
    fn = cuda_build.load("chamfer").upp_chamfer_error_string
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return fn(code).decode()


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
    if not (0 < B <= MAX_B and N > 0 and M > 0):
        raise ValueError(f"nn_both: shape B={B}, N={N}, M={M} outside the "
                         f"kernel's range (1 <= B <= {MAX_B}, N, M >= 1)")
    vx = _check_mask("valid_x", valid_x, x)
    vy = _check_mask("valid_y", valid_y, y)
    dev = x.device
    d1 = torch.empty((B, N), dtype=torch.float32, device=dev)
    i1 = torch.empty((B, N), dtype=torch.int32, device=dev)
    d2 = torch.empty((B, M), dtype=torch.float32, device=dev)
    i2 = torch.empty((B, M), dtype=torch.int32, device=dev)
    fn = _fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), y.data_ptr(),
                 None if vx is None else vx.data_ptr(),
                 None if vy is None else vy.data_ptr(), B, N, M,
                 d1.data_ptr(), i1.data_ptr(), d2.data_ptr(), i2.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"chamfer kernel launch failed: {_error(err)} ({err})")
    nn_both.launches += 2      # one launch of the direction kernel each way
    return d1, i1, d2, i2


nn_both.launches = 0
