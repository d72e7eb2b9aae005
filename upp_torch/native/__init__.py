"""ctypes bindings for the native host-runtime library (a copy of
``upp_tpu/native``'s, for the port).

``upp_native.cpp`` is built with g++ at first use into
``<repo>/build/upp_torch/`` (listed in ``.gitignore``), never into the
package, under a file name keyed by a hash of the source, the flags and the
host CPU's features. Every entry point has a numpy fallback, so the
datasets keep working without a toolchain. Host code: the device kernels
are in ``upp_torch/csrc``."""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import secrets
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "upp_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "upp_torch"
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-pthread")

_lib: Optional[ctypes.CDLL] = None
_tried = False
_LOCK = threading.Lock()


def _cpu_flags() -> bytes:
    """The host CPU's feature flags: ``-march=native`` builds for them, so a
    library built on another machine is not reused."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return next((ln for ln in f if ln.startswith(b"flags")), b"")
    except OSError:
        return platform.processor().encode()


def _target() -> Path:
    key = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode()
                         + _cpu_flags()).hexdigest()[:16]
    return BUILD_DIR / f"libupp_native-{key}.so"


def _build(out: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a name no other process builds into (several local rank 0s of one
    # machine may build at once); the rename below is atomic
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{secrets.token_hex(4)}.tmp")
    try:
        subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=240)
        tmp.replace(out)
        return True
    except Exception:
        tmp.unlink(missing_ok=True)
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built first if needed; None without g++."""
    global _lib, _tried
    with _LOCK:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = _target()
        if not so.exists() and not _build(so):
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            return None
        lib.upp_fps.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                                ctypes.c_int, ctypes.c_int,
                                ctypes.POINTER(ctypes.c_int32)]
        lib.upp_fps_batch.argtypes = [ctypes.POINTER(ctypes.c_float),
                                      ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                      ctypes.POINTER(ctypes.c_int32),
                                      ctypes.c_int]
        lib.upp_read_npy_batch.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                           ctypes.c_int64,
                                           ctypes.POINTER(ctypes.c_float),
                                           ctypes.c_int]
        lib.upp_read_npy_batch.restype = ctypes.c_int
        _lib = lib
        return _lib


def _fps_numpy(pts: np.ndarray, m: int, start: int) -> np.ndarray:
    n = pts.shape[0]
    dist = np.full(n, 1e10, np.float32)
    idx = np.empty(m, np.int64)
    cur = start
    for s in range(m):
        idx[s] = cur
        d = ((pts - pts[cur]) ** 2).sum(-1)
        dist = np.minimum(dist, d)
        cur = int(np.argmax(dist))
    return idx.astype(np.int32)


def fps_host(points: np.ndarray, m: int, start: int = 0) -> np.ndarray:
    """Host FPS indices [m] for one cloud [n, 3] (pointnet2 semantics).
    Native when available, numpy fallback otherwise."""
    pts = np.ascontiguousarray(points[:, :3], np.float32)
    lib = get_lib()
    if lib is None:
        return _fps_numpy(pts, m, start)
    out = np.empty(m, np.int32)
    lib.upp_fps(pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                pts.shape[0], m, start, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out


def fps_host_batch(points: np.ndarray, m: int, n_threads: int = 8) -> np.ndarray:
    """Batched host FPS indices [b, m] for clouds [b, n, 3]."""
    pts = np.ascontiguousarray(points[..., :3], np.float32)
    b, n, _ = pts.shape
    lib = get_lib()
    if lib is None:
        return np.stack([_fps_numpy(pts[i], m, 0) for i in range(b)])
    out = np.empty((b, m), np.int32)
    lib.upp_fps_batch(pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), b, n, m,
                      out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n_threads)
    return out


def read_npy_batch(paths: List[str], n_points: int, n_threads: int = 8) -> np.ndarray:
    """Parallel-read b .npy clouds into [b, n_points, 3] float32
    (zero-padded)."""
    lib = get_lib()
    b = len(paths)
    if lib is not None:
        out = np.empty((b, n_points, 3), np.float32)
        blob = b"".join(p.encode() + b"\0" for p in paths)
        ok = lib.upp_read_npy_batch(blob, b, n_points * 3,
                                    out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                    n_threads)
        if ok == b:
            return out
        # the C++ side zero-fills a failed read; training on an all-zero
        # cloud is worse than failing, so re-read per item and let the
        # exception name the file
    out = np.zeros((b, n_points, 3), np.float32)
    for i, p in enumerate(paths):
        arr = np.load(p).astype(np.float32).reshape(-1, 3)[:n_points]
        out[i, :arr.shape[0]] = arr
    return out
