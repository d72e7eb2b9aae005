"""Build, load and launch the port's CUDA kernels.

Each ``upp_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface and loaded with ``ctypes``. The
build happens at first use, into ``<repo>/build/upp_torch/`` (listed in
``.gitignore``), under a file name keyed by a hash of the source and the
flags, so an edited source is rebuilt and an unchanged one is reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "upp_torch"
# -fmad=false: no multiply-add contraction, so the kernels' distance
# arithmetic rounds exactly like the plain PyTorch versions (bit-equal
# distances, identical argmin/argmax decisions); -Xptxas -v: ptxas reports
# each kernel's registers, spills and shared memory, which ``build`` returns
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{key}.so"


def _compile_cmd(name: str, out: Path):
    return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile the named sources that are not built yet, all in parallel
    (one ``nvcc`` per source). Returns ptxas's resource lines (registers,
    spills, shared memory) of each source compiled by this call. Raises
    with the compiler's output on a failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs.append((name, out, tmp, subprocess.Popen(
            _compile_cmd(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    errors, usage = [], {}
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)       # atomic: a half-written library is never loaded
        usage[name] = _ptxas_usage(log)
    if errors:
        raise RuntimeError("\n".join(errors))
    return usage


def _ptxas_usage(log: str) -> str:
    """'kernel: registers, stack frame, spills' for each kernel (each
    template instance) in ptxas's ``-v`` report, names demangled where
    ``c++filt`` exists."""
    kernels = []                                    # [mangled name, report parts]
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            kernels.append([m.group(1), []])
        elif kernels and ("registers" in line or "stack frame" in line):
            kernels[-1][1].append(line.split(":", 1)[-1].strip() if "ptxas" in line
                                  else line.strip())
    names = [k[0] for k in kernels]
    tool = shutil.which("c++filt")
    if tool and names:
        out = subprocess.run([tool, *names], capture_output=True, text=True,
                             timeout=60).stdout.splitlines()
        if len(out) == len(names):
            names = [re.sub(r"^void |\(anonymous namespace\)::|\(.*\)$", "", n) for n in out]
    return "; ".join(f"{n}: {', '.join(parts)}" for n, (_, parts) in zip(names, kernels))


def launch(fn, device, *args) -> int:
    """``fn(*args, stream)``, a kernel's C entry point, on ``device``'s current
    stream; returns its CUDA error code. The device is switched only when it
    is not the current one, and the raw stream handle comes without building
    a ``torch.cuda.Stream`` (several µs a call)."""
    if device.index == torch.cuda.current_device():
        return fn(*args, torch._C._cuda_getCurrentRawStream(device.index))
    with torch.cuda.device(device):
        return fn(*args, torch._C._cuda_getCurrentRawStream(device.index))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)))
            _LIBS[name] = lib
        return lib
