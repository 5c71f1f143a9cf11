"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``.  The first
use of any kernel builds every library at once, one ``nvcc`` process per
source, all started together, into ``build/repro_torch_kernels/`` at the
repository root (git-ignored).  A library's file name carries a hash of its
source, the shared headers (``csrc/*.cuh``) and the flags, so an edited kernel is rebuilt and an unchanged one is
reused.  A failed build raises with the compiler's output.

Nothing here runs at import time: the CPU tests import every module of the
port on machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("gemm", "spdmm", "spmm", "csr_spmm", "dispatch", "dispatch_bwd",
           "dispatch_bwd_f32", "tile_nnz", "flash_attention", "edge_softmax")
FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_libs: Dict[str, ctypes.CDLL] = {}
_functions: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _library_path(name: str) -> Path:
    h = hashlib.sha256()
    for part in ([p.read_bytes() for p in sorted(CSRC.glob("*.cuh"))]
                 + [(CSRC / f"{name}.cu").read_bytes(),
                    " ".join(FLAGS).encode()]):
        h.update(part)
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> float:
    """Build (or reuse) and load every kernel library; returns the seconds
    this call spent building."""
    missing = [n for n in SOURCES if n not in _libs]
    if not missing:
        return 0.0
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in missing:
        so = _library_path(name)
        if so.exists():
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        log = so.with_suffix(".log")
        cmd = [_nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, so, tmp, log, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failed = []
    for name, so, tmp, log, proc in procs:
        output, _ = proc.communicate()
        log.write_bytes(output)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{output.decode(errors='replace')}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("CUDA kernel build failed\n" + "\n".join(failed))
    for name in missing:
        _libs[name] = ctypes.CDLL(str(_library_path(name)))
    return time.perf_counter() - t0


def function(lib: str, symbol: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C entry point ``symbol`` of library ``lib``, with its argument
    types declared (pointers and the stream as ``c_void_p``) and an int
    return code (a ``cudaError_t``).  Declared once and kept: the kernels'
    wrappers run on the LM's per-token path, where host time counts."""
    key = (lib, symbol)
    fn = _functions.get(key)
    if fn is None:
        if lib not in _libs:
            build_all()
        fn = getattr(_libs[lib], symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _functions[key] = fn
    return fn


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def stream(t) -> int:
    """The current CUDA stream of ``t``'s device, as the C side takes it."""
    return torch.cuda.current_stream(t.device).cuda_stream


H100_SMS = 132


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """Streaming multiprocessors of ``device`` (the kernels' launch shapes
    are chosen to fill them)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def require_aligned(name: str, t, align: int = 16) -> None:
    """Raise unless ``t``'s data starts on an ``align``-byte boundary (the
    kernels' 16-byte ``cp.async`` copies need it; nothing falls back)."""
    if t.data_ptr() % align:
        raise ValueError(f"{name}: data at {t.data_ptr():#x} is not "
                         f"{align}-byte aligned")


def refuse_grad(name: str, *tensors) -> None:
    """Raise when grad mode is on and one of ``tensors`` requires a
    gradient: the kernel writes its result through raw pointers, so the
    result would carry no autograd graph and the gradient would be lost
    without a word.  Only ``dispatch`` has a backward (the
    ``torch.autograd.Function`` in ``core/dynasparse.py``)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise ValueError(f"{name}: the kernel has no backward; call it "
                         "under torch.no_grad() or on tensors that require "
                         "no gradient")


def require(name: str, t, dtype) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype``."""
    if not t.is_cuda or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous CUDA {dtype} tensor, got "
            f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
