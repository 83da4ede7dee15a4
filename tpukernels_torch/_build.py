"""Build the port's CUDA kernels on first use and load them with ctypes.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C
interface, built by ``nvcc`` for Hopper (``sm_90a``) into
``tpukernels_torch/_build/<name>-<hash>.so``. The hash covers the
source, every header of ``csrc/`` and the flags, so an edited kernel
or header is rebuilt and an unchanged one is loaded as it is. Several
missing libraries are compiled in parallel, one ``nvcc`` each.

Every C entry takes device pointers and the CUDA stream as
``c_void_p`` and returns ``cudaGetLastError()`` after its launch;
:func:`launch` calls one on a tensor's device and current stream, and
:func:`check` raises when it did not return ``cudaSuccess``. A missing
``nvcc`` or a failed build raises: nothing falls back to PyTorch. The
libraries link against the CUDA runtime only: the one CUDA driver call
a kernel needs (``cuTensorMapEncodeTiled``, ``csrc/hopper.cuh``) is
reached through ``cudaGetDriverEntryPoint``, not ``-lcuda``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("saxpy", "sgemm", "sgemm_pipelined", "sgemm_prep", "jacobi2d",
           "jacobi3d", "nbody", "scan", "histogram", "scan_histogram")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict = {}  # name -> loaded ctypes.CDLL, once per process
_FUNCS: dict = {}  # C symbol -> its ctypes function, argtypes set


def nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under CUDA_HOME (default
    /usr/local/cuda). Raises when neither has it."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found on PATH or under CUDA_HOME; the port's kernels "
        "are built from tpukernels_torch/csrc and need the CUDA toolkit"
    )


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (*sorted(CSRC.glob("*.cuh")), CSRC / f"{name}.cu"):
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict:
    """Compile every library in ``names`` that is not built yet, all at
    once, and return ``{name: seconds}`` for the ones compiled. The
    ptxas report (registers, shared memory, spills) of each build is
    kept beside its library as ``.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = None
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        exe = exe or nvcc()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        ), tmp, out, time.perf_counter())
    seconds, failed = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}.cu (rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build((name,))
        lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return lib


def function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """One C entry of ``csrc/<name>.cu`` with its argument types set
    (``c_void_p`` for every pointer and the stream), looked up once per
    process."""
    fn = _FUNCS.get(symbol)
    if fn is None:
        fn = getattr(library(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _FUNCS[symbol] = fn
    return fn


def check(rc: int, what: str) -> None:
    """Raise when a C entry reported a CUDA error for its launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")


def stream_of(t) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def device_stream(t) -> tuple:
    """``(device index, raw handle of its current stream)`` of ``t``."""
    dev = t.get_device()
    return dev, torch._C._cuda_getCurrentRawStream(dev)


def launch(fn, t, *args) -> int:
    """``fn(*args, stream)``: a C entry called with the raw handle of
    PyTorch's current stream on ``t``'s device, that device made current
    around the call only when it is not current already (a launch goes
    to the current device). Returns the entry's code."""
    return launch_at(fn, *device_stream(t), *args)


def launch_at(fn, dev: int, stream: int, *args) -> int:
    """:func:`launch` for a caller that has looked up the device index
    and its current raw stream already."""
    if dev == torch._C._cuda_getDevice():  # CUDA is up: the tensor is there
        return fn(*args, stream)
    with torch.cuda.device(dev):
        return fn(*args, stream)
