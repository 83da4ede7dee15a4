"""Build the port's CUDA kernels on first use and load them with ctypes.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C
interface, built by ``nvcc`` for Hopper (``sm_90a``) into
``tpukernels_torch/_build/<name>-<hash>.so``. The hash covers the
source, every header of ``csrc/``, the flags and the toolkit
(:func:`toolkit`: ``nvcc``'s release and ``torch.version.cuda``), so an
edited kernel or header, or another toolkit, is rebuilt and an unchanged
one is loaded as it is. Several missing libraries are compiled in
parallel, one ``nvcc`` each. :func:`build` is the port's one compile
choke point (the reference's ``aot.compile_jitted``): each library it
compiles is an ``aot/build/<name>`` span (``obs/trace.py``) and a sample
of the ``aot.build_s`` histogram (``obs/metrics.py``), and its ptxas
report stays beside it (:func:`ptxas_report` reads it).

Every C entry takes device pointers and the CUDA stream as
``c_void_p`` and returns ``cudaGetLastError()`` after its launch;
:func:`launch` calls one on a tensor's device and current stream, and
:func:`check` raises when it did not return ``cudaSuccess``. A missing
``nvcc`` or a failed build raises: nothing falls back to PyTorch. One
process builds into a directory at a time (an ``flock`` on its
``.build.lock``): ranks that start together build each library once.
The libraries link against the CUDA runtime only: the one CUDA driver call
a kernel needs (``cuTensorMapEncodeTiled``, ``csrc/hopper.cuh``) is
reached through ``cudaGetDriverEntryPoint``, not ``-lcuda``.

Two builds use the host C compiler instead, for the C entry:
:func:`build_shim` compiles the port's CPython shim
(``csrc/tpkt_shim.c``) into ``_build/libtpkt_shim-<hash>.so``, and
:func:`build_c_drivers` builds the repository's unchanged C drivers
(``c/``) into ``_build/cbin/``. A driver run with ``--device=tpu`` and
``TPU_KERNELS_SHIM`` naming the shim runs the port: in the port the
``tpu`` label means "through the shim".
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import sys
import sysconfig
import tempfile
import threading
import time
from pathlib import Path

import torch

from tpukernels_torch.obs import metrics as obs_metrics
from tpukernels_torch.obs import trace

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("saxpy", "sgemm", "sgemm_pipelined", "sgemm_prep", "jacobi2d",
           "jacobi3d", "nbody", "scan", "histogram", "scan_histogram")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# the libraries whose design keeps its state in registers: a ptxas spill
# in one of them is a failure (chip_smoke.py phase 2, the prewarm)
SPILL_FREE = ("jacobi2d", "jacobi3d", "nbody")

_LIBS: dict = {}  # name -> loaded ctypes.CDLL, once per process
_TOOLKIT: dict = {}  # "nvcc" -> nvcc's release line, asked once per process
_FUNCS: dict = {}  # C symbol -> its ctypes function, argtypes set
# held while a library is built and loaded, or a function looked up:
# two threads (the serving daemon's workers) must not both run nvcc for
# one library (they would share its temporary file) or load it twice
_LOAD_LOCK = threading.RLock()


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


def nvcc_release() -> str:
    """The release line of ``nvcc --version`` (``Cuda compilation tools,
    release 12.9, V12.9.86``), or ``none`` where there is no ``nvcc``;
    asked once per process, under :data:`_LOAD_LOCK`."""
    rel = _TOOLKIT.get("nvcc")
    if rel is None:
        with _LOAD_LOCK:
            rel = _TOOLKIT.get("nvcc")
            if rel is None:
                rel = _TOOLKIT["nvcc"] = _ask_nvcc()
    return rel


def _ask_nvcc() -> str:
    try:
        exe = nvcc()
    except RuntimeError:
        return "none"
    try:
        out = subprocess.run([exe, "--version"], capture_output=True,
                             text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return "none"
    found = re.search(r"^.*\brelease\b.*$", out, re.M)
    return found[0].strip() if found else "none"


def toolkit() -> str:
    """What a library's key holds of the toolkit: ``nvcc``'s release and
    the CUDA that PyTorch was built for."""
    return f"nvcc={nvcc_release()};torch.cuda={torch.version.cuda}"


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(toolkit().encode())
    for src in (*sorted(CSRC.glob("*.cuh")), CSRC / f"{name}.cu"):
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


@contextlib.contextmanager
def _dir_lock(directory: Path):
    """Hold ``directory``'s build lock (an exclusive ``flock`` on its
    ``.build.lock``, released when the holder exits or dies): one
    process builds into a directory at a time, so ranks that start
    together build a library once, and the others wait and load it."""
    directory.mkdir(parents=True, exist_ok=True)
    with open(directory / ".build.lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        yield


def build(names=SOURCES) -> dict:
    """Compile every library in ``names`` that is not built yet, all at
    once, and return ``{name: seconds}`` for the ones compiled. The
    ptxas report (registers, shared memory, spills) of each build is
    kept beside its library as ``.log``. Under the build directory's
    lock (:func:`_dir_lock`)."""
    with _dir_lock(BUILD_DIR):
        return _build_locked(names)


def _build_locked(names) -> dict:
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
        trace.emit_span(f"aot/build/{name}", seconds[name],
                        library=out.name, rc=proc.returncode)
        obs_metrics.observe("aot.build_s", seconds[name])
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}.cu (rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def ptxas_report(name: str):
    """What ptxas said when ``csrc/<name>.cu`` was built (the ``.log``
    beside its library), or None when it is not built: its kernels'
    count, registers a thread (least and most), shared memory a block
    (most), spill stores and loads (bytes, summed) and the ``wgmma``
    serialisation warnings."""
    logf = library_path(name).with_suffix(".log")
    if not logf.exists():
        return None
    text = logf.read_text()
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
    smem = [int(b) for b in re.findall(r"(\d+) bytes smem", text)]
    return {
        "kernels": len(regs),
        "registers_min": min(regs, default=0),
        "registers": max(regs, default=0),
        "smem_bytes": max(smem, default=0),
        "spill_stores": sum(map(int, re.findall(r"(\d+) bytes spill stores",
                                                 text))),
        "spill_loads": sum(map(int, re.findall(r"(\d+) bytes spill loads",
                                                text))),
        "wgmma_serialisation": len(re.findall("serializ", text)),
    }


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        with _LOAD_LOCK:
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
        with _LOAD_LOCK:
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


# ---------------------------------------------------------------- C entry

SHIM_SOURCE = CSRC / "tpkt_shim.c"
C_DIR = _PKG.parent / "c"
# the drivers and the shim's ABI test (c/Makefile targets)
C_DRIVERS = ("vector_add", "sgemm", "stencil", "scan_histogram", "nbody",
             "allreduce_bench", "test_shim_abi")
SHIM_CFLAGS = ("-O2", "-Wall", "-Wextra", "-std=c11", "-shared", "-fPIC")


def c_compiler(openmp: bool = False) -> str:
    """Path of a host C compiler: ``gcc`` or ``cc`` on PATH, else the
    system's ``/usr/bin`` one; with ``openmp``, the first that links an
    ``-fopenmp`` program (the C drivers' flag; a toolchain can ship a
    ``gcc`` without libgomp). Raises when there is none."""
    found = [c for c in dict.fromkeys((shutil.which("gcc"), shutil.which("cc"),
                                       "/usr/bin/gcc", "/usr/bin/cc"))
             if c and os.access(c, os.X_OK)]
    for cc in found:
        if not openmp:
            return cc
        with tempfile.TemporaryDirectory() as d:
            src = Path(d) / "omp.c"
            src.write_text("int main(void) { return 0; }\n")
            r = subprocess.run([cc, "-fopenmp", "-o", str(Path(d) / "omp"),
                                str(src)], capture_output=True)
        if r.returncode == 0:
            return cc
    raise RuntimeError(f"no C compiler{' with OpenMP' if openmp else ''} "
                       f"found (tried {found or 'gcc, cc'}); the C entry "
                       "needs one")


def python_embed_flags() -> tuple:
    """``(cflags, ldflags)`` that embed the running interpreter's
    CPython: ``python3-config --embed`` of its version, with an rpath
    for each library directory. Raises when no such ``python3-config``
    is found or it belongs to another version."""
    ver = f"{sys.version_info.major}.{sys.version_info.minor}"
    exe = shutil.which(f"python{ver}-config") or shutil.which(
        "python3-config")
    if not exe:
        raise RuntimeError(f"python{ver}-config / python3-config not found; "
                           "the port's shim embeds CPython with it")

    def ask(flag):
        r = subprocess.run([exe, "--embed", flag], capture_output=True,
                           text=True)
        if r.returncode != 0:
            raise RuntimeError(f"{exe} --embed {flag} failed: {r.stderr}")
        return r.stdout.split()

    cflags, ldflags = ask("--cflags"), ask("--ldflags")
    if f"-lpython{ver}" not in ldflags:
        raise RuntimeError(f"{exe} links {ldflags}, not the running "
                           f"interpreter's libpython{ver}")
    rpaths = [f"-Wl,-rpath,{f[2:]}" for f in ldflags if f.startswith("-L")]
    return cflags, ldflags + rpaths


def _site_packages() -> str:
    """The running interpreter's site-packages, for the embedded one."""
    paths = sysconfig.get_paths()
    return os.pathsep.join(dict.fromkeys((paths["purelib"],
                                          paths["platlib"])))


def build_shim(out_dir=None, extra_cflags=()) -> Path:
    """Compile ``csrc/tpkt_shim.c`` into ``<out_dir>/libtpkt_shim-<hash>
    .so`` (default ``_build/``) unless it is there, and return its path.
    The repository root and the running interpreter's site-packages are
    baked in; the hash covers the source, its header, the flags (with
    ``extra_cflags``, a sanitizer's say) and the Python version. A
    missing compiler or ``python3-config``, or a failed build, raises.
    Under ``out_dir``'s build lock (:func:`_dir_lock`)."""
    out_dir = Path(out_dir) if out_dir else BUILD_DIR
    with _dir_lock(out_dir):
        return _build_shim_locked(out_dir, tuple(extra_cflags))


def _build_shim_locked(out_dir: Path, extra_cflags: tuple = ()) -> Path:
    cc = c_compiler()
    cflags, ldflags = python_embed_flags()
    cflags = [*cflags, *extra_cflags]
    defines = (f'-DTPKT_DEFAULT_ROOT="{_PKG.parent}"',
               f'-DTPKT_SITE_PACKAGES="{_site_packages()}"')
    flags = [*SHIM_CFLAGS, *cflags, *ldflags, *defines]
    h = hashlib.sha256(" ".join([sys.version, *flags]).encode())
    for src in (SHIM_SOURCE, SHIM_SOURCE.with_suffix(".h")):
        h.update(src.read_bytes())
    out = out_dir / f"libtpkt_shim-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    r = subprocess.run([cc, *SHIM_CFLAGS, "-o", str(tmp), str(SHIM_SOURCE),
                        *cflags, *ldflags, *defines],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"building {SHIM_SOURCE.name} failed "
                           f"(rc {r.returncode}):\n{r.stdout}{r.stderr}")
    os.replace(tmp, out)
    return out


def build_c_drivers(bin_dir=None, cflags=None, ldlibs=None) -> Path:
    """Build the unchanged C drivers of ``C_DRIVERS`` from ``c/`` into
    ``bin_dir`` (default ``_build/cbin/``, never ``c/bin/``) with
    ``c/Makefile`` (a command-line ``BIN`` and ``CC`` override its own:
    ``CC`` is a compiler with OpenMP; ``cflags`` and ``ldlibs``, when
    given, replace its ``CFLAGS`` and ``LDLIBS``), and return the
    directory. ``make`` rebuilds only what is out of date, under
    ``bin_dir``'s build lock (:func:`_dir_lock`); a missing tool or a
    failed build raises."""
    bin_dir = Path(bin_dir or BUILD_DIR / "cbin").resolve()
    make = shutil.which("make")
    if not make:
        raise RuntimeError("make not found on PATH; the C drivers are "
                           "built with c/Makefile")
    with _dir_lock(bin_dir):
        r = subprocess.run(
            [make, "-C", str(C_DIR), f"-j{len(C_DRIVERS)}",
             f"CC={c_compiler(openmp=True)}", f"BIN={bin_dir}",
             *([f"CFLAGS={cflags}"] if cflags is not None else []),
             *([f"LDLIBS={ldlibs}"] if ldlibs is not None else []),
             *(str(bin_dir / d) for d in C_DRIVERS)],
            capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"building the C drivers failed (rc "
                           f"{r.returncode}):\n{r.stdout}{r.stderr}")
    return bin_dir
