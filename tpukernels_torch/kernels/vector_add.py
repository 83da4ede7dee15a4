"""SAXPY vector add: out = alpha * x + y, for 1-D float32 of any length.

Port of ``tpukernels/kernels/vector_add.py``. On a CUDA tensor the
wrapper launches ``csrc/saxpy.cu`` (replaces the TPU's
``_saxpy_kernel``); on a CPU tensor it runs :func:`saxpy_reference`,
the plain PyTorch version. The result is a new tensor: unlike the TPU
kernel, which aliases ``y`` to its output, the port leaves ``y`` as it
was.

Bound on the card: bytes (12 per element). The kernel streams 16-byte
vectors in a grid-stride loop; see the source note in ``saxpy.cu``.
"""

from __future__ import annotations

import ctypes

import torch

from tpukernels_torch import _build
from tpukernels_torch.kernels import LAUNCHES
from tpukernels_torch.tuning import SearchSpace, Tunable, resolve
from tpukernels_torch.utils import cdiv

TUNABLES = SearchSpace(
    kernel="vector_add",
    bench_shape=(1 << 20,),
    bench_dtype="float32",
    sources=("tpukernels_torch/kernels/vector_add.py",
             "tpukernels_torch/csrc/saxpy.cu"),
    tunables=(
        # threads per block; a power of two from one warp to the
        # hardware's 1024
        Tunable("threads", env="TPKT_SAXPY_THREADS", default=256),
    ),
)
# the grid is sized to at most this many blocks per SM; the grid-stride
# loop covers the rest
_BLOCKS_PER_SM = 8

_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
)


def _check(x, y):
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError(f"saxpy takes float32, got {x.dtype} and {y.dtype}")
    if x.numel() != y.numel():
        raise ValueError(f"saxpy: sizes differ, {x.numel()} vs {y.numel()}")
    if x.device != y.device:
        raise ValueError(f"saxpy: devices differ, {x.device} vs {y.device}")


def saxpy(alpha, x, y):
    """alpha*x + y for float32 tensors of any length (flattened); a new
    1-D tensor on the inputs' device."""
    _check(x, y)
    x = x.reshape(-1).contiguous()
    y = y.reshape(-1).contiguous()
    if x.device.type == "cpu":
        return saxpy_reference(alpha, x, y)
    if x.device.type != "cuda":
        raise ValueError(f"saxpy: unsupported device {x.device}")
    return _saxpy_cuda(float(alpha), x, y)


def _saxpy_cuda(alpha, x, y):
    n = x.numel()
    out = torch.empty_like(x)
    if n == 0:
        return out
    threads = resolve(TUNABLES, shape=(n,), dtype="float32",
                      device=x.device)["threads"]
    if threads > 1024 or threads & (threads - 1) or threads < 32:
        raise ValueError(
            f"TPKT_SAXPY_THREADS={threads}: expected a power of two in "
            "32..1024"
        )
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    blocks = max(1, min(cdiv(cdiv(n, 4), threads),
                        sms * _BLOCKS_PER_SM))
    fn = _build.function("saxpy", "tpkt_saxpy", _ARGTYPES)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), y.data_ptr(), out.data_ptr(), n, alpha,
                blocks, threads, _build.stream_of(x))
    LAUNCHES["saxpy"] += 1
    _build.check(rc, "tpkt_saxpy")
    return out


def saxpy_reference(alpha, x, y):
    """Plain PyTorch version and oracle (the serial-C golden variant)."""
    return alpha * x + y
