"""SAXPY vector add: out = alpha * x + y, for 1-D float32 of any length.

Port of ``tpukernels/kernels/vector_add.py``. On a CUDA tensor the
wrapper launches ``csrc/saxpy.cu`` (replaces the TPU's
``_saxpy_kernel``); on a CPU tensor it runs :func:`saxpy_reference`,
the plain PyTorch version. The result is a new tensor: unlike the TPU
kernel, which aliases ``y`` to its output, the port leaves ``y`` as it
was.

Bound on the card: bytes (12 per element). The kernel streams 16-byte
vectors, several in flight a thread, on a grid that covers the work;
see the source note in ``saxpy.cu``. The host path
of a call is kept short: the launch plan (knob, grid) is memoised per
process and follows a changed env knob or cache entry on the next call
(:func:`launch_plan`); the device is made current only when it is not,
and an input is copied only when it is not 1-D and contiguous.
"""

from __future__ import annotations

import ctypes

import torch

from tpukernels_torch import _build
from tpukernels_torch.kernels import count_launch
from tpukernels_torch.tuning import (SearchSpace, Tunable, plan_memo,
                                     resolve)
from tpukernels_torch.utils import cdiv

TUNABLES = SearchSpace(
    kernel="vector_add",
    metric="saxpy_gb_s",
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
_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
)
# float4 vectors a thread carries a trip (UNROLL in csrc/saxpy.cu)
_UNROLL = 4


def _check(x, y):
    """The operands' device, once they are float32 of one size on one
    device."""
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError(f"saxpy takes float32, got {x.dtype} and {y.dtype}")
    if x.numel() != y.numel():
        raise ValueError(f"saxpy: sizes differ, {x.numel()} vs {y.numel()}")
    dev = x.device
    if dev != y.device:
        raise ValueError(f"saxpy: devices differ, {dev} vs {y.device}")
    return dev


def saxpy(alpha, x, y):
    """alpha*x + y for float32 tensors of any length (flattened); a new
    1-D tensor on the inputs' device."""
    dev = _check(x, y)
    if x.dim() != 1 or not x.is_contiguous():
        x = x.reshape(-1).contiguous()
    if y.dim() != 1 or not y.is_contiguous():
        y = y.reshape(-1).contiguous()
    if dev.type == "cpu":
        return saxpy_reference(alpha, x, y)
    if dev.type != "cuda":
        raise ValueError(f"saxpy: unsupported device {dev}")
    return _saxpy_cuda(float(alpha), x, y, dev)


def launch_plan(n: int, device) -> tuple:
    """``(threads, blocks)`` of a call on ``n`` elements on ``device``,
    memoised (:func:`tuning.plan_memo`): the knob resolved env > cache >
    default and checked, and a grid that covers the work, one trip of
    ``_UNROLL`` float4s a thread."""
    return plan_memo(TUNABLES, (n, device.index), _launch_plan, n, device)


def _launch_plan(n, device):
    threads = resolve(TUNABLES, shape=(n,), dtype="float32",
                      device=device)["threads"]
    if threads > 1024 or threads & (threads - 1) or threads < 32:
        raise ValueError(
            f"TPKT_SAXPY_THREADS={threads}: expected a power of two in "
            "32..1024"
        )
    return threads, max(1, cdiv(n, 4 * _UNROLL * threads))


def _saxpy_cuda(alpha, x, y, dev):
    n = x.numel()
    out = torch.empty_like(x)
    if n == 0:
        return out
    threads, blocks = launch_plan(n, dev)
    fn = _build.function("saxpy", "tpkt_saxpy", _ARGTYPES)
    rc = _build.launch(fn, x, x.data_ptr(), y.data_ptr(), out.data_ptr(), n,
                       alpha, blocks, threads)
    count_launch("saxpy")
    _build.check(rc, "tpkt_saxpy")
    return out


def saxpy_reference(alpha, x, y):
    """Plain PyTorch version and oracle (the serial-C golden variant)."""
    return alpha * x + y
