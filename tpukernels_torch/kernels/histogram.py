"""Histogram: counts of the int32 values in [0, nbins), for any nbins >= 1.

Port of ``tpukernels/kernels/histogram.py``. On a CUDA tensor the
wrapper launches ``csrc/histogram.cu``, one kernel for both TPU kernels
(``_hist_mxu_kernel``, nbins <= 256, and ``_hist_kernel``, any nbins):
each block counts into private shared-memory bins with atomics and
merges them into the output. On a CPU tensor it runs
:func:`histogram_plain`, the same plan in torch ops. The reference's
``impl`` (mxu/vpu) and ``acc`` (i8/f32) knobs choose between TPU
formulations and have no counterpart here.

Like the TPU kernels, negative values and values >= nbins count
nothing. The oracle :func:`histogram_reference` mirrors the
reference's, which clips negative values into bin 0: on values >= 0
the two agree.

Bound on the card: bytes (4 read per element).
"""

from __future__ import annotations

import ctypes

import torch

from tpukernels_torch import _build
from tpukernels_torch.kernels import LAUNCHES
from tpukernels_torch.kernels.scan import check_length
from tpukernels_torch.tuning import SearchSpace, Tunable, resolve

TUNABLES = SearchSpace(
    kernel="histogram",
    bench_shape=(1 << 22, 256),
    bench_dtype="int32",
    sources=("tpukernels_torch/kernels/histogram.py",
             "tpukernels_torch/csrc/histogram.cu",
             "tpukernels_torch/csrc/bins.cuh"),
    tunables=(
        # the grid's cap in blocks a SM: each block merges its nbins once
        Tunable("blocks_per_sm", env="TPKT_HIST_BLOCKS_PER_SM", default=2),
    ),
)
# elements a block of the plain version counts before its merge
PLAIN_BLOCK = 1 << 20

_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p,
)


def check_nbins(nbins) -> int:
    nbins = int(nbins)
    if not 1 <= nbins <= (1 << 31) - 1:
        raise ValueError(f"histogram: nbins={nbins}; expected 1..2^31-1")
    return nbins


def as_int32(x):
    """Flattened, contiguous int32, cast as the reference casts."""
    check_length("histogram", x)
    return x.reshape(-1).to(torch.int32).contiguous()


def histogram(x, nbins: int):
    """Counts of the values of ``x`` (cast to int32) in [0, nbins); a new
    (nbins,) int32 tensor on the input's device."""
    nbins = check_nbins(nbins)
    x = as_int32(x)
    if x.device.type == "cpu":
        return histogram_plain(x, nbins)
    if x.device.type != "cuda":
        raise ValueError(f"histogram: unsupported device {x.device}")
    return _histogram_cuda(x, nbins)


def _histogram_cuda(x, nbins):
    out = torch.zeros(nbins, dtype=torch.int32, device=x.device)
    n = x.numel()
    if n == 0:  # a grid of 0 blocks is a launch error
        return out
    per_sm = resolve(TUNABLES, shape=(n, nbins), dtype="int32",
                     device=x.device)["blocks_per_sm"]
    fn = _build.function("histogram", "tpkt_histogram", _ARGTYPES)
    rc = _build.launch(fn, x, x.data_ptr(), out.data_ptr(), n, nbins, per_sm)
    LAUNCHES["histogram"] += 1
    _build.check(rc, "tpkt_histogram")
    return out


def histogram_plain(x, nbins: int, block: int = PLAIN_BLOCK):
    """Plain PyTorch version: blocks of ``block`` elements, each counting
    its values in [0, nbins) into its own bins, then a merge; any
    device."""
    x = as_int32(x)
    out = torch.zeros(nbins, dtype=torch.int64, device=x.device)
    for b0 in range(0, x.numel(), block):
        xb = x[b0:b0 + block]
        out += torch.bincount(xb[(xb >= 0) & (xb < nbins)], minlength=nbins)
    return out.to(torch.int32)


def histogram_reference(x, nbins: int):
    """Oracle mirroring the reference's ``histogram_reference``:
    bincount of the values clipped to [0, nbins], bin nbins dropped.
    Negative values land in bin 0 there, unlike the kernels."""
    x = x.reshape(-1).to(torch.int32)
    clipped = torch.clamp(x, 0, nbins).to(torch.int64)
    return torch.bincount(clipped, minlength=nbins + 1)[:nbins].to(
        torch.int32)
