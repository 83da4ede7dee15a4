"""Histogram: counts of the int32 values in [0, nbins), for any nbins >= 1.

Port of ``tpukernels/kernels/histogram.py``. On a CUDA tensor the
wrapper launches ``csrc/histogram.cu``, one kernel for both TPU kernels
(``_hist_mxu_kernel``, nbins <= 256, and ``_hist_kernel``, any nbins):
each block counts into private shared-memory bins with atomics and
merges them into scratch bins, which the last block moves to the
output, so a call is one launch. On a CPU tensor it runs
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
from tpukernels_torch.kernels import count_launch
from tpukernels_torch.kernels.scan import (check_length, drop_scratch,
                                           scratch)
from tpukernels_torch.tuning import (SearchSpace, Tunable, plan_memo,
                                     resolve)
from tpukernels_torch.utils import cdiv

TUNABLES = SearchSpace(
    kernel="histogram",
    metric="scan_hist_melem_s",
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
# bins a block of the kernels keeps in shared memory (TPKT_SMEM_BINS,
# csrc/bins.cuh). Up to here the blocks merge into scratch bins that the
# last block moves to the output, so the output needs no fill launch;
# above, they count into a zeroed output with global atomics.
SMEM_BINS = 32768

_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
)


def check_nbins(nbins) -> int:
    nbins = int(nbins)
    if not 1 <= nbins <= (1 << 31) - 1:
        raise ValueError(f"histogram: nbins={nbins}; expected 1..2^31-1")
    return nbins


def as_int32(x):
    """Flattened, contiguous int32, cast as the reference casts; ``x``
    itself when it is that already."""
    check_length("histogram", x)
    if x.dtype == torch.int32 and x.dim() == 1 and x.is_contiguous():
        return x
    return x.reshape(-1).to(torch.int32).contiguous()


def launch_plan(n: int, nbins: int, device) -> int:
    """The knob ``blocks_per_sm`` of a call on ``n`` elements and
    ``nbins`` bins on ``device``, resolved env > cache > default and
    memoised (:func:`tuning.plan_memo`)."""
    return plan_memo(TUNABLES, (n, nbins, device.type, device.index),
                     _launch_plan, n, nbins, device)


def _launch_plan(n, nbins, device):
    return resolve(TUNABLES, shape=(n, nbins), dtype="int32",
                   device=device)["blocks_per_sm"]


def histogram(x, nbins: int):
    """Counts of the values of ``x`` (cast to int32) in [0, nbins); a new
    (nbins,) int32 tensor on the input's device."""
    nbins = check_nbins(nbins)
    x = as_int32(x)
    if x.device.type == "cpu":
        return histogram_plain(x, nbins)
    if x.device.type != "cuda":
        raise ValueError(f"histogram: unsupported device {x.device}")
    return _histogram_cuda(x, nbins,
                           launch_plan(x.numel(), nbins, x.device))


def bins_out(nbins: int, n: int, x):
    """The (nbins,) int32 output of a kernel that counts ``n`` values:
    zeroed where the kernel counts into it (more than ``SMEM_BINS`` bins)
    or does not run (``n`` 0), else uninitialised, for the kernel's last
    block to write."""
    make = torch.empty if nbins <= SMEM_BINS and n else torch.zeros
    return make(nbins, dtype=torch.int32, device=x.device)


def _histogram_cuda(x, nbins, per_sm):
    n = x.numel()
    out = bins_out(nbins, n, x)
    if n == 0:  # a grid of 0 blocks is a launch error
        return out
    where = _build.device_stream(x)
    key, buf = (None, None) if nbins > SMEM_BINS else scratch(
        "histogram", 1 + cdiv(nbins, 2), x, where)
    fn = _build.function("histogram", "tpkt_histogram", _ARGTYPES)
    rc = _build.launch_at(fn, *where, x.data_ptr(), out.data_ptr(),
                          None if buf is None else buf.data_ptr(), n, nbins,
                          per_sm)
    count_launch("histogram")
    if rc != 0:
        drop_scratch(key)
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
