"""Inclusive scan and histogram of the same int32 values, in one call.

Port of ``tpukernels/kernels/scan_histogram.py``. The ``fuse`` knob
(``TPKT_SCANHIST_FUSE``, default ``off``, parsed fail-loud) picks the
path, as the reference's own fuse knob does:

- ``off`` (the path of record) runs the kernels of
  :func:`scan.inclusive_scan` and :func:`histogram.histogram`, which
  read ``x`` twice;
- ``on`` launches ``csrc/scan_histogram.cu`` (replaces the TPU's
  ``_fused_kernel``): the scan kernel also counts each element into its
  block's bins while it holds it, so ``x`` is read once.

The reference pads the fused input with zeros and subtracts the pad
count from bin 0; the fused kernel masks its ragged tail instead, with
the same result. On a CPU tensor ``on`` runs both plain versions.

Bound on the card: bytes, 8 per element fused, 12 for the unfused pair.
"""

from __future__ import annotations

import ctypes

import torch

from tpukernels_torch import _build
from tpukernels_torch.kernels import count_launch
from tpukernels_torch.kernels import histogram as _hist
from tpukernels_torch.kernels import scan as _scan
from tpukernels_torch.tuning import (SearchSpace, Tunable, plan_memo,
                                     resolve)

TUNABLES = SearchSpace(
    kernel="scan_histogram",
    metric="scan_hist_melem_s",
    bench_shape=(1 << 22, 256),
    bench_dtype="int32",
    sources=("tpukernels_torch/kernels/scan_histogram.py",
             "tpukernels_torch/csrc/scan_histogram.cu",
             "tpukernels_torch/csrc/scan.cuh", "tpukernels_torch/csrc/bins.cuh"),
    tunables=(
        Tunable("fuse", env="TPKT_SCANHIST_FUSE", default="off",
                values=("off", "on"), choice=True),
    ),
)

_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
)


def launch_plan(x, nbins: int) -> tuple:
    """``(fuse, tile, blocks_per_sm)`` of a call on ``x`` (flat int32)
    and ``nbins`` bins: this module's ``fuse``, the scan's ``tile`` and,
    for ``off``, the histogram's ``blocks_per_sm`` (None for ``on``),
    each resolved env > cache > default (fail-loud) by its own module.
    One memo (:func:`tuning.plan_memo`) over the three knob spaces."""
    return plan_memo((TUNABLES, _scan.TUNABLES, _hist.TUNABLES),
                     (x.numel(), nbins, x.device.type, x.device.index),
                     _launch_plan, x, nbins)


def _launch_plan(x, nbins):
    n = x.numel()
    fuse = resolve(TUNABLES, shape=(n, nbins), dtype="int32",
                   device=x.device)["fuse"]
    per_sm = (_hist._launch_plan(n, nbins, x.device) if fuse == "off"
              else None)
    return fuse, _scan.resolve_tile(x), per_sm


def scan_histogram(x, nbins: int):
    """``(inclusive_scan(x), histogram(x, nbins))`` of ``x`` cast to
    int32: a new (n,) and a new (nbins,) int32 tensor."""
    nbins = _hist.check_nbins(nbins)
    x = _hist.as_int32(x)  # once: both halves take it as it is
    fuse, tile, per_sm = launch_plan(x, nbins)
    if x.device.type == "cpu":  # both plain plans, whatever fuse says
        return _scan.scan_plain(x, tile), _hist.histogram_plain(x, nbins)
    if x.device.type != "cuda":
        raise ValueError(f"scan_histogram: unsupported device {x.device}")
    if fuse == "off":  # the two standalone kernels
        return (_scan._scan_cuda(x, tile),
                _hist._histogram_cuda(x, nbins, per_sm))
    return _fused_cuda(x, nbins, tile)


def _fused_cuda(x, nbins, tile):
    n = x.numel()
    out = torch.empty_like(x)
    hist = _hist.bins_out(nbins, n, x)
    if n == 0:  # a grid of 0 blocks is a launch error
        return out, hist
    where = _build.device_stream(x)
    key, state = _scan.scan_state(
        n, tile, x, nbins if nbins <= _hist.SMEM_BINS else 0, where)
    fn = _build.function("scan_histogram", "tpkt_scan_histogram", _ARGTYPES)
    rc = _build.launch_at(fn, *where, x.data_ptr(), out.data_ptr(),
                          hist.data_ptr(), state.data_ptr(), n, nbins,
                          tile // _scan.TILES[0])
    count_launch("scan_histogram")
    if rc != 0:
        _scan.drop_scratch(key)
    _build.check(rc, "tpkt_scan_histogram")
    return out, hist


def scan_histogram_plain(x, nbins: int):
    """Plain PyTorch version: both plain plans on the same values."""
    x = _hist.as_int32(x)
    return _scan.scan_plain(x), _hist.histogram_plain(x, nbins)


def scan_histogram_reference(x, nbins: int):
    """Oracle pair: the scan and histogram oracles."""
    x = x.reshape(-1).to(torch.int32)
    return (_scan.inclusive_scan_reference(x),
            _hist.histogram_reference(x, nbins))
