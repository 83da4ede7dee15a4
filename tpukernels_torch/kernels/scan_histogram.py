"""Inclusive scan and histogram of the same int32 values, in one call.

Port of ``tpukernels/kernels/scan_histogram.py``. The ``fuse`` knob
(``TPKT_SCANHIST_FUSE``, default ``off``, parsed fail-loud) picks the
path, as the reference's own fuse knob does:

- ``off`` (the path of record) calls :func:`scan.inclusive_scan` and
  :func:`histogram.histogram`, two kernels that read ``x`` twice;
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
from tpukernels_torch.kernels import LAUNCHES
from tpukernels_torch.kernels import histogram as _hist
from tpukernels_torch.kernels import scan as _scan
from tpukernels_torch.tuning import SearchSpace, Tunable, resolve

TUNABLES = SearchSpace(
    kernel="scan_histogram",
    tunables=(
        Tunable("fuse", env="TPKT_SCANHIST_FUSE", default="off",
                values=("off", "on"), choice=True),
    ),
)

_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
)


def scan_histogram(x, nbins: int):
    """``(inclusive_scan(x), histogram(x, nbins))`` of ``x`` cast to
    int32: a new (n,) and a new (nbins,) int32 tensor."""
    nbins = _hist.check_nbins(nbins)
    fuse = resolve(TUNABLES)["fuse"]
    x = _hist.as_int32(x)
    if fuse == "off":
        return _scan.inclusive_scan(x), _hist.histogram(x, nbins)
    if x.device.type == "cpu":
        return scan_histogram_plain(x, nbins)
    if x.device.type != "cuda":
        raise ValueError(f"scan_histogram: unsupported device {x.device}")
    return _fused_cuda(x, nbins, _scan.resolve_tile())


def _fused_cuda(x, nbins, tile):
    n = x.numel()
    out = torch.empty_like(x)
    hist = torch.zeros(nbins, dtype=torch.int32, device=x.device)
    if n == 0:  # a grid of 0 blocks is a launch error
        return out, hist
    state = _scan.scan_state(n, tile, x.device)
    fn = _build.function("scan_histogram", "tpkt_scan_histogram", _ARGTYPES)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), out.data_ptr(), hist.data_ptr(),
                state.data_ptr(), n, nbins, tile // _scan.TILES[0],
                _build.stream_of(x))
    LAUNCHES["scan_histogram"] += 1
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
