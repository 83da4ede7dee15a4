"""Inclusive and exclusive prefix sums of 1-D float32 or int32.

Port of ``tpukernels/kernels/scan.py``. On a CUDA tensor the wrapper
launches ``csrc/scan.cu`` (replaces the TPU's ``_scan_kernel``); on a
CPU tensor it runs :func:`scan_plain`, the kernel's tile plan in torch
ops. int32 sums wrap mod 2^32, as the reference's do.

The TPU kernel carries the running total from one grid step to the
next in SMEM, because its grid runs in order on one core. CUDA blocks
run in parallel and in no order, so the kernel is a single pass with
decoupled look-back: each block scans one tile of ``TPKT_SCAN_TILE``
elements and takes its carry from the totals its predecessors publish
(see ``csrc/scan.cuh``). That order of the float32 carry sums depends
on timing: float32 results may differ between runs in the last bits.

Bound on the card: bytes (4 read and 4 written per element). At the
size of record (2^22, in the L2) a call is mostly host time, so the host
path is kept short: the tile is memoised (:func:`tile_plan`), and the
look-back's scratch is one buffer per device and stream that the kernel
leaves zeroed (:func:`scratch`), so a call is one launch.
"""

from __future__ import annotations

import ctypes

import torch

from tpukernels_torch import _build
from tpukernels_torch.kernels import count_launch
from tpukernels_torch.tuning import (SearchSpace, Tunable, plan_memo,
                                     resolve)
from tpukernels_torch.utils import cdiv

# elements per tile of the kernel: 1024 (one 16-byte load for each of
# 256 threads) times 1, 2, 4, 8 or 16. The largest is the fastest on the
# H100 at 2^22 and 2^26 int32 (chip_smoke.py's per-tile device times,
# PERF.md): more loads in flight a thread, fewer look-backs.
TILES = (1024, 2048, 4096, 8192, 16384)
TUNABLES = SearchSpace(
    kernel="scan",
    metric="scan_hist_melem_s",
    bench_shape=(1 << 22,),
    bench_dtype="int32",
    sources=("tpukernels_torch/kernels/scan.py",
             "tpukernels_torch/csrc/scan.cu", "tpukernels_torch/csrc/scan.cuh"),
    tunables=(Tunable("tile", env="TPKT_SCAN_TILE", default=16384),),
)
DTYPES = (torch.float32, torch.int32)
# int32 lengths and counts: the kernels index with 64 bits, the
# histograms count in int32
MAX_N = (1 << 31) - 1

_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
)


def resolve_tile(x=None) -> int:
    """The knob ``tile`` for a scan of ``x`` (its cache key: the
    reference's ``(n,)`` and dtype)."""
    key = {} if x is None else {"shape": (x.numel(),), "dtype": x.dtype,
                                "device": x.device}
    tile = resolve(TUNABLES, **key)["tile"]
    if tile not in TILES:
        raise ValueError(
            f"TPKT_SCAN_TILE={tile}: expected one of "
            + ", ".join(map(str, TILES))
        )
    return tile


def tile_plan(x) -> int:
    """:func:`resolve_tile` of ``x``, memoised (:func:`tuning.plan_memo`)
    on its length, dtype and device: it follows a changed
    ``TPKT_SCAN_TILE`` or cache entry on the next call."""
    return plan_memo(TUNABLES, (x.numel(), x.dtype, x.device.type,
                                x.device.index), resolve_tile, x)


def check_length(name: str, x) -> None:
    if x.numel() > MAX_N:
        raise ValueError(f"{name}: {x.numel()} elements; at most {MAX_N}")


def _flat(x):
    if x.dtype not in DTYPES:
        raise TypeError(f"scan takes float32 or int32, got {x.dtype}")
    check_length("scan", x)
    if x.dim() != 1 or not x.is_contiguous():
        x = x.reshape(-1).contiguous()
    return x


def inclusive_scan(x):
    """Inclusive prefix sum of float32 or int32 values (flattened); a new
    1-D tensor of the input's dtype on its device."""
    x = _flat(x)
    if x.device.type == "cpu":
        return scan_plain(x, tile_plan(x))
    if x.device.type != "cuda":
        raise ValueError(f"scan: unsupported device {x.device}")
    return _scan_cuda(x, tile_plan(x))


def exclusive_scan(x):
    """out[i] = sum(x[:i]), out[0] = 0: the inclusive result shifted right
    by one element, as the reference derives it (no kernel of its own)."""
    incl = inclusive_scan(x)
    out = torch.empty_like(incl)
    if incl.numel():
        out[0] = 0
        out[1:] = incl[:-1]
    return out


# (kind, device index, raw stream) -> a kernel's scratch on that stream
_SCRATCH: dict = {}


def scratch(kind: str, words: int, x, where=None):
    """``(key, buffer)``: at least ``words`` 64-bit words of scratch for
    the kernels of ``kind`` on ``x``'s device and current stream
    (``where``, when the caller has looked them up:
    :func:`_build.device_stream`).

    The kernels that take it need it zero and leave it zero
    (``csrc/scan.cuh``, ``csrc/histogram.cu``), so one buffer per (kind,
    device, stream) serves every call and no call pays a fill launch: it
    is made zeroed on first use, and made anew, larger, when a call
    needs more words. Two streams never share one, so calls in flight on
    two streams do not meet. A caller whose launch fails drops the
    buffer (:func:`drop_scratch`). A buffer made while its stream is
    being captured into a CUDA graph belongs to that graph and is not
    kept: call once on the stream before the capture begins and the
    graph holds the kernel alone."""
    key = (kind, *(where or _build.device_stream(x)))
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < words:
        buf = torch.zeros(max(words, 1024), dtype=torch.int64,
                          device=x.device)
        if not torch.cuda.is_current_stream_capturing():
            _SCRATCH[key] = buf
    return key, buf


def drop_scratch(key) -> None:
    """Forget the scratch of ``key``: a launch on it failed, and what it
    holds is not known."""
    _SCRATCH.pop(key, None)


def scan_state(n: int, tile: int, x, nbins: int = 0, where=None):
    """The look-back's scratch (:func:`scratch`) for a scan of ``n``
    elements in tiles of ``tile``: the tile counter (with the count of
    finished blocks), one status word per tile and, for the fused pass,
    ``nbins`` 32-bit bins."""
    return scratch("scan", cdiv(n, tile) + 1 + cdiv(nbins, 2), x, where)


def _scan_cuda(x, tile):
    n = x.numel()
    out = torch.empty_like(x)
    if n == 0:  # a grid of 0 blocks is a launch error
        return out
    where = _build.device_stream(x)
    key, state = scan_state(n, tile, x, 0, where)
    fn = _build.function("scan", "tpkt_scan", _ARGTYPES)
    rc = _build.launch_at(fn, *where, x.data_ptr(), out.data_ptr(),
                          state.data_ptr(), n, tile // TILES[0],
                          int(x.dtype == torch.float32))
    count_launch("scan")
    if rc != 0:
        drop_scratch(key)
    _build.check(rc, "tpkt_scan")
    return out


def scan_plain(x, tile: int | None = None):
    """Plain PyTorch version: the kernel's plan of tiles of ``tile``
    elements (``TPKT_SCAN_TILE`` by default) and a ragged last tile, each
    scanned alone, plus the carry of the tiles before it; any device."""
    tile = resolve_tile(x) if tile is None else tile
    x = x.reshape(-1)
    full = x.numel() // tile * tile
    parts = []
    if full:
        parts.append(torch.cumsum(x[:full].view(-1, tile), 1, dtype=x.dtype))
    if full < x.numel():
        parts.append(torch.cumsum(x[full:], 0, dtype=x.dtype)[None])
    if not parts:
        return x.clone()
    totals = torch.cat([p[:, -1] for p in parts])
    carry = torch.cat([totals.new_zeros(1),
                       torch.cumsum(totals, 0, dtype=x.dtype)[:-1]])
    return torch.cat([(p + c[:, None]).reshape(-1) for p, c in
                      zip(parts, carry.split([len(p) for p in parts]))])


def inclusive_scan_reference(x):
    """Oracle (mirrors the serial-C running sum); int32 stays int32."""
    return torch.cumsum(x.reshape(-1), 0, dtype=x.dtype)


def exclusive_scan_reference(x):
    """Oracle: the inclusive oracle shifted right, a leading zero."""
    c = inclusive_scan_reference(x)
    return torch.cat([c.new_zeros(min(c.numel(), 1)), c[:-1]])
