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

Bound on the card: bytes (4 read and 4 written per element).
"""

from __future__ import annotations

import ctypes

import torch

from tpukernels_torch import _build
from tpukernels_torch.kernels import LAUNCHES
from tpukernels_torch.tuning import SearchSpace, Tunable, resolve
from tpukernels_torch.utils import cdiv

# elements per tile of the kernel: 1024 (one 16-byte load for each of
# 256 threads) times 1, 2, 4, 8 or 16. The largest is the fastest on the
# H100 at 2^22 and 2^26 int32 (chip_smoke.py's per-tile device times,
# PERF.md): more loads in flight a thread, fewer look-backs.
TILES = (1024, 2048, 4096, 8192, 16384)
TUNABLES = SearchSpace(
    kernel="scan",
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


def check_length(name: str, x) -> None:
    if x.numel() > MAX_N:
        raise ValueError(f"{name}: {x.numel()} elements; at most {MAX_N}")


def _flat(x):
    if x.dtype not in DTYPES:
        raise TypeError(f"scan takes float32 or int32, got {x.dtype}")
    check_length("scan", x)
    return x.reshape(-1).contiguous()


def inclusive_scan(x):
    """Inclusive prefix sum of float32 or int32 values (flattened); a new
    1-D tensor of the input's dtype on its device."""
    x = _flat(x)
    if x.device.type == "cpu":
        return scan_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"scan: unsupported device {x.device}")
    return _scan_cuda(x, resolve_tile(x))


def exclusive_scan(x):
    """out[i] = sum(x[:i]), out[0] = 0: the inclusive result shifted right
    by one element, as the reference derives it (no kernel of its own)."""
    incl = inclusive_scan(x)
    out = torch.empty_like(incl)
    if incl.numel():
        out[0] = 0
        out[1:] = incl[:-1]
    return out


def scan_state(n: int, tile: int, device):
    """The look-back's zeroed scratch: a tile counter and one status word
    per tile, 64 bits each."""
    return torch.zeros(cdiv(n, tile) + 1, dtype=torch.int64, device=device)


def _scan_cuda(x, tile):
    n = x.numel()
    out = torch.empty_like(x)
    if n == 0:  # a grid of 0 blocks is a launch error
        return out
    state = scan_state(n, tile, x.device)
    fn = _build.function("scan", "tpkt_scan", _ARGTYPES)
    rc = _build.launch(fn, x, x.data_ptr(), out.data_ptr(), state.data_ptr(),
                       n, tile // TILES[0], int(x.dtype == torch.float32))
    LAUNCHES["scan"] += 1
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
