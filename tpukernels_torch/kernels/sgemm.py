"""SGEMM: out = alpha * A @ B + beta * C for float32 matrices of any shape.

Port of ``tpukernels/kernels/sgemm.py``. On a CUDA tensor the wrapper
launches one of two entries, as the reference's ``depth`` knob picks,
both instantiations of one kernel (``csrc/sgemm_ring.cuh``: a ring of
shared-memory stages filled by TMA, feeding ``wgmma`` in every mode):

- depth 1: ``csrc/sgemm.cu`` (replaces the TPU's ``_sgemm_kernel``),
  two stages, as the reference's depth 1 is double-buffered by Pallas;
- depth 2 or 3: ``csrc/sgemm_pipelined.cu`` (replaces
  ``_sgemm_pipelined_kernel``), ``depth`` stages. The reference's depth
  2 is a hand-made ring of two slots, so depth 2 at one tile is the
  instantiation depth 1 runs; depth 3 is the ring depth 1 does not have.

Each output is one accumulator summed over k in the same order whatever
the stage count, so at the same tile, mode and order the two entries
agree bitwise, at every depth. On a CPU tensor the wrapper runs
:func:`sgemm_plain`, the same arithmetic in plain PyTorch;
:func:`sgemm_reference` is the oracle.

Knobs (``TUNABLES``), per knob env ``TPKT_SGEMM_{BM,BN,BK,DEPTH,ORDER}``
> a tuning-cache entry for (shape, dtype, card) > the default: tile
preferences ``bm``/``bn``/``bk`` (from which :func:`_pick_block` picks
among the tiles the kernel that ``depth`` selects is built for,
:data:`TILES`), ``depth`` 1/2/3 and the grid ``order`` ``ij``/``ji``.
They are resolved and checked on the CPU too.

Precision modes (``precision=`` or env ``TPKT_SGEMM_PRECISION``, read
as the reference reads it and never from the tuning cache, so a tuned
entry cannot change the contract a result is held to):

- ``high`` (default): A and B are split outside the kernel into bf16
  hi/lo halves (``x.to(torch.bfloat16)`` rounds to nearest even, as the
  reference's ``reduce_precision(8, 7)`` does) and the kernel sums
  hi·hi + hi·lo + lo·hi in float32.
- ``float32``: six bf16 products, as the reference's ``float32``
  (bf16 x 6): A and B are split into three bf16 pieces each
  (:func:`_pieces_bf16`, 24 bits together) and the kernel sums a3·b1 +
  a1·b3 + a2·b2 + a2·b1 + a1·b2 + a1·b1 in float32, 64 k at a time in
  the tensor core and those sums with float32 adds.
- ``default``: one bf16 product of A and B rounded to bf16.

:func:`contract` states each mode's tolerance and its reason.

Both entries take their operands as :func:`operands` makes them: bf16,
rows of whole 16 bytes (TMA's global strides need them), B transposed,
so that every tile is copied along its rows. On a CUDA tensor one more
hand-written launch (``csrc/sgemm_prep.cu``) makes them, split,
transpose and padding at once; on a CPU tensor :func:`operands_plain`
does, its plain version.

Bound on the card at 1024³: operations; see the notes in ``sgemm.cu``
and ``sgemm_pipelined.cu``.
"""

from __future__ import annotations

import ctypes
import math
import os
import threading

import torch

from tpukernels_torch import _build
from tpukernels_torch.kernels import count_launch
from tpukernels_torch.tuning import (SMEM_BUDGET_BYTES, SearchSpace, Tunable,
                                     plan_memo, resolve)
from tpukernels_torch.utils import cdiv

PRECISIONS = ("high", "float32", "default")
_MODE = {"high": (0, "split3"), "float32": (1, "float32"),
         "default": (2, "bf16")}
# bf16 matrices an operand is given as
_PIECES = {"high": 2, "float32": 3, "default": 1}

# (bm, bn, bk sizes) each entry is built for, every combination in every
# mode: depth 1 csrc/sgemm.cu, depths 2/3 csrc/sgemm_pipelined.cu, one
# kernel (csrc/sgemm_ring.cuh) and so one set; bk is one 128-byte
# swizzled row of bf16
TILES = {1: ((128, 64), (128, 64), (64,)),
         2: ((128, 64), (128, 64), (64,))}
# the knobs' sweep values: every size some kernel builds
BM_SIZES, BN_SIZES, BK_SIZES = (128, 64), (128, 64), (64,)
DEPTHS, ORDERS = (1, 2, 3), ("ij", "ji")


def tiles(depth: int) -> tuple:
    """(bm, bn, bk sizes) built by the kernel ``depth`` selects."""
    return TILES[1 if depth == 1 else 2]


def _smem_bytes(params, shape=None, precision="high"):
    """Shared memory a block of the kernel ``params["depth"]`` selects
    needs for the knob set ``params`` (shape-blind, as the reference's
    VMEM model): its stages of NOPS·(bm + bn)·64 bf16 (NOPS 2 for the
    hi/lo pairs of ``high``, 3 for the pieces of ``float32``, 1 for
    ``default``), plus 1024 bytes to align the ring for the 128-byte
    swizzle and two 8-byte mbarriers a stage.

    - depth 1 (``sgemm.cu``): two stages, as the reference's ``buf = 2``
      at depth 1, of the largest tile it builds within the preferences
      (the smallest where none is);
    - depth 2/3 (``sgemm_pipelined.cu``): ``depth`` stages of the
      ``bm``/``bn`` preferences as given (one under the smallest built
      size counts as that size), so a preference no tile could serve is
      refused before a tile is picked.

    ``high`` is the precision of record, so it is the default the space
    prunes by. Split3 at 128 x 64, depth 1 or 2, takes 99 360 B; at
    128 x 128, depth 3, 197 680 B, one block a SM. ``float32`` at
    128 x 128 fits two stages (197 664 B) and not three (295 984 B)."""
    depth = max(1, params.get("depth", 1))
    nops = _PIECES[precision]
    bms, bns, bks = tiles(depth)
    if depth == 1:
        bm, bn = (_pick_block(1 << 30, params[k], sizes)
                  for k, sizes in (("bm", bms), ("bn", bns)))
    else:
        bm, bn = (max(params[k], min(sizes))
                  for k, sizes in (("bm", bms), ("bn", bns)))
    stages = max(depth, 2)
    return stages * nops * (bm + bn) * bks[0] * 2 + 1024 + 16 * stages


TUNABLES = SearchSpace(
    kernel="sgemm",
    metric="sgemm_gflops",
    bench_shape=(1024, 1024, 1024),
    bench_dtype="float32",
    sources=("tpukernels_torch/kernels/sgemm.py",
             "tpukernels_torch/csrc/sgemm_ring.cuh",
             "tpukernels_torch/csrc/hopper.cuh",
             "tpukernels_torch/csrc/sgemm.cu",
             "tpukernels_torch/csrc/sgemm_pipelined.cu",
             "tpukernels_torch/csrc/sgemm_prep.cu"),
    tunables=(
        # 128 x 64 gives 128 blocks at 1024^2 for 132 SMs, at every depth
        Tunable("bm", env="TPKT_SGEMM_BM", default=128, values=BM_SIZES),
        Tunable("bn", env="TPKT_SGEMM_BN", default=64, values=BN_SIZES),
        Tunable("bk", env="TPKT_SGEMM_BK", default=64, values=BK_SIZES),
        # 1: sgemm.cu, two stages; 2/3: sgemm_pipelined.cu, `depth` stages
        Tunable("depth", env="TPKT_SGEMM_DEPTH", default=1, values=DEPTHS,
                most=DEPTHS[-1]),
        Tunable("order", env="TPKT_SGEMM_ORDER", default="ij",
                values=ORDERS, choice=True),
    ),
    smem_budget_bytes=SMEM_BUDGET_BYTES,
    smem_bytes=_smem_bytes,
)

# (mode, a0, a1, b0, b1, c, out, M, N, K, lda, ldb, alpha, beta, bm, bn,
# bk, [depth,] ji, stream): the entries of sgemm.cu and
# sgemm_pipelined.cu, by depth
_HEAD = (ctypes.c_int,) + (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 5 + (
    ctypes.c_float,) * 2 + (ctypes.c_int,) * 3
_ENTRIES = {
    1: ("sgemm", "tpkt_sgemm", _HEAD + (ctypes.c_int, ctypes.c_void_p)),
    2: ("sgemm_pipelined", "tpkt_sgemm_pipelined",
        _HEAD + (ctypes.c_int, ctypes.c_int, ctypes.c_void_p)),
}
# (mode, a, a's strides, b, b's strides, a0, a1, b0, b1, m, k, n, lda,
# ldb, stream): the entry of sgemm_prep.cu
_PREP_ARGTYPES = ((ctypes.c_int,)
                  + (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong) * 2
                  + (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 5
                  + (ctypes.c_void_p,))


def contract(precision: str, k: int, alpha: float) -> tuple:
    """(rtol, atol) each mode is held to against :func:`sgemm_reference`
    for operands of unit scale, at inner dimension ``k``.

    - ``high``: rtol 1e-3 / atol 1e-3, the C golden checker's bar.
    - ``float32``: rtol 2e-5; atol 2.5e-7·k·max(|alpha|, 1). Summing k
      unit-scale products in fp32 one after another errs by about
      2^-23/sqrt(12)·k/sqrt(2) ≈ 2.4e-8·k (std), so the atol is ~10
      stds; it covers the elements near zero that rtol cannot. The six
      bf16 products leave out terms of 2^-24 a product.
    - ``default``: rtol 1e-2; atol 2^-5·sqrt(k)·max(|alpha|, 1).
      Rounding both operands to bf16 (unit roundoff 2^-8) gives each
      product a relative error of std ~0.0032, so a length-k dot
      product errs by ~0.0032·sqrt(k) (std); the atol is ~10 stds.
    """
    scale = max(abs(alpha), 1.0)
    if precision == "high":
        return 1e-3, 1e-3
    if precision == "float32":
        return 2e-5, 2.5e-7 * max(k, 1) * scale
    if precision == "default":
        return 1e-2, 2.0 ** -5 * math.sqrt(max(k, 1)) * scale
    raise ValueError(f"precision={precision!r}")


def _resolve_precision(precision):
    """``precision``, else env ``TPKT_SGEMM_PRECISION``, else ``high``;
    anything else raises, naming where it came from."""
    if precision is None:
        precision = os.environ.get("TPKT_SGEMM_PRECISION", "high")
        where = "TPKT_SGEMM_PRECISION"
    else:
        where = "precision"
    if precision not in PRECISIONS:
        raise ValueError(
            f"{where}={precision!r}: expected 'high' (bf16 x3 split), "
            "'float32' (full fp32), or 'default' (single-pass bf16)"
        )
    return precision


def _pick_block(dim: int, preferred: int, sizes) -> int:
    """Tile size for ``dim`` among ``sizes`` no larger than
    ``preferred`` (the smallest size when none is): the reference's rule
    among the sizes the kernels are built for. Of those whose padded
    total is within ~9 % of the least, the one giving the FEWEST blocks,
    then the least padding. Given the reference's aligned range
    (``range(align, ..., align)``) it picks what the reference picks for
    any dim above ``align``."""
    cands = sorted(s for s in sizes if s <= preferred) or [min(sizes)]
    padded = lambda b: cdiv(dim, b) * b  # noqa: E731
    pad_min = min(padded(b) for b in cands)
    ok = [b for b in cands if padded(b) <= pad_min * 1.09]
    nb_min = min(cdiv(dim, b) for b in ok)
    return min((b for b in ok if cdiv(dim, b) == nb_min), key=padded)


def plan(m: int, n: int, k: int, precision: str = "high", device=None):
    """The resolved knobs of one (m, k) @ (k, n) call: ``bm``/``bn``/
    ``bk`` the tile picked among those of the kernel ``depth`` selects,
    ``depth``, ``order``. Raises ValueError when the knob set needs more
    shared memory than a block has."""
    prefs = resolve(TUNABLES, shape=(m, k, n), dtype="float32",
                    device=device)
    need = _smem_bytes(prefs, precision=precision)
    if need > SMEM_BUDGET_BYTES:
        knobs = ", ".join(f"TPKT_SGEMM_{t.upper()}={prefs[t]}"
                          for t in ("bm", "bn", "bk", "depth"))
        raise ValueError(
            f"sgemm: the knobs {knobs} need {need} bytes of shared memory "
            f"a block in '{precision}' mode, over the {SMEM_BUDGET_BYTES} "
            "a block of the card can use"
        )
    bms, bns, bks = tiles(prefs["depth"])
    return {
        "bm": _pick_block(m, prefs["bm"], bms),
        "bn": _pick_block(n, prefs["bn"], bns),
        "bk": _pick_block(k, prefs["bk"], bks),
        "depth": prefs["depth"],
        "order": prefs["order"],
    }


def _split_bf16(x):
    """x ≈ hi + lo, both bf16: hi the top 8 significant bits (rounded to
    nearest even), lo the next 8."""
    hi = x.to(torch.bfloat16)
    lo = (x - hi).to(torch.bfloat16)  # hi widens exactly to float32
    return hi, lo


def _pieces_bf16(x):
    """x ≈ x1 + x2 + x3, all bf16: each the remainder so far rounded to
    nearest even, 24 significant bits together; stacked (3, rows, cols).
    The first two are :func:`_split_bf16`'s."""
    out = []
    for _ in range(3):
        out.append(x.to(torch.bfloat16))
        x = x - out[-1]  # exact: a piece widens exactly to float32
    return torch.stack(out)


def _whole_rows(t, mult):
    """``t`` (rows, cols) contiguous and 16-byte aligned, its rows padded
    with zeros to a multiple of ``mult`` elements (a copy only when
    needed)."""
    rows, cols = t.shape
    width = cdiv(cols, mult) * mult
    if width == cols and t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    out = t.new_zeros((rows, width))
    out[:, :cols] = t
    return out


def _check(a, b, c):
    for name, t in (("a", a), ("b", b), ("c", c)):
        if t.dtype != torch.float32 or t.dim() != 2:
            raise TypeError(
                f"sgemm: {name} must be a 2-D float32 tensor, got "
                f"{t.dtype} {tuple(t.shape)}"
            )
    m, k = a.shape
    k2, n = b.shape
    if k != k2 or tuple(c.shape) != (m, n):
        raise ValueError(
            f"sgemm: shapes a{tuple(a.shape)} b{tuple(b.shape)} "
            f"c{tuple(c.shape)} do not chain"
        )
    if not (a.device == b.device == c.device):
        raise ValueError("sgemm: a, b and c must be on one device")
    return m, n, k


def sgemm(alpha, a, b, beta, c, precision: str | None = None):
    """alpha*A@B + beta*C as a new (m, n) float32 tensor."""
    m, n, k = _check(a, b, c)
    precision = _resolve_precision(precision)
    p = launch_plan(m, n, k, precision, a.device)
    if a.device.type == "cpu":
        return sgemm_plain(alpha, a, b, beta, c, precision)
    if a.device.type != "cuda":
        raise ValueError(f"sgemm: unsupported device {a.device}")
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if m == 0 or n == 0:
        return out
    # buf holds the operands until the kernel that reads them is enqueued
    buf, ptrs, kp = _prepare(a, b, precision)
    return _launch(float(alpha), ptrs, kp, float(beta), c.contiguous(), out,
                   precision, p)


def launch_plan(m: int, n: int, k: int, precision: str, device) -> dict:
    """:func:`plan` of an (m, k) @ (k, n) call on ``device``, memoised
    (:func:`tuning.plan_memo`)."""
    return plan_memo(TUNABLES, (m, n, k, precision, device.index), plan, m,
                     n, k, precision, device)


def operands(a, b, precision):
    """``(ops, kp)`` as the kernels take them: four bf16 operands (None
    where a mode has fewer) whose rows are whole 16-byte chunks, and the
    inner dimension they walk, kp = k padded with zeros to a multiple of
    8.

    - ``high``: A hi, A lo (m, kp), B^T hi, B^T lo (n, kp);
    - ``default``: A (m, kp), None, B^T (n, kp), None;
    - ``float32``: the three pieces of A one after another (3m, kp),
      None, those of B^T (3n, kp), None.

    The split into bf16 halves stays outside the matrix kernel, as the
    reference keeps ``_split_bf16`` outside its Pallas kernel: on CUDA
    tensors one launch of ``csrc/sgemm_prep.cu`` writes all the
    operands (:func:`_prepare`); on CPU tensors :func:`operands_plain`
    makes them. The two agree bitwise for finite inputs."""
    if a.device.type != "cuda":
        return operands_plain(a, b, precision)
    buf, _, kp = _prepare(a, b, precision)
    m, n = a.shape[0], b.shape[1]
    if precision == "high":
        return buf.split((m, m, n, n)), kp
    parts = _PIECES[precision]
    a0, b0 = buf.split((parts * m, parts * n))
    return (a0, None, b0, None), kp


def _prepare(a, b, precision):
    """``(buf, ptrs, kp)``: the operands of :func:`operands` for CUDA
    tensors, written by one launch of ``tpkt_sgemm_prep``: the tensor
    that holds them, the four device addresses (None where a mode has
    fewer) and the row length. The operands lie one after another in one
    allocation, each starting at a whole row of kp·2 bytes, a multiple
    of 16."""
    (m, k), n = a.shape, b.shape[1]
    kp = cdiv(k, 8) * 8
    parts = _PIECES[precision]
    buf = torch.empty((parts * (m + n), kp), dtype=torch.bfloat16,
                      device=a.device)
    base, row = buf.data_ptr(), 2 * kp
    if precision == "high":
        ptrs = (base, base + m * row, base + 2 * m * row,
                base + (2 * m + n) * row)
    else:
        ptrs = (base, None, base + parts * m * row, None)
    if k > 0:  # with k = 0 there is nothing to write
        fn = _build.function("sgemm_prep", "tpkt_sgemm_prep", _PREP_ARGTYPES)
        rc = _build.launch(fn, a, _MODE[precision][0], a.data_ptr(),
                           a.stride(0), a.stride(1), b.data_ptr(),
                           b.stride(0), b.stride(1), *ptrs, m, k, n, kp, kp)
        count_launch("sgemm_prep")
        _build.check(rc, f"tpkt_sgemm_prep[{precision}]")
    return buf, ptrs, kp


def operands_plain(a, b, precision):
    """Plain PyTorch version of the operand preparation: what
    :func:`operands` returns, made with tensor ops; any device."""
    bt = b.t().contiguous()
    if precision == "high":
        ops = (*_split_bf16(a.contiguous()), *_split_bf16(bt))
    elif precision == "float32":
        m, n, k = *a.shape[:1], *bt.shape
        ops = (_pieces_bf16(a).reshape(3 * m, k), None,
               _pieces_bf16(bt).reshape(3 * n, k), None)
    else:
        ops = (a.to(torch.bfloat16), None, bt.to(torch.bfloat16), None)
    ops = tuple(None if t is None else _whole_rows(t, 8) for t in ops)
    return ops, ops[0].shape[1]  # the pad adds zero products


def launch(alpha, ops, kp, beta, c, out, precision, p):
    """out = alpha * A @ B + beta * c by the entry ``p["depth"]``
    selects, on ``(ops, kp)`` as :func:`operands` makes them; ``c`` and
    ``out`` contiguous (m, n) on the operands' card."""
    ptrs = [None if t is None else t.data_ptr() for t in ops]
    return _launch(alpha, ptrs, kp, beta, c, out, precision, p)


def _launch(alpha, ptrs, kp, beta, c, out, precision, p):
    m, n = out.shape
    mode, suffix = _MODE[precision]
    depth = p["depth"]
    lib, entry, argtypes = _ENTRIES[1 if depth == 1 else 2]
    fn = _build.function(lib, entry, argtypes)
    ring = () if depth == 1 else (depth,)
    rc = _build.launch(fn, out, mode, *ptrs, c.data_ptr(), out.data_ptr(), m,
                       n, kp, kp, kp, alpha, beta, p["bm"], p["bn"],
                       p["bk"], *ring, int(p["order"] == "ji"))
    count_launch(f"{lib}_{suffix}")
    _build.check(rc, f"{entry}[{precision}]")
    return out


# one CPU sum at a time may drop the process to one intra-op thread
_ORDERED = threading.Lock()


def _sum_products(pairs):
    """Σ x @ y over ``pairs`` of (m, k) and (k, n) matrices whose
    elementwise products are exact in float64 (bf16 values times values
    of at most 24 significant bits), rounded to float32 once.

    On the CPU the sum is taken in one fixed order in float64: for each
    pair in turn, for each k, ``acc += x[:, k] ⊗ y[k, :]``, one rounding a
    step. Every element's bits then depend only on its own row, column
    and the nonzero k: zero rows, columns or k appended to the operands
    (the serving daemon pads a request up to its bucket) change none of
    them. A BLAS ``@`` gives no such promise: its k order follows the
    shape and the thread count. The steps run on one intra-op thread:
    thousands of small parallel regions stall when other processes hold
    the cores. On the card the sum is one ``@`` a pair, which relies on
    ``torch.backends.cuda.matmul.allow_tf32`` being False (PyTorch's
    default)."""
    x0, y0 = pairs[0]
    if x0.device.type != "cpu":
        return sum(x @ y for x, y in pairs)
    x = torch.cat([x for x, _ in pairs], dim=1).double()
    y = torch.cat([y for _, y in pairs], dim=0).double()
    acc = x.new_zeros((x0.shape[0], y0.shape[1]))
    with _ORDERED:
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            for j in range(x.shape[1]):
                acc.addcmul_(x[:, j:j + 1], y[j:j + 1])
        finally:
            torch.set_num_threads(threads)
    return acc.float()


def sgemm_plain(alpha, a, b, beta, c, precision="high"):
    """The kernels' arithmetic in plain PyTorch: the same bf16 split,
    pieces or rounding, and the same products, grouped so that each is
    exact (``high``: ah·(bh + bl) + al·bh; ``float32``: a1·(b1 + b2 + b3)
    + a2·(b1 + b2) + a3·b1) and summed by :func:`_sum_products`, so that
    on the CPU zero padding of the operands leaves the result's bits
    alone."""
    precision = _resolve_precision(precision)
    # the pieces' sums are exact in float64 (in float32 too but for
    # b1 + b2 + b3, which may need 25 bits); the card sums in float32
    wide = torch.float64 if a.device.type == "cpu" else torch.float32
    if precision == "high":
        ah, al = (t.to(wide) for t in _split_bf16(a))
        bh, bl = (t.to(wide) for t in _split_bf16(b))
        acc = _sum_products([(ah, bh + bl), (al, bh)])
    elif precision == "default":
        acc = _sum_products([(a.to(torch.bfloat16).to(wide),
                              b.to(torch.bfloat16).to(wide))])
    else:
        a1, a2, a3 = _pieces_bf16(a).to(wide)
        b1, b2, b3 = _pieces_bf16(b).to(wide)
        acc = _sum_products([(a1, b1 + b2 + b3), (a2, b1 + b2), (a3, b1)])
    return alpha * acc + beta * c


def sgemm_reference(alpha, a, b, beta, c):
    """Oracle: the product in float64, rounded to float32 once at the
    end, so it does not depend on the device's float32 matmul mode."""
    d = a.double() @ b.double()
    return (alpha * d + beta * c.double()).float()
