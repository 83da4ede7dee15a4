"""SGEMM: out = alpha * A @ B + beta * C for float32 matrices of any shape.

Port of ``tpukernels/kernels/sgemm.py``. On a CUDA tensor the wrapper
launches one of two kernels, as the reference's ``depth`` knob picks:

- depth 1: ``csrc/sgemm.cu`` (replaces the TPU's ``_sgemm_kernel``),
  the K blocks through two shared-memory stages filled by TMA (the
  reference's depth 1 is double-buffered too), ``wgmma`` for the bf16
  modes and fp32 FMAs for ``float32``;
- depth 2 or 3: ``csrc/sgemm_pipelined.cu`` (replaces
  ``_sgemm_pipelined_kernel``), the K blocks through a ring of
  ``depth`` stages filled by cp.async, ``mma.sync`` for the bf16 modes.

The two sum in different orders, so they agree within
:func:`contract`, not bitwise. On a CPU tensor it runs
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
- ``float32``: full fp32 on the CUDA cores.
- ``default``: one bf16 product of A and B rounded to bf16.

:func:`contract` states each mode's tolerance and its reason.

Both kernels take their operands as :func:`operands` makes them: rows of
whole 16 bytes (TMA's global strides and cp.async's copies need them),
B transposed for the bf16 modes and A transposed for ``float32``, so
that every tile is copied along its rows.

Bound on the card at 1024³: operations; see the notes in ``sgemm.cu``
and ``sgemm_pipelined.cu``.
"""

from __future__ import annotations

import ctypes
import math
import os

import torch

from tpukernels_torch import _build
from tpukernels_torch.kernels import LAUNCHES
from tpukernels_torch.tuning import (SMEM_BUDGET_BYTES, SearchSpace, Tunable,
                                     plan_memo, resolve)
from tpukernels_torch.utils import cdiv

PRECISIONS = ("high", "float32", "default")
_MODE = {"high": (0, "split3"), "float32": (1, "float32"),
         "default": (2, "bf16")}

# (bm, bn, bk sizes) each kernel is built for, every combination in
# every mode (each size added costs build time): depth 1 csrc/sgemm.cu,
# depths 2/3 csrc/sgemm_pipelined.cu (csrc/sgemm.cuh)
TILES = {1: ((128, 64), (128, 64), (64,)),
         2: ((128, 64), (128,), (32, 64))}
# the knobs' sweep values: every size some kernel builds
BM_SIZES, BN_SIZES, BK_SIZES = (128, 64), (128, 64), (32, 64)
DEPTHS, ORDERS = (1, 2, 3), ("ij", "ji")


def tiles(depth: int) -> tuple:
    """(bm, bn, bk sizes) built by the kernel ``depth`` selects."""
    return TILES[1 if depth == 1 else 2]


def _smem_bytes(params, shape=None, precision="high"):
    """Shared memory a block of the kernel ``params["depth"]`` selects
    needs for the knob set ``params`` (shape-blind, as the reference's
    VMEM model).

    - depth 1 (``sgemm.cu``): the largest tile it builds within the
      preferences (the smallest where none is), in two stages, as the
      reference's ``buf = 2`` at depth 1, of NOPS·(bm + bn)·bk elements
      (NOPS 2 for the hi/lo pairs of ``high``; bf16, or fp32 for
      ``float32``), plus 1024 bytes to align the ring for the 128-byte
      swizzle and two 8-byte mbarriers a stage;
    - depth 2/3 (``sgemm_pipelined.cu``): the preferences as given (one
      under the smallest built size counts as that size), ``depth``
      stages of NOPS·(bm + bn)·(bk + 8)·2 bytes (bf16 rows padded by 8),
      or bk·(bm + 4 + bn)·4 for ``float32`` (A^T rows padded by 4).

    ``high`` needs the most in the bf16 modes, so it is the default the
    space prunes by. Split3 at 128 x 64 x 64, depth 1, takes 99 360 B;
    at 128 x 128 x 32, depth 2, 81 920 B."""
    depth = max(1, params.get("depth", 1))
    nops = 2 if precision == "high" else 1
    if depth == 1:
        bm, bn, bk = (_pick_block(1 << 30, params[k], sizes)
                      for k, sizes in zip(("bm", "bn", "bk"), tiles(1)))
        elem = 4 if precision == "float32" else 2
        return 2 * nops * (bm + bn) * bk * elem + 1024 + 2 * 2 * 8
    bm, bn, bk = (max(params[k], min(sizes))
                  for k, sizes in zip(("bm", "bn", "bk"), tiles(depth)))
    if precision == "float32":
        stage = bk * (bm + 4 + bn) * 4
    else:
        stage = nops * (bm + bn) * (bk + 8) * 2
    return depth * stage


TUNABLES = SearchSpace(
    kernel="sgemm",
    bench_shape=(1024, 1024, 1024),
    bench_dtype="float32",
    sources=("tpukernels_torch/kernels/sgemm.py",
             "tpukernels_torch/csrc/sgemm.cuh",
             "tpukernels_torch/csrc/hopper.cuh",
             "tpukernels_torch/csrc/sgemm.cu",
             "tpukernels_torch/csrc/sgemm_pipelined.cu"),
    tunables=(
        # depth 1 at 128 x 64 gives 128 blocks at 1024^2 for 132 SMs;
        # depth 2/3 builds bn 128 only, so it keeps 128 x 128
        Tunable("bm", env="TPKT_SGEMM_BM", default=128, values=BM_SIZES),
        Tunable("bn", env="TPKT_SGEMM_BN", default=64, values=BN_SIZES),
        Tunable("bk", env="TPKT_SGEMM_BK", default=32, values=BK_SIZES),
        # 1: sgemm.cu, TMA + wgmma, two stages; 2/3: sgemm_pipelined.cu
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


def contract(precision: str, k: int, alpha: float) -> tuple:
    """(rtol, atol) each mode is held to against :func:`sgemm_reference`
    for operands of unit scale, at inner dimension ``k``.

    - ``high``: rtol 1e-3 / atol 1e-3, the C golden checker's bar.
    - ``float32``: rtol 2e-5; atol 2.5e-7·k·max(|alpha|, 1). Summing k
      unit-scale products in fp32 one after another errs by about
      2^-23/sqrt(12)·k/sqrt(2) ≈ 2.4e-8·k (std), so the atol is ~10
      stds; it covers the elements near zero that rtol cannot.
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
    p = plan_memo(TUNABLES, (m, n, k, precision, a.device.index), plan, m,
                  n, k, precision, a.device)
    if a.device.type == "cpu":
        return sgemm_plain(alpha, a, b, beta, c, precision)
    if a.device.type != "cuda":
        raise ValueError(f"sgemm: unsupported device {a.device}")
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if m == 0 or n == 0:
        return out
    ops, kp = operands(a, b, precision)
    return launch(float(alpha), ops, kp, float(beta), c.contiguous(), out,
                  precision, p)


def operands(a, b, precision):
    """``(ops, k)`` as the kernels take them: four operands (None where
    a mode has fewer) whose rows are whole 16-byte chunks, and the inner
    dimension they walk.

    - bf16 modes: A (m, kp) and B^T (n, kp), bf16 (hi/lo pairs for
      ``high``), kp = k padded with zeros to a multiple of 8;
    - ``float32``: A^T (k, m4) and B (k, n4), m and n padded with zeros
      to multiples of 4; k itself.

    The split into bf16 halves stays here, outside the kernel, as the
    reference keeps ``_split_bf16`` outside its Pallas kernel.
    """
    if precision == "float32":
        return (_whole_rows(a.t(), 4), None, _whole_rows(b, 4), None), \
            a.shape[1]
    bt = b.t().contiguous()
    if precision == "high":
        ops = (*_split_bf16(a.contiguous()), *_split_bf16(bt))
    else:
        ops = (a.to(torch.bfloat16), None, bt.to(torch.bfloat16), None)
    ops = tuple(None if t is None else _whole_rows(t, 8) for t in ops)
    return ops, ops[0].shape[1]  # the pad adds zero products


def launch(alpha, ops, kp, beta, c, out, precision, p):
    """out = alpha * A @ B + beta * c by the kernel ``p["depth"]``
    selects, on ``(ops, kp)`` as :func:`operands` makes them; ``c`` and
    ``out`` contiguous (m, n) on the operands' card."""
    m, n = out.shape
    mode, suffix = _MODE[precision]
    lda, ldb = ops[0].shape[1], ops[2].shape[1]
    ptrs = [None if t is None else t.data_ptr() for t in ops]
    depth = p["depth"]
    lib, entry, argtypes = _ENTRIES[1 if depth == 1 else 2]
    fn = _build.function(lib, entry, argtypes)
    ring = () if depth == 1 else (depth,)
    rc = _build.launch(fn, out, mode, *ptrs, c.data_ptr(), out.data_ptr(), m,
                       n, kp, lda, ldb, alpha, beta, p["bm"], p["bn"],
                       p["bk"], *ring, int(p["order"] == "ji"))
    LAUNCHES[f"{lib}_{suffix}"] += 1
    _build.check(rc, f"{entry}[{precision}]")
    return out


def sgemm_plain(alpha, a, b, beta, c, precision="high"):
    """The kernels' arithmetic in plain PyTorch: the same bf16 split or
    rounding, products taken in float32. On the card this relies on
    ``torch.backends.cuda.matmul.allow_tf32`` being False (PyTorch's
    default)."""
    precision = _resolve_precision(precision)
    if precision == "high":
        ah, al = (t.float() for t in _split_bf16(a))
        bh, bl = (t.float() for t in _split_bf16(b))
        acc = ah @ bh + ah @ bl + al @ bh
    elif precision == "default":
        acc = a.to(torch.bfloat16).float() @ b.to(torch.bfloat16).float()
    else:
        acc = a @ b
    return alpha * acc + beta * c


def sgemm_reference(alpha, a, b, beta, c):
    """Oracle: the product in float64, rounded to float32 once at the
    end, so it does not depend on the device's float32 matmul mode."""
    d = a.double() @ b.double()
    return (alpha * d + beta * c.double()).float()
