"""SGEMM: out = alpha * A @ B + beta * C for float32 matrices of any shape.

Port of ``tpukernels/kernels/sgemm.py``. On a CUDA tensor the wrapper
launches ``csrc/sgemm.cu`` (replaces the TPU's ``_sgemm_kernel``); on a
CPU tensor it runs :func:`sgemm_plain`, the same arithmetic in plain
PyTorch. :func:`sgemm_reference` is the oracle.

Precision modes (``precision=`` or env ``TPKT_SGEMM_PRECISION``):

- ``high`` (default): A and B are split outside the kernel into bf16
  hi/lo halves (``x.to(torch.bfloat16)`` rounds to nearest even, as the
  reference's ``reduce_precision(8, 7)`` does) and the kernel sums
  hi·hi + hi·lo + lo·hi in float32.
- ``float32``: full fp32 on the CUDA cores.
- ``default``: one bf16 product of A and B rounded to bf16.

:func:`contract` states each mode's tolerance and its reason.

Ragged shapes are masked inside the kernel, so the wrapper pads
nothing; the bf16 modes hand the kernel B transposed, (n, k), so both
operands load along k.

Bound on the card at 1024³: operations; see the note in ``sgemm.cu``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from tpukernels_torch import _build
from tpukernels_torch.kernels import LAUNCHES
from tpukernels_torch.tuning import SearchSpace, Tunable, resolve

PRECISIONS = ("high", "float32", "default")
_MODE = {"high": (0, "sgemm_split3"), "float32": (1, "sgemm_float32"),
         "default": (2, "sgemm_bf16")}

TUNABLES = SearchSpace(
    kernel="sgemm",
    tunables=(
        Tunable("precision", env="TPKT_SGEMM_PRECISION", default="high",
                values=PRECISIONS, choice=True),
    ),
)

_ARGTYPES = (
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
    ctypes.c_void_p,
)


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
    if precision is None:
        precision = resolve(TUNABLES)["precision"]
    if precision not in PRECISIONS:
        raise ValueError(
            f"precision={precision!r}: expected 'high' (bf16 x3 split), "
            "'float32' (full fp32), or 'default' (single-pass bf16)"
        )
    return precision


def _split_bf16(x):
    """x ≈ hi + lo, both bf16: hi the top 8 significant bits (rounded to
    nearest even), lo the next 8."""
    hi = x.to(torch.bfloat16)
    lo = (x - hi.float()).to(torch.bfloat16)
    return hi, lo


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
    if a.device.type == "cpu":
        return sgemm_plain(alpha, a, b, beta, c, precision)
    if a.device.type != "cuda":
        raise ValueError(f"sgemm: unsupported device {a.device}")
    return _sgemm_cuda(float(alpha), a, b, float(beta), c, precision)


def _sgemm_cuda(alpha, a, b, beta, c, precision):
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if m == 0 or n == 0:
        return out
    c = c.contiguous()
    mode, counter = _MODE[precision]
    if precision == "float32":
        ops = (a.contiguous(), None, b.contiguous(), None)
    else:
        bt = b.t().contiguous()
        if precision == "high":
            ops = (*_split_bf16(a.contiguous()), *_split_bf16(bt))
        else:
            ops = (a.to(torch.bfloat16).contiguous(), None,
                   bt.to(torch.bfloat16), None)
    ptrs = [None if t is None else t.data_ptr() for t in ops]
    fn = _build.function("sgemm", "tpkt_sgemm", _ARGTYPES)
    with torch.cuda.device(a.device):
        rc = fn(mode, *ptrs, c.data_ptr(), out.data_ptr(), m, n, k,
                alpha, beta, _build.stream_of(a))
    LAUNCHES[counter] += 1
    _build.check(rc, f"tpkt_sgemm[{precision}]")
    return out


def sgemm_plain(alpha, a, b, beta, c, precision="high"):
    """The kernel's arithmetic in plain PyTorch: the same bf16 split or
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
