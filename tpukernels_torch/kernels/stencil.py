"""2-D 5-point Jacobi stencil with a Dirichlet boundary.

Port of ``jacobi2d`` in ``tpukernels/kernels/stencil.py``: interior
cells become 0.25 × the sum of their four face neighbours, summed as
((N + S) + W) + E; boundary cells are held fixed. On a CUDA tensor the
wrapper launches ``csrc/jacobi2d.cu`` (replaces both the TPU's
``_jacobi2d_small_kernel`` and ``_jacobi2d_blocked_kernel``) once per
pass of ``k`` fused sweeps; on a CPU tensor it runs
:func:`jacobi2d_plain`. :func:`jacobi2d_reference` is the oracle.

Bound on the card: the fused pass trades HBM bytes (8 per cell per
pass) for on-chip work; see the note in ``jacobi2d.cu``.

``jacobi3d`` (registry key ``stencil3d``) is still to port.
"""

from __future__ import annotations

import ctypes

import torch

from tpukernels_torch import _build
from tpukernels_torch.kernels import LAUNCHES
from tpukernels_torch.tuning import SearchSpace, Tunable, resolve

HALO_MAX = 8  # most sweeps one launch fuses (the kernel's halo)

TUNABLES = SearchSpace(
    kernel="stencil2d",
    tunables=(Tunable("k", env="TPKT_STENCIL_K", default=8),),
)

_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p,
)


def passes(iters: int, k: int) -> list:
    """Sweeps per launch: ``iters = passes·k + remainder``, the
    remainder as a last, shorter pass."""
    full, rem = divmod(int(iters), k)
    return [k] * full + ([rem] if rem else [])


def resolve_k(k=None) -> int:
    """Fusion depth: ``k`` if given, else ``TPKT_STENCIL_K`` (default
    8), clamped to 1..8."""
    if k is None:
        k = resolve(TUNABLES)["k"]
    return max(1, min(int(k), HALO_MAX))


def jacobi2d(x, iters: int, k: int | None = None):
    """Run ``iters`` Jacobi 5-point sweeps on an (h, w) float32 tensor;
    returns a new tensor on the input's device."""
    if x.dtype != torch.float32 or x.dim() != 2:
        raise TypeError(
            f"jacobi2d takes a 2-D float32 tensor, got {x.dtype} "
            f"{tuple(x.shape)}"
        )
    if int(iters) < 0:
        raise ValueError(f"jacobi2d: iters={iters} is negative")
    k = resolve_k(k)
    if x.device.type == "cpu":
        return jacobi2d_plain(x, iters)
    if x.device.type != "cuda":
        raise ValueError(f"jacobi2d: unsupported device {x.device}")
    return _jacobi2d_cuda(x.contiguous(), int(iters), k)


def _jacobi2d_cuda(x, iters, k):
    h, w = x.shape
    plan = passes(iters, k)
    if not plan or x.numel() == 0:
        return x.clone()
    fn = _build.function("jacobi2d", "tpkt_jacobi2d_pass", _ARGTYPES)
    # a pass reads one buffer and writes another (neighbouring blocks
    # still read the old grid); two scratch buffers alternate and x is
    # never written
    bufs = [torch.empty_like(x)]
    if len(plan) > 1:
        bufs.append(torch.empty_like(x))
    src = x
    stream = _build.stream_of(x)
    with torch.cuda.device(x.device):
        for i, sweeps in enumerate(plan):
            dst = bufs[i % 2]
            rc = fn(src.data_ptr(), dst.data_ptr(), h, w, sweeps, stream)
            LAUNCHES["jacobi2d"] += 1
            _build.check(rc, "tpkt_jacobi2d_pass")
            src = dst
    return src


def _sweep(v):
    out = v.clone()
    out[1:-1, 1:-1] = (
        ((v[:-2, 1:-1] + v[2:, 1:-1]) + v[1:-1, :-2]) + v[1:-1, 2:]
    ) * 0.25
    return out


def jacobi2d_plain(x, iters: int):
    """Plain PyTorch sweeps, summed in the kernel's order; bitwise equal
    to the reference's blocked and small paths on the CPU."""
    for _ in range(int(iters)):
        x = _sweep(x)
    return x.clone() if int(iters) == 0 else x


def jacobi2d_reference(x, iters: int):
    """Oracle mirroring the reference's roll-based ``jacobi2d_reference``
    (the serial-C golden variant)."""
    h, w = x.shape
    gr = torch.arange(h, device=x.device).unsqueeze(1)
    gc = torch.arange(w, device=x.device).unsqueeze(0)
    interior = (gr > 0) & (gr < h - 1) & (gc > 0) & (gc < w - 1)
    for _ in range(int(iters)):
        out = 0.25 * (
            torch.roll(x, 1, 0) + torch.roll(x, -1, 0)
            + torch.roll(x, 1, 1) + torch.roll(x, -1, 1)
        )
        x = torch.where(interior, out, x)
    return x
