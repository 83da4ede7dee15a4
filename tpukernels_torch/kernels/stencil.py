"""Jacobi stencils with a Dirichlet boundary: 2-D 5-point and 3-D 7-point.

Port of ``jacobi2d`` and ``jacobi3d`` in ``tpukernels/kernels/stencil.py``.
Interior cells become the mean of their face neighbours, boundary cells
are held fixed.

- 2-D: 0.25 × (((N + S) + W) + E). On a CUDA tensor the wrapper
  launches ``csrc/jacobi2d.cu`` (replaces both the TPU's
  ``_jacobi2d_small_kernel`` and ``_jacobi2d_blocked_kernel``) once per
  pass of ``k`` fused sweeps: one warp a strip of columns and a segment
  of rows, marching down it with the sweeps in registers; the geometry
  is :func:`plan2d`.
- 3-D: ((((z-1 + z+1) + y-1) + y+1) + x-1) + x+1, then × (1/6). On a
  CUDA tensor the wrapper launches ``csrc/jacobi3d.cu`` (replaces both
  ``_jacobi3d_small_kernel`` and ``_jacobi3d_blocked_kernel``) once per
  pass of ``k`` fused sweeps, ``k`` at most :data:`HALO3D_MAX`.

On a CPU tensor each runs its plain version (:func:`jacobi2d_plain`,
:func:`jacobi3d_plain`), summed in the kernel's order, so the kernels,
the plain versions and the JAX package agree bitwise.
:func:`jacobi2d_reference` and :func:`jacobi3d_reference` are the
oracles.

Bound on the card: a single sweep moves 8 bytes per cell and is bound
by HBM; the fused passes trade those bytes for on-chip work (see the
notes in ``jacobi2d.cu`` and ``jacobi3d.cu``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from tpukernels_torch import _build
from tpukernels_torch.kernels import LAUNCHES
from tpukernels_torch.tuning import SearchSpace, Tunable, resolve

HALO_MAX = 8  # most sweeps one 2-D launch fuses (the kernel's halo)
# most sweeps one 3-D launch fuses: the tile and its halo on every side
# must fit one block's shared memory (see jacobi3d.cu)
HALO3D_MAX = 4

TUNABLES = (
    SearchSpace(
        kernel="stencil2d",
        bench_shape=(4096, 4096),
        bench_dtype="float32",
        sources=("tpukernels_torch/kernels/stencil.py",
                 "tpukernels_torch/csrc/jacobi2d.cu"),
        tunables=(Tunable("k", env="TPKT_STENCIL_K", default=8),),
    ),
    SearchSpace(
        kernel="stencil3d",
        bench_shape=(384, 384, 384),
        bench_dtype="float32",
        sources=("tpukernels_torch/kernels/stencil.py",
                 "tpukernels_torch/csrc/jacobi3d.cu"),
        # 3, not HALO3D_MAX: at 3 the tile takes 73.5 KB of shared
        # memory and three blocks share an SM, at 4 only two, and k = 3
        # is the fastest at 384^3 on the H100 (chip_smoke.py's per_k_ms)
        tunables=(Tunable("k", env="TPKT_STENCIL_K", default=3),),
    ),
)
_MOST_K = {2: HALO_MAX, 3: HALO3D_MAX}

_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p,
)
_ARGTYPES3D = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
)


# csrc/jacobi2d.cu's march: a lane holds V columns, a warp LANES lanes
V, LANES = 4, 32
LOAD_W = V * LANES  # columns a warp loads
SEG_MIN = 16  # fewest owned rows a segment
FILL_WARPS = 132 * 8  # warps a launch aims at: 8 a SM on the H100's 132


class Plan2d(NamedTuple):
    """One 2-D pass's launch geometry: a warp loads ``LOAD_W`` columns
    starting ``halo`` before its ``strip`` owned ones, and the ``seg``
    owned rows of its segment with ``sweeps`` rows above and below;
    ``nx`` strips by ``ny`` segments, one warp each."""

    halo: int
    strip: int
    seg: int
    nx: int
    ny: int


def plan2d(h: int, w: int, sweeps: int) -> Plan2d:
    """The geometry ``csrc/jacobi2d.cu``'s ``make_plan`` launches one
    pass of ``sweeps`` sweeps of an (h, w) grid with: the halo is
    ``sweeps`` rounded up to ``V``; segments are cut so the launch has
    about ``FILL_WARPS`` warps, none under ``SEG_MIN`` rows."""
    halo = -(-sweeps // V) * V
    strip = LOAD_W - 2 * halo
    nx = -(-w // strip)
    seg = max(SEG_MIN, -(-h // max(1, FILL_WARPS // nx)))
    return Plan2d(halo, strip, seg, nx, -(-h // seg))


@functools.lru_cache(maxsize=None)
def _plan_agrees(h: int, w: int, sweeps: int) -> None:
    """Raise unless the kernel's own geometry for (h, w, sweeps) is
    :func:`plan2d`'s, the one the CPU tests prove exact."""
    out = (ctypes.c_int * 5)()
    fn = _build.function("jacobi2d", "tpkt_jacobi2d_plan",
                         (ctypes.c_int,) * 3 + (ctypes.c_void_p,))
    _build.check(fn(h, w, sweeps, ctypes.addressof(out)),
                 "tpkt_jacobi2d_plan")
    if tuple(out) != plan2d(h, w, sweeps):
        raise RuntimeError(f"jacobi2d.cu plans {tuple(out)} for {(h, w)} at "
                           f"{sweeps} sweeps, plan2d {plan2d(h, w, sweeps)}")


def passes(iters: int, k: int) -> list:
    """Sweeps per launch: ``iters = passes·k + remainder``, the
    remainder as a last, shorter pass."""
    full, rem = divmod(int(iters), k)
    return [k] * full + ([rem] if rem else [])


def resolve_k(k=None, ndim: int = 2, shape=None, device=None) -> int:
    """Fusion depth of the ``ndim``-D stencil: ``k`` if given, else the
    knob ``k`` (``TPKT_STENCIL_K`` > the tuning cache's entry for
    ``shape`` > 8 in 2-D, 3 in 3-D), clamped to 1..8 in 2-D and to
    1..:data:`HALO3D_MAX` in 3-D."""
    if k is None:
        k = resolve(TUNABLES[ndim - 2], shape=shape, dtype="float32",
                    device=device)["k"]
    return max(1, min(int(k), _MOST_K[ndim]))


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
    k = resolve_k(k, 2, tuple(x.shape), x.device)
    if x.device.type == "cpu":
        return jacobi2d_plain(x, iters)
    if x.device.type != "cuda":
        raise ValueError(f"jacobi2d: unsupported device {x.device}")
    for sweeps in set(passes(iters, k)) if x.numel() else ():
        _plan_agrees(*x.shape, sweeps)
    return _passes_cuda("jacobi2d", _ARGTYPES, x.contiguous(), int(iters), k)


def _passes_cuda(name, argtypes, x, iters, k):
    """Launch ``csrc/<name>.cu``'s ``tpkt_<name>_pass(x, y, *shape,
    sweeps, stream)`` once per pass of ``passes(iters, k)``."""
    plan = passes(iters, k)
    if not plan or x.numel() == 0:
        return x.clone()
    entry = f"tpkt_{name}_pass"
    fn = _build.function(name, entry, argtypes)
    # a pass reads one buffer and writes another (neighbouring blocks
    # still read the old grid); two scratch buffers alternate and x is
    # never written
    bufs = [torch.empty_like(x)]
    if len(plan) > 1:
        bufs.append(torch.empty_like(x))
    src = x
    for i, sweeps in enumerate(plan):
        dst = bufs[i % 2]
        rc = _build.launch(fn, x, src.data_ptr(), dst.data_ptr(), *x.shape,
                           sweeps)
        LAUNCHES[name] += 1
        _build.check(rc, entry)
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


# ---------------------------------------------------------------- 3D

def jacobi3d(x, iters: int, k: int | None = None, depth: int | None = None):
    """Run ``iters`` Jacobi 7-point sweeps on a (d, h, w) float32
    tensor; returns a new tensor on the input's device.

    ``k`` is the number of sweeps fused per launch (``TPKT_STENCIL_K``,
    default 3, clamped to 1..:data:`HALO3D_MAX`). ``depth`` is the reference's slab
    prefetch depth: it is validated (a positive int) so that the
    reference's statics are accepted, and has no effect here — the
    port's kernel has no prefetch ring."""
    if x.dtype != torch.float32 or x.dim() != 3:
        raise TypeError(
            f"jacobi3d takes a 3-D float32 tensor, got {x.dtype} "
            f"{tuple(x.shape)}"
        )
    if int(iters) < 0:
        raise ValueError(f"jacobi3d: iters={iters} is negative")
    if depth is not None and (isinstance(depth, bool) or int(depth) != depth
                              or depth < 1):
        raise ValueError(f"jacobi3d: depth={depth!r} is not a positive int")
    k = resolve_k(k, 3, tuple(x.shape), x.device)
    if x.device.type == "cpu":
        return jacobi3d_plain(x, iters)
    if x.device.type != "cuda":
        raise ValueError(f"jacobi3d: unsupported device {x.device}")
    return _passes_cuda("jacobi3d", _ARGTYPES3D, x.contiguous(), int(iters),
                        k)


def _sweep3d(v):
    out = v.clone()
    c = slice(1, -1)
    out[c, c, c] = (
        ((((v[:-2, c, c] + v[2:, c, c]) + v[c, :-2, c]) + v[c, 2:, c])
         + v[c, c, :-2]) + v[c, c, 2:]
    ) * (1.0 / 6.0)
    return out


def jacobi3d_plain(x, iters: int):
    """Plain PyTorch sweeps, summed in the kernel's order; bitwise equal
    to the reference's blocked and small paths on the CPU."""
    for _ in range(int(iters)):
        x = _sweep3d(x)
    return x.clone() if int(iters) == 0 else x


def jacobi3d_reference(x, iters: int):
    """Oracle mirroring the reference's roll-based
    ``jacobi3d_reference``."""
    d, h, w = x.shape
    gz = torch.arange(d, device=x.device).view(d, 1, 1)
    gy = torch.arange(h, device=x.device).view(1, h, 1)
    gx = torch.arange(w, device=x.device).view(1, 1, w)
    interior = ((gz > 0) & (gz < d - 1) & (gy > 0) & (gy < h - 1)
                & (gx > 0) & (gx < w - 1))
    for _ in range(int(iters)):
        out = (
            torch.roll(x, 1, 0) + torch.roll(x, -1, 0)
            + torch.roll(x, 1, 1) + torch.roll(x, -1, 1)
            + torch.roll(x, 1, 2) + torch.roll(x, -1, 2)
        ) * (1.0 / 6.0)
        x = torch.where(interior, out, x)
    return x
