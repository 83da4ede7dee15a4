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
  pass of ``k`` fused sweeps, ``k`` at most :data:`HALO3D_MAX`: a block
  a (y, x) tile of columns and a segment of planes, marching along z
  with the sweeps in registers and the planes streamed through a ring
  of ``depth`` slots; the geometry is :func:`plan3d`.

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
import math
from typing import NamedTuple

import torch

from tpukernels_torch import _build
from tpukernels_torch.kernels import count_launch
from tpukernels_torch.tuning import SearchSpace, Tunable, plan_memo, resolve

HALO_MAX = 8  # most sweeps one 2-D launch fuses (the kernel's halo)
HALO3D_MAX = 8  # most sweeps one 3-D launch fuses, the reference's 1..8
RING_MAX = 3  # plane slots of jacobi3d.cu's ring, the reference's most depth

TUNABLES = (
    SearchSpace(
        kernel="stencil2d",
        metric="stencil2d_mcells_s",
        bench_shape=(4096, 4096),
        bench_dtype="float32",
        sources=("tpukernels_torch/kernels/stencil.py",
                 "tpukernels_torch/csrc/jacobi2d.cu"),
        # the sweep values: every fusion depth the kernel takes
        tunables=(Tunable("k", env="TPKT_STENCIL_K", default=8,
                          values=tuple(range(1, HALO_MAX + 1))),),
    ),
    SearchSpace(
        kernel="stencil3d",
        metric="stencil3d_mcells_s",
        bench_shape=(384, 384, 384),
        bench_dtype="float32",
        sources=("tpukernels_torch/kernels/stencil.py",
                 "tpukernels_torch/csrc/jacobi3d.cu"),
        # the fastest k and depth at 384^3 on the H100 (chip_smoke.py's
        # per_k_ms and per_depth_ms); the sweep values: every fusion
        # depth and ring depth the kernel takes
        tunables=(Tunable("k", env="TPKT_STENCIL_K", default=4,
                          values=tuple(range(1, HALO3D_MAX + 1))),
                  Tunable("depth", env="TPKT_STENCIL_DEPTH", default=3,
                          values=tuple(range(1, RING_MAX + 1)))),
    ),
)
_MOST_K = {2: HALO_MAX, 3: HALO3D_MAX}

_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p,
)
_ARGTYPES3D = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
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
    ``shape`` > 8 in 2-D, 4 in 3-D), clamped to 1..8 (:data:`HALO_MAX`,
    :data:`HALO3D_MAX`)."""
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
    check_plans(tuple(x.shape), iters, k)
    return _passes_cuda("jacobi2d", _ARGTYPES, x.contiguous(), int(iters), k)


def check_plans(shape, iters: int, k: int, sms: int | None = None) -> None:
    """Hold the kernel's own geometry against :func:`plan2d`'s (2-D) or
    :func:`plan3d`'s at ``sms`` SMs (3-D) for each pass of ``iters``
    sweeps at ``k`` a launch, once per shape and sweep count."""
    if not math.prod(shape):
        return
    for sweeps in set(passes(iters, k)):
        if len(shape) == 2:
            _plan_agrees(*shape, sweeps)
        else:
            _plan3d_agrees(*shape, sweeps, sms)


def _passes_cuda(name, argtypes, x, iters, k, extra=()):
    """Launch ``csrc/<name>.cu``'s ``tpkt_<name>_pass(x, y, *shape,
    sweeps, *extra, stream)`` once per pass of ``passes(iters, k)``."""
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
                           sweeps, *extra)
        count_launch(name)
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

# csrc/jacobi3d.cu's thread at each sweep count: (lane rows a warp, rows
# a thread); a thread holds V columns of its rows, a warp LY rows of
# LANES / LY lanes, a block WARPS3D warps stacked in y
GEOMETRY3D = {1: (1, 8), 2: (1, 8), 3: (2, 4), 4: (2, 4), 5: (2, 3),
              6: (2, 3), 7: (2, 2), 8: (2, 2)}
WARPS3D = 8
SEG3D_MIN = 16  # fewest owned planes a segment


class Plan3d(NamedTuple):
    """One 3-D pass's launch geometry: a block loads a window of
    ``strip + 2·halo`` columns by ``rows + 2·sweeps`` rows, starting
    ``halo`` columns and ``sweeps`` rows before the ones it owns, and
    the ``seg`` owned planes of its segment with ``sweeps`` planes before
    and after; ``nx`` strips by ``ny`` row tiles by ``nz`` segments, one
    block each."""

    halo: int
    strip: int
    rows: int
    seg: int
    nx: int
    ny: int
    nz: int


def window3d(sweeps: int) -> tuple:
    """(columns, rows) of the window one 3-D block loads."""
    lane_rows, rows = GEOMETRY3D[sweeps]
    return V * LANES // lane_rows, WARPS3D * lane_rows * rows


def plan3d(d: int, h: int, w: int, sweeps: int, sms: int) -> Plan3d:
    """The geometry ``csrc/jacobi3d.cu``'s ``make_plan`` launches one
    pass of ``sweeps`` sweeps of a (d, h, w) grid with on a card of
    ``sms`` SMs: the column halo is ``sweeps`` rounded up to ``V``, the
    row halo ``sweeps``; segments of at least ``SEG3D_MIN`` planes are
    cut for the fewest waves of ``sms`` blocks (one a SM) times steps a
    block (``seg + 2·sweeps``)."""
    wx, wy = window3d(sweeps)
    halo = -(-sweeps // V) * V
    strip, rows = wx - 2 * halo, wy - 2 * sweeps
    nx, ny = -(-w // strip), -(-h // rows)
    best = None
    for n in range(1, max(1, d // SEG3D_MIN) + 1):
        seg = -(-d // n)
        nz = -(-d // seg)
        cost = -(-(nx * ny * nz) // sms) * (seg + 2 * sweeps)
        if best is None or cost < best[0]:
            best = (cost, seg, nz)
    return Plan3d(halo, strip, rows, best[1], nx, ny, best[2])


@functools.lru_cache(maxsize=None)
def _plan3d_agrees(d: int, h: int, w: int, sweeps: int, sms: int) -> None:
    """Raise unless the kernel's own geometry for (d, h, w, sweeps,
    sms) is :func:`plan3d`'s, the one the CPU tests prove exact."""
    out = (ctypes.c_int * 7)()
    fn = _build.function("jacobi3d", "tpkt_jacobi3d_plan",
                         (ctypes.c_int,) * 5 + (ctypes.c_void_p,))
    _build.check(fn(d, h, w, sweeps, sms, ctypes.addressof(out)),
                 "tpkt_jacobi3d_plan")
    if tuple(out) != plan3d(d, h, w, sweeps, sms):
        raise RuntimeError(
            f"jacobi3d.cu plans {tuple(out)} for {(d, h, w)} at {sweeps} "
            f"sweeps on {sms} SMs, plan3d {plan3d(d, h, w, sweeps, sms)}")


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """SMs of CUDA device ``index``: the blocks of one wave of the 3-D
    kernel, which runs one a SM."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _knobs3d(shape, device) -> dict:
    """The knobs ``k`` and ``depth`` of a 3-D call on ``shape``,
    resolved once (env > cache > default) and memoised
    (:func:`tuning.plan_memo`)."""
    return plan_memo(TUNABLES[1], (shape, device.type, device.index),
                     resolve, TUNABLES[1], shape, "float32", device)


def launch_knobs3d(shape, k, depth, device) -> tuple:
    """``(k, depth)`` of a 3-D call on ``shape``: each as given, else
    its knob (:func:`_knobs3d`), clamped (:func:`resolve_k`,
    :func:`resolve_depth`)."""
    if k is None or depth is None:
        knobs = _knobs3d(shape, device)
        k = knobs["k"] if k is None else k
        depth = knobs["depth"] if depth is None else depth
    return resolve_k(k, 3), resolve_depth(depth)


def resolve_depth(depth=None, shape=None, device=None) -> int:
    """Plane slots of the 3-D kernel's ring: ``depth`` if given, else
    the knob ``depth`` (``TPKT_STENCIL_DEPTH`` > the tuning cache's entry
    for ``shape`` > 3), clamped as the reference clamps it,
    ``max(1, int(depth))``, and then to :data:`RING_MAX`, the ring the
    kernel builds."""
    if depth is None:
        depth = resolve(TUNABLES[1], shape=shape, dtype="float32",
                        device=device)["depth"]
    return min(max(1, int(depth)), RING_MAX)


def jacobi3d(x, iters: int, k: int | None = None, depth: int | None = None):
    """Run ``iters`` Jacobi 7-point sweeps on a (d, h, w) float32
    tensor; returns a new tensor on the input's device.

    ``k`` is the number of sweeps fused per launch (``TPKT_STENCIL_K``,
    default 4, clamped to 1..:data:`HALO3D_MAX`). ``depth`` is the
    reference's slab prefetch ring, here the kernel's ring of plane
    slots (:func:`resolve_depth`): 1 copies, waits and computes each
    plane; ``depth`` keeps ``depth - 1`` planes in flight while one is
    computed. The result is bitwise the same at every k and depth."""
    if x.dtype != torch.float32 or x.dim() != 3:
        raise TypeError(
            f"jacobi3d takes a 3-D float32 tensor, got {x.dtype} "
            f"{tuple(x.shape)}"
        )
    if int(iters) < 0:
        raise ValueError(f"jacobi3d: iters={iters} is negative")
    shape = tuple(x.shape)
    k, depth = launch_knobs3d(shape, k, depth, x.device)
    if x.device.type == "cpu":
        return jacobi3d_plain(x, iters)
    if x.device.type != "cuda":
        raise ValueError(f"jacobi3d: unsupported device {x.device}")
    sms = sm_count(x.device.index)
    check_plans(shape, iters, k, sms)
    return _passes_cuda("jacobi3d", _ARGTYPES3D, x.contiguous(), int(iters),
                        k, (depth, sms))


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
