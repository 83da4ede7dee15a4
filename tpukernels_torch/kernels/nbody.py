"""O(N^2) direct N-body: all-pairs gravity with Plummer softening.

Port of ``tpukernels/kernels/nbody.py``. Each step computes the
accelerations a_i = Σ_j m_j·(r_j − r_i)·(|r_j − r_i|² + ε²)^(−3/2) and
integrates ``v += a·dt; p += v·dt``, in the reference's order. On a
CUDA tensor the accelerations come from ``csrc/nbody.cu`` (replaces
the TPU's ``_forces_kernel``), one launch per step; the integration
stays six elementwise torch ops between launches, as the JAX package
keeps it outside Pallas: it cannot go into the forces kernel, whose
other blocks still read the old positions. The launch's geometry is
:func:`plan_forces`. On a CPU tensor the accelerations come from the
plain version, chunked over i. :func:`nbody_reference` is the pairwise
oracle.

:func:`forces_ij` takes the accelerations on one set of i-bodies from
another set of j-bodies: on a CUDA tensor ``csrc/nbody.cu``'s
``tpkt_nbody_forces_ij``, the same kernel with the two sets held apart
(the distributed forms of ``parallel/collectives.py``), on a CPU tensor
its plain version.

Bound on the card: operations, 20 flops per pair (see ``nbody.cu``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from tpukernels_torch import _build
from tpukernels_torch.kernels import count_launch
from tpukernels_torch.tuning import SearchSpace, Tunable, resolve

TUNABLES = SearchSpace(
    kernel="nbody",
    metric="nbody_ginter_s",
    bench_shape=(1 << 16,),
    bench_dtype="float32",
    sources=("tpukernels_torch/kernels/nbody.py",
             "tpukernels_torch/csrc/nbody.cu"),
    tunables=(
        # i-bodies per block, a multiple of 32 up to 1024: at 65 536
        # bodies 256 gives 256 blocks, about two per SM
        Tunable("bi", env="TPKT_NBODY_BI", default=256,
                values=(128, 256, 512)),
        # j-bodies per shared-memory tile for the whole block, 1..3072
        # (16 bytes each), bj / S a group: 2048 the fastest of
        # chip_smoke.py's sweep (512, 1024, 2048), the sweep values
        Tunable("bj", env="TPKT_NBODY_BJ", default=2048,
                values=(512, 1024, 2048)),
    ),
)

# (R, S) instantiations of nbody.cu: i-bodies a thread, groups a block
RS_BUILT = tuple((r, s) for r in (2, 4) for s in (1, 2, 4, 8))
# the (R, S) the wrapper launches, from chip_smoke.py's sweep
DEFAULT_RS = (4, 8)
# the most threads a block (nbody.cu's kMaxThreads, its launch bounds)
MAX_THREADS = 512


class ForcesPlan(NamedTuple):
    """One launch of ``nbody.cu``. Thread t of group g of block b holds
    the i-bodies ``b·bi + t + k·group_threads`` (k < r; those at or past
    bi in the block, or past n, are not stored); group g walks the
    j-bodies ``[g·per, (g + 1)·per)`` in tiles of ``tile``, those at or
    past n padding of mass 0; the S partial sums of an i-body are added
    in group order."""

    bi: int
    grid: int  # blocks
    threads: int  # a block: s · group_threads
    r: int  # i-bodies a thread
    s: int  # groups a block
    group_threads: int  # bi / r rounded up to a warp
    tile: int  # j-bodies a group stages in shared memory at once
    per: int  # j-bodies a group walks, a multiple of tile
    n_pad: int  # s · per >= n

    def j_ranges(self) -> tuple:
        return tuple((g * self.per, (g + 1) * self.per)
                     for g in range(self.s))


def plan_forces(n: int, bi: int, bj: int, r: int | None = None,
                s: int | None = None) -> ForcesPlan:
    """The launch for n bodies, bi i-bodies a block and tiles of bj
    j-bodies a block: (r, s) from :data:`DEFAULT_RS` unless given, s
    halved until the block has at most :data:`MAX_THREADS` threads. A
    group's share of n is cut into the fewest tiles of at most bj / s
    bodies, all of one size, so little of the j-range is padding."""
    return plan_forces_ij(n, n, bi, bj, r, s)


@functools.lru_cache(maxsize=None)
def plan_forces_ij(ni: int, nj: int, bi: int, bj: int, r: int | None = None,
                   s: int | None = None) -> ForcesPlan:
    """:func:`plan_forces` for forces on ni i-bodies from nj j-bodies:
    the grid covers the i-set, the groups' shares the j-set."""
    r = DEFAULT_RS[0] if r is None else r
    s = DEFAULT_RS[1] if s is None else s
    if (r, s) not in RS_BUILT:
        raise ValueError(f"nbody: no kernel for r={r}, s={s}; built: "
                         f"{RS_BUILT}")
    t = (-(-bi // r) + 31) // 32 * 32
    while s > 1 and s * t > MAX_THREADS:
        s //= 2
    share = -(-nj // s)
    tiles = -(-share // max(1, bj // s))
    tile = -(-share // tiles)
    per = tiles * tile
    return ForcesPlan(bi, -(-ni // bi), s * t, r, s, t, tile, per, s * per)


# i-rows per chunk of the plain version: one (chunk, n) float32
# temporary at n = 65 536 is 256 MiB, where an unchunked (n, n) one
# would be 16 GiB
PLAIN_CHUNK = 1024

_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p,
)


_ARGTYPES_IJ = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p,
)


def _check(arrs, name="nbody_step", what="the seven arrays"):
    first = arrs[0]
    for a in arrs:
        if a.dtype != torch.float32 or a.dim() != 1:
            raise TypeError(
                f"{name} takes 1-D float32 tensors, got {a.dtype} "
                f"{tuple(a.shape)}"
            )
        if a.numel() != first.numel() or a.device != first.device:
            raise ValueError(f"{name}: {what} differ in length or device")


def _tiles(n=None, device=None):
    t = resolve(TUNABLES, shape=None if n is None else (n,),
                dtype="float32", device=device)
    bi, bj = t["bi"], t["bj"]
    if bi % 32 or bi > 1024:
        raise ValueError(
            f"TPKT_NBODY_BI={bi}: expected a multiple of 32 up to 1024"
        )
    if bj > 3072:
        raise ValueError(f"TPKT_NBODY_BJ={bj}: expected 1..3072")
    return bi, bj


def nbody_step(px, py, pz, vx, vy, vz, m, dt=1e-3, eps=1e-2, steps=1):
    """Advance n bodies ``steps`` steps. 1-D float32 SoA tensors on one
    device; returns new (px, py, pz, vx, vy, vz), the inputs unchanged.
    """
    arrs = (px, py, pz, vx, vy, vz, m)
    _check(arrs)
    dev = px.device.type
    if dev == "cpu":
        return nbody_plain(*arrs, dt=dt, eps=eps, steps=steps)
    if dev != "cuda":
        raise ValueError(f"nbody_step: unsupported device {px.device}")
    n = px.numel()
    plan = plan_forces(n, *_tiles(n, px.device)) if n else None
    forces = functools.partial(_forces_cuda, plan=plan)
    return _advance(forces, tuple(a.contiguous() for a in arrs), dt, eps,
                    steps)


def _forces_cuda(px, py, pz, m, eps2, plan):
    n = px.numel()
    ax, ay, az = (torch.empty_like(px) for _ in range(3))
    if n == 0:
        return ax, ay, az
    fn = _build.function("nbody", "tpkt_nbody_forces", _ARGTYPES)
    rc = _build.launch(fn, px, px.data_ptr(), py.data_ptr(), pz.data_ptr(),
                       m.data_ptr(), ax.data_ptr(), ay.data_ptr(),
                       az.data_ptr(), n, eps2, plan.bi, plan.r, plan.s,
                       plan.tile, plan.per)
    count_launch("nbody_forces")
    _build.check(rc, "tpkt_nbody_forces")
    return ax, ay, az


def forces_ij(ipx, ipy, ipz, jpx, jpy, jpz, jm, eps2: float):
    """Accelerations ``(ax, ay, az)`` on the i-bodies at (ipx, ipy, ipz)
    from the j-bodies at (jpx, jpy, jpz) of masses ``jm``: 1-D float32
    tensors on one device, the i-set and the j-set each of one length;
    ``eps2`` is the squared softening (:func:`_eps2`). On a CUDA tensor
    one launch of ``tpkt_nbody_forces_ij`` (counted as
    ``nbody_forces_ij``); on a CPU tensor :func:`forces_ij_plain`."""
    _check((ipx, ipy, ipz), "forces_ij", "the i-arrays")
    _check((jpx, jpy, jpz, jm), "forces_ij", "the j-arrays")
    if ipx.device != jpx.device:
        raise ValueError("forces_ij: the i-set and the j-set lie on "
                         f"{ipx.device} and {jpx.device}")
    dev = ipx.device.type
    if dev == "cpu":
        return forces_ij_plain(ipx, ipy, ipz, jpx, jpy, jpz, jm, eps2)
    if dev != "cuda":
        raise ValueError(f"forces_ij: unsupported device {ipx.device}")
    ni, nj = ipx.numel(), jpx.numel()
    if ni == 0 or nj == 0:
        return tuple(torch.zeros_like(ipx) for _ in range(3))
    plan = plan_forces_ij(ni, nj, *_tiles(ni, ipx.device))
    ax, ay, az = (torch.empty_like(ipx) for _ in range(3))
    fn = _build.function("nbody", "tpkt_nbody_forces_ij", _ARGTYPES_IJ)
    i = [a.contiguous() for a in (ipx, ipy, ipz)]
    j = [a.contiguous() for a in (jpx, jpy, jpz, jm)]
    rc = _build.launch(fn, ipx, *(a.data_ptr() for a in i), ni,
                       *(a.data_ptr() for a in j), nj, ax.data_ptr(),
                       ay.data_ptr(), az.data_ptr(), eps2, plan.bi, plan.r,
                       plan.s, plan.tile, plan.per)
    count_launch("nbody_forces_ij")
    _build.check(rc, "tpkt_nbody_forces_ij")
    return ax, ay, az


def _eps2(eps) -> float:
    """The reference's float32(eps * eps): squared in double, then cast."""
    return float(torch.tensor(eps * eps, dtype=torch.float32))


def _advance(forces, arrs, dt, eps, steps):
    """``steps`` steps of the reference's integration, with ``forces``
    giving the accelerations. At ``steps <= 0`` no step runs, as the
    reference's ``fori_loop(0, steps, ...)``, and the result is a copy of
    the inputs, never the caller's own tensors."""
    px, py, pz, vx, vy, vz, m = arrs
    eps2 = _eps2(eps)
    for _ in range(int(steps)):
        ax, ay, az = forces(px, py, pz, m, eps2)
        vx = vx + ax * dt
        vy = vy + ay * dt
        vz = vz + az * dt
        px = px + vx * dt
        py = py + vy * dt
        pz = pz + vz * dt
    if int(steps) <= 0:
        return tuple(a.clone() for a in (px, py, pz, vx, vy, vz))
    return px, py, pz, vx, vy, vz


def _forces_plain(px, py, pz, m, eps2, chunk):
    """Accelerations in the kernel's arithmetic, ``chunk`` i-rows at a
    time: the same pair terms, summed over j."""
    return forces_ij_plain(px, py, pz, px, py, pz, m, eps2, chunk)


def forces_ij_plain(ipx, ipy, ipz, jpx, jpy, jpz, jm, eps2,
                    chunk: int = PLAIN_CHUNK):
    """Plain PyTorch version of :func:`forces_ij`, ``chunk`` i-rows at a
    time: the kernel's pair terms, summed over j; any device."""
    out = [torch.zeros_like(ipx) for _ in range(3)]
    if jpx.numel() == 0:
        return tuple(out)
    for i0 in range(0, ipx.numel(), chunk):
        rows = slice(i0, i0 + chunk)
        dx = jpx[None, :] - ipx[rows, None]
        dy = jpy[None, :] - ipy[rows, None]
        dz = jpz[None, :] - ipz[rows, None]
        inv = torch.rsqrt(dx * dx + dy * dy + dz * dz + eps2)
        wgt = jm[None, :] * inv * inv * inv
        for a, dr in zip(out, (dx, dy, dz)):
            a[rows] = (wgt * dr).sum(dim=1)
    return tuple(out)


def nbody_plain(px, py, pz, vx, vy, vz, m, dt=1e-3, eps=1e-2, steps=1,
                chunk: int = PLAIN_CHUNK):
    """Plain PyTorch version, chunked over i so that no (n, n)
    temporary is made; any device."""
    forces = functools.partial(_forces_plain, chunk=chunk)
    return _advance(forces, (px, py, pz, vx, vy, vz, m), dt, eps, steps)


def nbody_reference(px, py, pz, vx, vy, vz, m, dt=1e-3, eps=1e-2, steps=1):
    """Oracle mirroring the reference's pairwise ``nbody_reference``
    (the serial-C double loop); (n, n) temporaries, so for small n."""
    eps2 = _eps2(eps)
    for _ in range(int(steps)):
        dx = px[None, :] - px[:, None]
        dy = py[None, :] - py[:, None]
        dz = pz[None, :] - pz[:, None]
        r2 = dx * dx + dy * dy + dz * dz + eps2
        w = m[None, :] * torch.rsqrt(r2) ** 3
        ax = torch.sum(w * dx, dim=1)
        ay = torch.sum(w * dy, dim=1)
        az = torch.sum(w * dz, dim=1)
        vx = vx + ax * dt
        vy = vy + ay * dt
        vz = vz + az * dt
        px, py, pz = px + vx * dt, py + vy * dt, pz + vz * dt
    return px, py, pz, vx, vy, vz
