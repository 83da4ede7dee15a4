"""O(N^2) direct N-body: all-pairs gravity with Plummer softening.

Port of ``tpukernels/kernels/nbody.py``. Each step computes the
accelerations a_i = Σ_j m_j·(r_j − r_i)·(|r_j − r_i|² + ε²)^(−3/2) and
integrates ``v += a·dt; p += v·dt``, in the reference's order. On a
CUDA tensor the accelerations come from ``csrc/nbody.cu`` (replaces
the TPU's ``_forces_kernel``), one launch per step; the integration
stays six elementwise torch ops between launches, as the JAX package
keeps it outside Pallas: it cannot go into the forces kernel, whose
other blocks still read the old positions. On a CPU tensor the
accelerations come from the plain version, chunked over i.
:func:`nbody_reference` is the pairwise oracle.

Bound on the card: operations, 20 flops per pair (see ``nbody.cu``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpukernels_torch import _build
from tpukernels_torch.kernels import LAUNCHES
from tpukernels_torch.tuning import SearchSpace, Tunable, resolve

TUNABLES = SearchSpace(
    kernel="nbody",
    tunables=(
        # i-bodies (threads) per block, a multiple of 32 up to 1024:
        # at 65 536 bodies 256 gives 256 blocks, about two per SM
        Tunable("bi", env="TPKT_NBODY_BI", default=256),
        # j-bodies per shared-memory tile, 1..3072 (16 bytes each)
        Tunable("bj", env="TPKT_NBODY_BJ", default=1024),
    ),
)

# i-rows per chunk of the plain version: one (chunk, n) float32
# temporary at n = 65 536 is 256 MiB, where an unchunked (n, n) one
# would be 16 GiB
PLAIN_CHUNK = 1024

_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
)


def _check(arrs):
    first = arrs[0]
    for a in arrs:
        if a.dtype != torch.float32 or a.dim() != 1:
            raise TypeError(
                f"nbody_step takes 1-D float32 tensors, got {a.dtype} "
                f"{tuple(a.shape)}"
            )
        if a.numel() != first.numel() or a.device != first.device:
            raise ValueError(
                "nbody_step: the seven arrays differ in length or device"
            )


def _tiles():
    t = resolve(TUNABLES)
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
    bi, bj = _tiles()
    forces = functools.partial(_forces_cuda, bi=bi, bj=bj)
    return _advance(forces, tuple(a.contiguous() for a in arrs), dt, eps,
                    steps)


def _forces_cuda(px, py, pz, m, eps2, bi, bj):
    n = px.numel()
    ax, ay, az = (torch.empty_like(px) for _ in range(3))
    if n == 0:
        return ax, ay, az
    fn = _build.function("nbody", "tpkt_nbody_forces", _ARGTYPES)
    with torch.cuda.device(px.device):
        rc = fn(px.data_ptr(), py.data_ptr(), pz.data_ptr(), m.data_ptr(),
                ax.data_ptr(), ay.data_ptr(), az.data_ptr(), n, eps2, bi, bj,
                _build.stream_of(px))
    LAUNCHES["nbody_forces"] += 1
    _build.check(rc, "tpkt_nbody_forces")
    return ax, ay, az


def _eps2(eps) -> float:
    """The reference's float32(eps * eps): squared in double, then cast."""
    return float(torch.tensor(eps * eps, dtype=torch.float32))


def _advance(forces, arrs, dt, eps, steps):
    """``steps`` steps of the reference's integration, with ``forces``
    giving the accelerations."""
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
    if int(steps) == 0:
        return tuple(a.clone() for a in (px, py, pz, vx, vy, vz))
    return px, py, pz, vx, vy, vz


def _forces_plain(px, py, pz, m, eps2, chunk):
    """Accelerations in the kernel's arithmetic, ``chunk`` i-rows at a
    time: the same pair terms, summed over j."""
    out = [torch.empty_like(px) for _ in range(3)]
    for i0 in range(0, px.numel(), chunk):
        rows = slice(i0, i0 + chunk)
        dx = px[None, :] - px[rows, None]
        dy = py[None, :] - py[rows, None]
        dz = pz[None, :] - pz[rows, None]
        inv = torch.rsqrt(dx * dx + dy * dy + dz * dz + eps2)
        wgt = m[None, :] * inv * inv * inv
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
