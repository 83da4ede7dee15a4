"""Canary operands, tolerances and oracles of the ported kernels.

The port's copy of the parts of ``tpukernels/resilience/integrity.py``
this slice needs: ``CANARY_CONFIGS`` and :func:`tolerance` for the
ported registry keys, :func:`build_args` with the reference's seed and
shapes, and the oracle of each key. The guard itself (NaN tripwire,
canary cross-checks, quarantine) comes with the port's integrity slice.
"""

from __future__ import annotations

import numpy as np

# statics the canary call runs with, and the comparison band (rtol,
# atol) — the reference's bands for the same keys
CANARY_CONFIGS = {
    "vector_add": {"statics": {}, "rtol": 1e-5, "atol": 1e-5},
    "sgemm": {"statics": {}, "rtol": 1e-3, "atol": 1e-2},
    "stencil2d": {"statics": {"iters": 4}, "rtol": 1e-4, "atol": 1e-4},
    "stencil3d": {"statics": {"iters": 2}, "rtol": 1e-4, "atol": 1e-4},
    "nbody": {
        "statics": {"dt": 1e-3, "eps": 1e-2, "steps": 1},
        "rtol": 1e-3, "atol": 1e-3,
    },
}

SEED = 20260804


def tolerance(name: str):
    """("band", rtol, atol) for one kernel's canary comparison."""
    cfg = CANARY_CONFIGS[name]
    return ("band", cfg["rtol"], cfg["atol"])


def build_args(name: str):
    """Deterministic canary operands for one kernel, as numpy arrays and
    host floats: small, off-tile-boundary shapes."""
    rng = np.random.default_rng(SEED)

    def f32(*shape):
        return np.asarray(rng.standard_normal(shape), np.float32)

    if name == "vector_add":
        return (0.7, f32(1000), f32(1000))
    if name == "sgemm":
        return (1.25, f32(40, 72), f32(72, 56), -0.5, f32(40, 56))
    if name == "stencil2d":
        return (f32(40, 200),)
    if name == "stencil3d":
        return (f32(8, 24, 132),)
    if name == "nbody":
        return tuple(f32(192) for _ in range(6)) + (
            np.asarray(rng.uniform(0.5, 1.5, 192), np.float32),
        )
    raise KeyError(f"no canary operands for kernel {name!r}")


def oracle(name: str):
    """The port's oracle for a registry key (its ``*_reference``)."""
    if name == "vector_add":
        from tpukernels_torch.kernels.vector_add import saxpy_reference

        return saxpy_reference
    if name == "sgemm":
        from tpukernels_torch.kernels.sgemm import sgemm_reference

        return sgemm_reference
    if name == "stencil2d":
        from tpukernels_torch.kernels.stencil import jacobi2d_reference

        return jacobi2d_reference
    if name == "stencil3d":
        from tpukernels_torch.kernels.stencil import jacobi3d_reference

        return jacobi3d_reference
    if name == "nbody":
        from tpukernels_torch.kernels.nbody import nbody_reference

        return nbody_reference
    raise KeyError(f"no oracle for kernel {name!r}")
