"""Canary operands, tolerances and oracles of the ported kernels.

The port's copy of the parts of ``tpukernels/resilience/integrity.py``
this slice needs: ``CANARY_CONFIGS`` and :func:`tolerance` for the
ported registry keys, :func:`build_args` with the reference's seed and
shapes, and the oracle of each key. The guard itself (NaN tripwire,
canary cross-checks, quarantine) comes with the port's integrity slice.
"""

from __future__ import annotations

import numpy as np

# statics the canary call runs with, and the comparison: a band (rtol,
# atol) or exact — the reference's contracts for the same keys
CANARY_CONFIGS = {
    "vector_add": {"statics": {}, "rtol": 1e-5, "atol": 1e-5},
    "sgemm": {"statics": {}, "rtol": 1e-3, "atol": 1e-2},
    "stencil2d": {"statics": {"iters": 4}, "rtol": 1e-4, "atol": 1e-4},
    "stencil3d": {"statics": {"iters": 2}, "rtol": 1e-4, "atol": 1e-4},
    "scan": {"statics": {}, "exact": True},
    "scan_exclusive": {"statics": {}, "exact": True},
    "histogram": {"statics": {"nbins": 256}, "exact": True},
    "scan_histogram": {"statics": {"nbins": 256}, "exact": True},
    "nbody": {
        "statics": {"dt": 1e-3, "eps": 1e-2, "steps": 1},
        "rtol": 1e-3, "atol": 1e-3,
    },
}

SEED = 20260804


def tolerance(name: str):
    """("exact", None, None) or ("band", rtol, atol) for one kernel's
    canary comparison."""
    cfg = CANARY_CONFIGS[name]
    if cfg.get("exact"):
        return ("exact", None, None)
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
    if name in ("scan", "scan_exclusive"):
        return (np.asarray(rng.integers(-1000, 1000, 4093), np.int32),)
    if name in ("histogram", "scan_histogram"):
        return (np.asarray(rng.integers(0, 256, 4093), np.int32),)
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
    if name == "scan":
        from tpukernels_torch.kernels.scan import inclusive_scan_reference

        return inclusive_scan_reference
    if name == "scan_exclusive":
        from tpukernels_torch.kernels.scan import exclusive_scan_reference

        return exclusive_scan_reference
    if name == "histogram":
        from tpukernels_torch.kernels.histogram import histogram_reference

        return histogram_reference
    if name == "scan_histogram":
        from tpukernels_torch.kernels.scan_histogram import (
            scan_histogram_reference,
        )

        return scan_histogram_reference
    raise KeyError(f"no oracle for kernel {name!r}")
