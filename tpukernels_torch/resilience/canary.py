"""The canary contracts of the integrity guard, without torch.

Per registry key, the statics its canary call runs with and how the
result is compared (:data:`CANARY_CONFIGS`), and its small deterministic
operands as numpy arrays and host floats (:func:`build_args`). The
reference keeps both in ``tpukernels/resilience/integrity.py``; the port
keeps them here so a process that never imports torch can build them:
``python -m tpukernels_torch.loadgen --serve --shapes probe`` sends them
to a daemon. ``resilience/integrity.py`` re-exports them under the same
names.
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
