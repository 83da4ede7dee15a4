"""Kernel registry of the port: the reference's keys, the port's wrappers.

Same keys and lazy groups as ``tpukernels/registry.py``: kernel
modules are imported on the first ``lookup``/``names``/``dispatch``,
never when this module is imported. A key whose kernels are not ported
yet raises ``KeyError`` naming its place in ROADMAP.md; it never falls
through to anything else.

``dispatch`` counts calls per key (:func:`calls`); the launch counts
of the CUDA kernels themselves live in ``tpukernels_torch.kernels``.
"""

from __future__ import annotations

from typing import Callable, Dict

from tpukernels_torch.tuning import space as _space

# reference keys not ported yet -> where ROADMAP.md queues them (none:
# every key is ported; B2 has no key of its own)
PENDING: Dict[str, str] = {}

# keys that ride a base kernel's TUNABLES, as in the reference:
# scan_exclusive is a one-element shift of scan's result
DERIVED_KERNELS = {"scan_exclusive": "scan"}

_REGISTRY: Dict[str, Callable] = {}
_TUNABLES: Dict[str, "_space.SearchSpace"] = {}
_CALLS: Dict[str, int] = {}
_POPULATED = False


def _populate():
    global _POPULATED
    if _POPULATED:
        return

    def _spaces(mod):
        for sp in _space.spaces_of(mod):
            _TUNABLES[sp.kernel] = sp

    # core group: vector_add + sgemm (required, as in the reference)
    import tpukernels_torch.kernels.sgemm as _sgemm
    import tpukernels_torch.kernels.vector_add as _vector_add

    _REGISTRY["vector_add"] = _vector_add.saxpy
    _REGISTRY["sgemm"] = _sgemm.sgemm
    _spaces(_vector_add)
    _spaces(_sgemm)

    # stencil group
    import tpukernels_torch.kernels.stencil as _stencil

    _REGISTRY["stencil2d"] = _stencil.jacobi2d
    _REGISTRY["stencil3d"] = _stencil.jacobi3d
    _spaces(_stencil)

    # nbody group
    import tpukernels_torch.kernels.nbody as _nbody

    _REGISTRY["nbody"] = _nbody.nbody_step
    _spaces(_nbody)

    # scan group
    import tpukernels_torch.kernels.histogram as _histogram
    import tpukernels_torch.kernels.scan as _scan
    import tpukernels_torch.kernels.scan_histogram as _scan_histogram

    _REGISTRY["scan"] = _scan.inclusive_scan
    _REGISTRY["scan_exclusive"] = _scan.exclusive_scan
    _REGISTRY["histogram"] = _histogram.histogram
    _REGISTRY["scan_histogram"] = _scan_histogram.scan_histogram
    _spaces(_scan)
    _spaces(_histogram)
    _spaces(_scan_histogram)
    _POPULATED = True


def lookup(name: str) -> Callable:
    if name in PENDING:
        raise KeyError(
            f"kernel {name!r} is not ported yet: pending in ROADMAP.md "
            f"({PENDING[name]})"
        )
    _populate()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown kernel {name!r}; ported: {sorted(_REGISTRY)}, "
            f"pending: {sorted(PENDING)}"
        ) from None


def names():
    _populate()
    return sorted(_REGISTRY)


def tunables(name: str) -> "_space.SearchSpace":
    """The knobs of a key, or of its base kernel (``DERIVED_KERNELS``)."""
    lookup(name)
    try:
        return _TUNABLES[DERIVED_KERNELS.get(name, name)]
    except KeyError:
        raise KeyError(f"kernel {name!r} exports no TUNABLES") from None


def tunable_kernels():
    _populate()
    return sorted(_TUNABLES)


def resolve_params(name: str, shape=None, dtype=None, device=None) -> dict:
    """The knob values a ``name`` call at (shape, dtype) on ``device``
    would resolve, env > tuning cache > default, as its wrapper
    resolves them."""
    return _space.resolve(tunables(name), shape, dtype, device)


def knob_sources(name: str, shape=None, dtype=None, device=None) -> dict:
    """Where each knob of that call comes from: ``env``, ``cache`` or
    ``default``."""
    return _space.resolve_with_sources(tunables(name), shape, dtype,
                                       device)[1]


def dispatch(name: str, *args, **statics):
    """Run one kernel call through its wrapper: positional array
    operands and host scalars, keyword statics (``iters``, ``k``,
    ``depth``, ``precision``, ``dt``, ``eps``, ``steps``, ``nbins``)."""
    fn = lookup(name)
    out = fn(*args, **statics)
    _CALLS[name] = _CALLS.get(name, 0) + 1
    return out


def calls() -> Dict[str, int]:
    """Calls ``dispatch`` made per key in this process."""
    return dict(_CALLS)


def reset_calls() -> None:
    _CALLS.clear()
