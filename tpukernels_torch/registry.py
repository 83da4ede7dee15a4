"""Kernel registry of the port: the reference's keys, the port's wrappers.

Same keys and lazy groups as ``tpukernels/registry.py``: kernel
modules are imported on the first ``lookup``/``names``/``dispatch``,
never when this module is imported. A key whose kernels are not ported
yet raises ``KeyError`` naming its place in ROADMAP.md; it never falls
through to anything else.

``dispatch`` is the guarded path (see its docstring); :func:`calls` reads
its ``dispatch.calls.<key>`` counters. The launch counts of the CUDA
kernels themselves live in ``tpukernels_torch.kernels``.
"""

from __future__ import annotations

import time as _time
from typing import Callable, Dict

from tpukernels_torch import aot as _aot
from tpukernels_torch.obs import metrics as _metrics
from tpukernels_torch.obs import trace as _trace
from tpukernels_torch.resilience import faults as _faults
from tpukernels_torch.resilience import integrity as _integrity
from tpukernels_torch.tuning import space as _space

# reference keys not ported yet -> where ROADMAP.md queues them (none:
# every key is ported; B2 has no key of its own)
PENDING: Dict[str, str] = {}

# keys that ride a base kernel's TUNABLES, as in the reference:
# scan_exclusive is a one-element shift of scan's result
DERIVED_KERNELS = {"scan_exclusive": "scan"}

_REGISTRY: Dict[str, Callable] = {}
_TUNABLES: Dict[str, "_space.SearchSpace"] = {}
_POPULATED = False
_CALLS_PREFIX = "dispatch.calls."


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
    """Run one kernel call on the guarded path: positional array
    operands and host scalars, keyword statics (``iters``, ``k``,
    ``depth``, ``precision``, ``dt``, ``eps``, ``steps``, ``nbins``).

    In the reference's order (``tpukernels/registry.py:111-163``): a
    ``dispatch/<key>`` span opens (``obs/trace.py``, a no-op unless
    ``TPKT_TRACE``); the fault point runs (``resilience/faults.py``,
    one check unless ``TPKT_FAULT_PLAN``); the wrapper runs (the CUDA
    kernel on a CUDA tensor) through the compile discipline's memo
    (``aot.run_cached``: the first call of a key in a process loads its
    libraries, makes its plan and records it, later calls are one memo
    lookup; ``TPKT_AOT_CACHE=0`` calls the wrapper directly, with bitwise
    the same result); the output-integrity guard checks the
    result (``resilience/integrity.py``: a NaN/Inf tripwire, canaries
    on first trust and every ``TPKT_INTEGRITY_SAMPLE``-th call; it never
    raises, and ``TPKT_INTEGRITY=0`` makes it one check); the span
    closes; the ``dispatch.calls.<key>`` counter and the
    ``dispatch.wall_s.<key>`` histogram (``obs/metrics.py``) record the
    call. With the guard on, the tripwire's read of a float result makes
    the call end when the device is done with it."""
    t0 = _time.perf_counter()
    with _trace.span(f"dispatch/{name}"):
        _faults.dispatch_fault(name)
        fn = lookup(name)
        if _aot.enabled():
            out = _aot.run_cached(name, fn, args, statics)
        else:
            out = fn(*args, **statics)
        out = _integrity.guard("registry", name, out, statics=statics)
    _metrics.inc(_CALLS_PREFIX + name)
    _metrics.observe(f"dispatch.wall_s.{name}", _time.perf_counter() - t0)
    return out


def precompile(name: str, device=None) -> dict:
    """Ensure ``name`` at its configuration of record (``aot.BENCH_CONFIGS``
    avatars: nothing is allocated) on ``device``, the card by default,
    into the memo :func:`dispatch` reads (``aot.precompile``)."""
    lookup(name)  # a key that is not ported raises here, naming why
    return _aot.precompile(name, device)


def precompilable_kernels():
    """The registered keys with a configuration of record to precompile."""
    _populate()
    return sorted(n for n in _REGISTRY if n in _aot.BENCH_CONFIGS)


def calls() -> Dict[str, int]:
    """Calls ``dispatch`` made per key in this process: a view of the
    ``dispatch.calls.<key>`` counters."""
    return {k[len(_CALLS_PREFIX):]: v
            for k, v in _metrics.counters(_CALLS_PREFIX).items()}


def reset_calls() -> None:
    """Zero the ``dispatch`` counters and wall-time histograms."""
    _metrics.clear(_CALLS_PREFIX)
    _metrics.clear("dispatch.wall_s.")
