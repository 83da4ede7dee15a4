"""Kernel registry of the port: the reference's keys, the port's wrappers.

Same keys and lazy groups as ``tpukernels/registry.py``: kernel
modules are imported on the first ``lookup``/``names``/``dispatch``,
never when this module is imported. A key whose kernels are not ported
yet raises ``KeyError`` naming its place in ROADMAP.md; it never falls
through to anything else.

``dispatch`` is the guarded path (see its docstring), and
:func:`dispatch_mesh` the same path over the process group, on a key's
distributed twin; :func:`calls` reads their ``dispatch.calls.<key>``
counters. The launch counts of the CUDA
kernels themselves live in ``tpukernels_torch.kernels``.
"""

from __future__ import annotations

import time as _time
from typing import Callable, Dict

from tpukernels_torch import aot as _aot
# keys with a distributed twin in parallel/collectives.py, which
# :func:`dispatch_mesh` runs (the reference's tuple; it lives beside the
# kernel table, which loads no torch)
from tpukernels_torch.kernels import MESH_KERNELS  # noqa: F401
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


def _mesh_callable(name: str, n: int, device) -> Callable:
    """The mesh twin of ``name`` on the group's 1-D ring of ``n`` ranks,
    on ``device``: a callable of the key's full operands (the same on
    every rank) that cuts this rank's block (``mesh.host_to_global``),
    runs the distributed entry of ``parallel/collectives.py`` and gathers
    the full result (``mesh.global_to_host``) onto every rank. Raises
    ValueError (from ``make_mesh``) unless the group has ``n`` ranks."""
    if name not in MESH_KERNELS:
        raise KeyError(f"kernel {name!r} has no mesh-tier twin; mesh "
                       f"kernels: {sorted(MESH_KERNELS)}")
    from tpukernels_torch.parallel import P, global_to_host, host_to_global
    from tpukernels_torch.parallel import collectives as C
    from tpukernels_torch.parallel import make_mesh

    mesh = make_mesh(n, device=device)

    def blk(t):
        return host_to_global(t, mesh, P("x"))

    def full(t):
        return global_to_host(t, mesh, P("x"))

    if name in ("scan", "scan_exclusive"):
        excl = name == "scan_exclusive"
        return lambda x: full(C.scan_dist(blk(x), mesh, exclusive=excl))
    if name == "histogram":
        return lambda x, nbins=256: C.histogram_dist(blk(x), int(nbins), mesh)
    if name in ("stencil2d", "stencil3d"):
        dist = C.jacobi2d_dist if name == "stencil2d" else C.jacobi3d_dist
        return lambda x, iters=8: full(dist(blk(x), int(iters), mesh))

    def nbody(px, py, pz, vx, vy, vz, m, dt=1e-3, eps=1e-2, steps=1):
        state = tuple(map(blk, (px, py, pz, vx, vy, vz, m)))
        return tuple(full(t) for t in C.nbody_dist_ring(
            state, int(steps), mesh, dt=dt, eps=eps))

    return nbody


def _mesh_size(mesh_shape) -> int:
    """The ring's size of ``mesh_shape``; ValueError unless it is a
    non-empty tuple whose product is at least 2."""
    if not isinstance(mesh_shape, (tuple, list)) or not mesh_shape:
        raise ValueError(
            f"mesh_shape={mesh_shape!r}: expected a non-empty tuple")
    n = 1
    for d in mesh_shape:
        n *= int(d)
    if n < 2:
        raise ValueError(
            f"mesh_shape={mesh_shape!r}: a mesh tier needs >= 2 devices")
    return n


def _mesh_sources(name: str) -> tuple:
    """The sources that date a mesh twin's compile row."""
    return (("tpukernels_torch/parallel/collectives.py",)
            + tuple(_aot.KERNEL_SOURCES.get(name, ())))


def check_mesh(name: str, *args, mesh_shape=None, **statics) -> None:
    """Refuse, on this rank alone and before any byte moves, a call that
    :func:`dispatch_mesh` would refuse on every rank: a bad
    ``mesh_shape`` (ValueError), a key outside :data:`MESH_KERNELS`
    (KeyError), and, with the compile discipline on, a call the key's
    wrapper would not take (ValueError): its row is ensured here, so the
    call's own lookup is then the memo's. The serving daemon's mesh tier
    runs it on rank 0 before it sends an order."""
    n = _mesh_size(mesh_shape)
    if name not in MESH_KERNELS:
        raise KeyError(f"kernel {name!r} has no mesh-tier twin; mesh "
                       f"kernels: {sorted(MESH_KERNELS)}")
    if _aot.enabled():
        try:
            _aot.ensure(f"{name}@mesh{n}", args, statics,
                        _mesh_sources(name))
        except _aot._Unroutable as e:
            raise ValueError(f"{name}@mesh{n}: {e}") from None


def dispatch_mesh(name: str, *args, mesh_shape=None, **statics):
    """Run one call of ``name`` on its distributed twin over the process
    group: the reference's ``registry.dispatch_mesh`` in the port's SPMD
    idiom. It is collective: every rank of the group calls it, with the
    full operands, the same on every rank (the reference's C contract),
    and every rank gets the full result.

    ``mesh_shape`` is a tuple whose product is the ring's size, which
    must be the group's (one rank a process); ``None``, ``()``, a
    product under 2 or one unequal to the group's size raises
    ValueError, and a key outside :data:`MESH_KERNELS` KeyError, on
    every rank before any byte moves. Around the call, the machinery of
    :func:`dispatch`: the ``dispatch/<key>`` span stamped ``mesh=``, the
    fault point, the compile discipline's memo under ``<key>@mesh<n>``
    (its row dated by ``parallel/collectives.py`` as well as the key's
    sources, and dropped by ``aot.invalidate_kernel(key)``), the
    integrity guard under the key, and the ``dispatch.calls.<key>``,
    ``dispatch.mesh.<key>`` counters and the ``dispatch.wall_s.<key>``
    histogram."""
    n = _mesh_size(mesh_shape)
    t0 = _time.perf_counter()
    with _trace.span(f"dispatch/{name}",
                     mesh="x".join(str(int(d)) for d in mesh_shape)):
        _faults.dispatch_fault(name)
        fn = _mesh_callable(name, n, _aot._device_of(args))
        if _aot.enabled():
            out = _aot.run_cached(f"{name}@mesh{n}", fn, args, statics,
                                  sources=_mesh_sources(name))
        else:
            out = fn(*args, **statics)
        out = _integrity.guard("registry", name, out, statics=statics)
    _metrics.inc(_CALLS_PREFIX + name)
    _metrics.inc(f"dispatch.mesh.{name}")
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
