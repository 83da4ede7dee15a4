"""The compile discipline of the port: keys, a persistent manifest, a
per-process memo, invalidation, precompile and prewarm.

The port's counterpart of ``tpukernels/aot.py``. There a key's
executable is an XLA program; here it is the key's CUDA libraries
(``csrc/<lib>.cu`` built by ``nvcc`` into a ``.so`` and loaded with
ctypes, ``_build.py``) and its launch plan at the key's shapes
(``tuning.space.plan_memo``). "Compiling" a key is building and loading
those libraries and making that plan.

- **Keys** (:func:`cache_key`) follow the reference's scheme,
  ``kernel[@statics][@env]|shapes|dtypes|device_kind``: the statics and
  :func:`tunable_env_fingerprint` (the ``TPKT_*`` knobs that pick
  another kernel or launch at the same shapes, and the tuning cache's
  content token) ride on the kernel field.
- **The manifest** (``$TPKT_AOT_DIR/aot.json``, else
  ``<repo>/.tpkt_cache/aot.json``) records which keys were built, loaded
  and planned on which device kind, under which torch, CUDA and ``nvcc``,
  at which sha of the key's sources (:data:`KERNEL_SOURCES`), with the
  libraries by file name and the seconds of each step. A row from another
  toolkit, or older than a commit touching its sources, is rejected
  loudly (the ``aot.rejections`` counter, one stderr line and an
  ``aot_rejected`` event, once a process and cause) and the key is cold.
  Every write is flocked (``_cachedir.locked_json_update``); a torn file
  reads as empty.
- **The memo** (:func:`run_cached`, which ``registry.dispatch`` calls):
  the first call of a key in a process loads the libraries its knobs
  launch (:data:`KERNEL_LIBRARIES`), building any that is missing, makes
  the plan, writes the manifest row and emits ``aot_hit`` (a valid row
  existed) or ``aot_miss``; every later call is one memo lookup.
- **Invalidation** (:func:`invalidate_kernel`), called by the integrity
  guard when a result fails a check.
- **Precompile** (:func:`precompile`, :func:`prewarm_all`): a key at its
  :data:`BENCH_CONFIGS` avatar, without allocating an operand, then the
  guard's first-trust canary (``integrity.aot_smoke``).
  ``python -m tpukernels_torch.prewarm`` drives it.

``BENCH_CONFIGS`` is also the serving daemon's default bucket table
(``serve/bucketing.py``), so a request padded up to an avatar runs at a
configuration of record that a prewarm warmed.

``TPKT_AOT_CACHE=0`` (or ``off``/``none``) turns the layer off:
``registry.dispatch`` calls the wrapper directly, with bitwise the same
outputs, no manifest is read or written, no ``aot_*`` event is emitted,
and ``precompile`` refuses.

Counters and histograms (``obs/metrics.py``): ``aot.ensures``,
``aot.hits``, ``aot.misses``, ``aot.rejections``, ``aot.invalidations``;
``aot.build_s`` (one sample a library ``_build.build`` compiles),
``aot.load_s``, ``aot.plan_s``. Standard library only at import: the
fleet's router imports this module and no torch.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import sys
import threading
import time

from tpukernels_torch import _cachedir
from tpukernels_torch.kernels import HELPER_KERNELS, TPU_KERNELS
from tpukernels_torch.obs import metrics as obs_metrics
from tpukernels_torch.obs import trace
from tpukernels_torch.resilience import journal
from tpukernels_torch.tuning import cache as tcache

_DISABLED = ("0", "off", "none")

# the configurations of record as avatar specs: for each registry key
# its operands as ("f32"|"i32", shape) (shape () is a host scalar) and
# its statics; the values of the reference's table
BENCH_CONFIGS = {
    "vector_add": {
        "args": (("f32", ()), ("f32", (1 << 20,)), ("f32", (1 << 20,))),
        "statics": {},
    },
    "sgemm": {
        "args": (("f32", ()), ("f32", (1024, 1024)), ("f32", (1024, 1024)),
                 ("f32", ()), ("f32", (1024, 1024))),
        "statics": {},
    },
    "stencil2d": {
        "args": (("f32", (4096, 4096)),),
        "statics": {"iters": 8},
    },
    "stencil3d": {
        "args": (("f32", (384, 384, 384)),),
        "statics": {"iters": 8},
    },
    "scan": {
        "args": (("i32", (1 << 22,)),),
        "statics": {},
    },
    "scan_exclusive": {
        "args": (("i32", (1 << 22,)),),
        "statics": {},
    },
    "histogram": {
        "args": (("i32", (1 << 22,)),),
        "statics": {"nbins": 256},
    },
    "scan_histogram": {
        "args": (("i32", (1 << 22,)),),
        "statics": {"nbins": 256},
    },
    "nbody": {
        # dt, eps and steps are the C adapter's defaults
        "args": (("f32", (65536,)),) * 7,
        "statics": {"dt": 1e-3, "eps": 1e-2, "steps": 1},
    },
}

# the library (csrc/<lib>.cu) of each TPU kernel row and helper kernel
_LIB = {r.id: os.path.basename(r.port_source)[:-3] for r in TPU_KERNELS
        if r.port_source}
_LIB.update({n: os.path.basename(h.source)[:-3]
             for n, h in HELPER_KERNELS.items()})

# per key, the libraries its wrapper launches, each with the knob value
# that selects it (None: every call). TPU_KERNELS rows by id: B3/B4,
# B5/B6 and B9/B10 share a library, so B4, B6 and B9 stand for them
KERNEL_LIBRARIES = {
    "vector_add": ((_LIB["B7"], None),),
    "sgemm": ((_LIB["sgemm_prep"], None), (_LIB["B1"], ("depth", (1,))),
              (_LIB["B2"], ("depth", (2, 3)))),
    "stencil2d": ((_LIB["B4"], None),),
    "stencil3d": ((_LIB["B6"], None),),
    "scan": ((_LIB["B8"], None),),
    "scan_exclusive": ((_LIB["B8"], None),),
    "histogram": ((_LIB["B9"], None),),
    "scan_histogram": ((_LIB["B11"], ("fuse", ("on",))),
                       (_LIB["B8"], ("fuse", ("off",))),
                       (_LIB["B9"], ("fuse", ("off",)))),
    "nbody": ((_LIB["B12"], None),),
}

_K, _CSRC = "tpukernels_torch/kernels/", "tpukernels_torch/csrc/"
# the wrapper modules each key's call runs through
_WRAPPERS = {
    "vector_add": ("vector_add",), "sgemm": ("sgemm",),
    "stencil2d": ("stencil",), "stencil3d": ("stencil",), "scan": ("scan",),
    "scan_exclusive": ("scan",), "histogram": ("histogram",),
    "scan_histogram": ("scan_histogram", "scan", "histogram"),
    "nbody": ("nbody",),
}
# every library's key hashes every shared header (_build.library_path)
_HEADERS = tuple(sorted(
    _CSRC + f for f in os.listdir(os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "csrc")) if f.endswith(".cuh")))

# per key, the files whose newest commit dates its manifest rows: its
# wrappers, the sources of every library it can launch and the headers
KERNEL_SOURCES = {
    name: (tuple(f"{_K}{w}.py" for w in _WRAPPERS[name])
           + tuple(dict.fromkeys(f"{_CSRC}{lib}.cu" for lib, _ in libs))
           + _HEADERS)
    for name, libs in KERNEL_LIBRARIES.items()
}

# per-process state (reset() drops it)
_MEMO: dict = {}           # memo key -> ensured row
_ENSURE_LOCK = threading.RLock()  # one ensure at a time: the daemon's
                                  # two workers may miss a key together
_MANIFEST_MEMO: dict = {}  # path -> (stat key, parsed)
_REJECT_NOTED: set = set()
_ENV_NAMES: list = []      # [every knob's env name, sorted], once resolved
_KEY_FNS: dict = {}        # key -> the maker of its memo keys
_TOKEN = [None, None]      # [tuning-cache state, its content token]


def enabled() -> bool:
    raw = tcache.env_raw("TPKT_AOT_CACHE")
    if raw is None:
        return True
    return os.environ["TPKT_AOT_CACHE"].strip().lower() not in _DISABLED


def manifest_path() -> str:
    return _cachedir.aot_manifest_path()


def reset():
    """Drop the per-process state (tests; a real process keeps the memo
    as long as its loaded libraries live: for its whole life)."""
    with _ENSURE_LOCK:
        _MEMO.clear()
    _MANIFEST_MEMO.clear()
    _REJECT_NOTED.clear()
    _ENV_NAMES.clear()
    _KEY_FNS.clear()
    _TOKEN[:] = [None, None]


def libraries(name: str, knobs: dict) -> tuple:
    """The libraries a call of ``name`` launches under ``knobs`` (its
    resolved knob values: SGEMM's ``depth``, scan_histogram's ``fuse``)."""
    return tuple(lib for lib, when in KERNEL_LIBRARIES[name]
                 if when is None or knobs[when[0]] in when[1])


# ------------------------------------------------------------------ #
# keys                                                               #
# ------------------------------------------------------------------ #

class Avatar:
    """An operand's shape, dtype and device without its storage (the
    reference's ``jax.ShapeDtypeStruct``): what a precompile plans at."""

    __slots__ = ("shape", "dtype", "device")

    def __init__(self, shape, dtype, device):
        self.shape, self.dtype, self.device = tuple(shape), dtype, device

    def numel(self) -> int:
        return math.prod(self.shape)

    def dim(self) -> int:
        return len(self.shape)


def _aval_of(x) -> tuple:
    """(shape, dtype) of an operand, as the reference writes them; a
    host scalar is ((), "float32"), an int ((), "int32")."""
    shape = getattr(x, "shape", None)
    if shape is None:
        if isinstance(x, bool):
            return (), "bool"
        return (), "int32" if isinstance(x, int) else "float32"
    return tuple(int(d) for d in shape), tcache.canon_dtype(x.dtype)


def _device_of(args):
    for a in args:
        dev = getattr(a, "device", None)
        if dev is not None:
            return dev
    return None


def device_kind(device=None) -> str:
    """The tuning cache's device kind (``nvidia_h100_80gb_hbm3``, or
    ``cpu``) of ``device``, the card by default."""
    return tcache.device_kind(device)


# knobs that pick another kernel at the same shapes and are no
# SearchSpace's (never read from the tuning cache)
_EXTRA_PROGRAM_ENV = ("TPKT_SGEMM_PRECISION",)


def _env_names() -> tuple:
    if not _ENV_NAMES:
        from tpukernels_torch import registry

        names = set(_EXTRA_PROGRAM_ENV)
        for k in registry.tunable_kernels():
            names.update(registry.tunables(k).envs)
        _ENV_NAMES.append(tuple(sorted(names)))
    return _ENV_NAMES[0]


def _tuning_token() -> str:
    """``tuned=<md5>`` of the tuning cache's parsed content, or "" with
    the cache off or empty: a promotion picks other knobs at the same
    shapes."""
    state = tcache.state()
    if not state:
        return ""
    if _TOKEN[0] is not state:
        blob = json.dumps(state, sort_keys=True, default=repr).encode()
        _TOKEN[:] = [state, "tuned=" + hashlib.md5(blob).hexdigest()[:10]]
    return _TOKEN[1]


def tunable_env_fingerprint() -> str:
    """What picks another kernel or launch at the same shapes without
    showing in the operands: every ``TPKT_*`` knob set in the env,
    ``name=value``, sorted, then the tuning cache's content token; "" when
    there is none. The integrity guard's quarantine keys use it too
    (``integrity.config_token``)."""
    parts = sorted(f"{n}={os.environ[n]}" for n in _env_names()
                   if n in os.environ)
    token = _tuning_token()
    if token:
        parts.append(token)
    return ",".join(parts)


def cache_key(name: str, args, statics=None, kind=None) -> str:
    """``kernel[@statics][@env]|shapes|dtypes|device_kind``, the
    reference's scheme: operands' shapes joined with ``+`` (``-`` for a
    host scalar), their dtypes sorted and joined with ``+``; ``kind`` by
    default that of the operands' device."""
    if kind is None:
        kind = device_kind(_device_of(args))
    avals = [_aval_of(a) for a in args]
    shapes = "+".join("x".join(str(d) for d in s) if s else "-"
                      for s, _ in avals)
    dtypes = sorted({dt for _, dt in avals})
    field = name
    if statics:
        field += "@" + ",".join(f"{k}={v}" for k, v in sorted(statics.items()))
    env_fp = tunable_env_fingerprint()
    if env_fp:
        field += "@" + env_fp
    return "|".join((field, shapes or "-", "+".join(dtypes) or "-", kind))


# ------------------------------------------------------------------ #
# the manifest                                                       #
# ------------------------------------------------------------------ #

def _load_manifest(p: str) -> dict:
    return _cachedir.read_json_memoized(p, _MANIFEST_MEMO)


def _reload_manifest(p: str) -> dict:
    """The manifest read afresh (under a writer's lock)."""
    _MANIFEST_MEMO.pop(p, None)
    return _load_manifest(p)


def _reject(key: str, reason: str, **fields):
    """Loud rejection, once a process and (key, reason): a key is
    validated twice a precompile (its ``expected`` and the ensure)."""
    if (key, reason) in _REJECT_NOTED:
        return
    _REJECT_NOTED.add((key, reason))
    obs_metrics.inc("aot.rejections")
    print(f"# aot-cache rejected: {key} ({reason})", file=sys.stderr)
    journal.emit("aot_rejected", key=key, reason=reason, **fields)


def toolchain() -> dict:
    """The versions a manifest row is valid for: torch, the CUDA it was
    built for, and ``nvcc``'s release (``none`` without one)."""
    import torch

    from tpukernels_torch import _build

    return {"torch": torch.__version__, "cuda": torch.version.cuda,
            "nvcc": _build.nvcc_release()}


def manifest_entry(key: str, sources=()) -> dict | None:
    """The valid manifest row of ``key``, or None: absent, made under
    another torch, CUDA or ``nvcc`` (rejected), or older than the newest
    commit touching ``sources`` (rejected; outside git the sha is not
    known and not checked)."""
    entry = _load_manifest(manifest_path()).get("entries", {}).get(key)
    if not isinstance(entry, dict):
        return None
    for what, now in toolchain().items():
        if entry.get(what) != now:
            _reject(key, f"made under {what} {entry.get(what)}, running "
                         f"{now}")
            return None
    if sources:
        sha = tcache.source_sha(tuple(sources))
        if sha is not None and entry.get("source_sha") not in (None, sha):
            _reject(key, "stale: a commit touching " + ",".join(sources)
                    + " postdates this entry",
                    entry_sha=entry.get("source_sha"), current_sha=sha)
            return None
    return entry


def _record(key: str, sources, libs, build_s, load_s, plan_s) -> dict:
    """Upsert one manifest row (flocked read-modify-write, atomic)."""
    from tpukernels_torch import _build

    entry = {
        **toolchain(),
        "source_sha": tcache.source_sha(tuple(sources)) if sources else None,
        "git_head": journal.git_head(),
        "libraries": [_build.library_path(lib).name for lib in libs],
        "build_s": round(build_s, 6),
        "load_s": round(load_s, 6),
        "plan_s": round(plan_s, 6),
        "recorded": round(time.time(), 3),
    }

    p = manifest_path()
    _cachedir.locked_json_update(
        p, lambda data: data.setdefault("entries", {}).__setitem__(key, entry),
        load=_reload_manifest)
    _MANIFEST_MEMO.pop(p, None)
    return entry


def invalidate_kernel(name: str, prefixes=()) -> dict:
    """Drop what was ensured for ``name``: its memo entries (so the next
    call ensures afresh), its memoised launch plans
    (``tuning.space.forget``, of its base kernel: ``scan_exclusive``
    plans as ``scan``) and its manifest rows, statics and knob variants
    included, plus rows whose kernel field starts with one of
    ``prefixes``. Journals ``aot_invalidated``. Called by the integrity
    guard when a result of ``name`` fails a check.

    It neither deletes nor unloads a library: a loaded ``.so`` stays for
    the life of the process, and its file is named by a hash of its
    source, so a rebuild would give the same code. With the layer off it
    drops the memo and the plans only. Returns ``{"memo_dropped",
    "manifest_dropped", "plan_memo_dropped"}``."""
    from tpukernels_torch import registry
    from tpukernels_torch.tuning import space

    # the kernel field's base, so the mesh twins' rows and memo entries
    # (``<name>@mesh<n>``, ``registry.dispatch_mesh``) drop with it
    with _ENSURE_LOCK:
        memo_keys = [k for k in _MEMO if _base(k[0]) == name]
        for k in memo_keys:
            _MEMO.pop(k, None)
    plans = space.forget(registry.DERIVED_KERNELS.get(name, name))
    dropped: list = []
    if enabled():
        p = manifest_path()
        if os.path.exists(p):
            def _mutate(data):
                entries = data.get("entries") or {}
                dropped.extend(
                    k for k in entries
                    if _base(k.split("|", 1)[0]) == name
                    or any(k.startswith(pre) for pre in prefixes))
                for k in dropped:
                    entries.pop(k, None)

            _cachedir.locked_json_update(p, _mutate, load=_reload_manifest)
            _MANIFEST_MEMO.pop(p, None)
        obs_metrics.inc("aot.invalidations")
        journal.emit("aot_invalidated", kernel=name,
                     memo_dropped=len(memo_keys), manifest_dropped=dropped,
                     plan_memo_dropped=plans)
    return {"memo_dropped": len(memo_keys), "manifest_dropped": dropped,
            "plan_memo_dropped": plans}


# ------------------------------------------------------------------ #
# the memo                                                           #
# ------------------------------------------------------------------ #

def _route(name: str, call: dict, device) -> tuple:
    """``(knobs, finish)`` of one call of ``name`` (its wrapper's
    parameters by name): the launch plan made through the wrapper's own
    memoised plan function, the knob values that pick its libraries, and
    what of the plan needs a loaded library (the Jacobi kernels' own
    geometry, checked against the plan's), or None."""
    on_card = device is not None and device.type == "cuda"
    if name == "vector_add":
        from tpukernels_torch.kernels import vector_add as m

        m._check(call["x"], call["y"])
        m.launch_plan(call["x"].numel(), device)
        return {}, None
    if name == "sgemm":
        from tpukernels_torch.kernels import sgemm as m

        m._check(call["a"], call["b"], call["c"])
        (rows, inner), cols = call["a"].shape, call["b"].shape[1]
        return m.launch_plan(rows, cols, inner,
                             m._resolve_precision(call["precision"]),
                             device), None
    if name in ("stencil2d", "stencil3d"):
        from tpukernels_torch.kernels import stencil as m

        shape, iters = tuple(call["x"].shape), int(call["iters"])
        if name == "stencil2d":
            k, sms = m.resolve_k(call["k"], 2, shape, device), None
        else:
            k, _ = m.launch_knobs3d(shape, call["k"], call["depth"], device)
            sms = m.sm_count(device.index) if on_card else None
        if not on_card:
            return {"k": k}, None
        return {"k": k}, lambda: m.check_plans(shape, iters, k, sms)
    if name in ("scan", "scan_exclusive"):
        from tpukernels_torch.kernels import scan as m

        return {"tile": m.tile_plan(call["x"])}, None
    if name == "histogram":
        from tpukernels_torch.kernels import histogram as m

        nbins = m.check_nbins(call["nbins"])
        return {"blocks_per_sm": m.launch_plan(call["x"].numel(), nbins,
                                               device)}, None
    if name == "scan_histogram":
        from tpukernels_torch.kernels import histogram as h
        from tpukernels_torch.kernels import scan_histogram as m

        fuse, _, _ = m.launch_plan(call["x"], h.check_nbins(call["nbins"]))
        return {"fuse": fuse}, None
    if name == "nbody":
        from tpukernels_torch.kernels import nbody as m

        m._check(tuple(call[a] for a in ("px", "py", "pz", "vx", "vy", "vz",
                                         "m")))
        n = call["px"].numel()
        if n:
            m.plan_forces(n, *m._tiles(n, device))
        return {}, None
    raise KeyError(f"no compile route for kernel {name!r}")


def _bind(name: str, args, statics) -> dict:
    """The call's arguments by the wrapper's parameter names, defaults
    filled in."""
    import inspect

    from tpukernels_torch import registry

    bound = inspect.signature(registry.lookup(name)).bind(*args, **statics)
    bound.apply_defaults()
    return dict(bound.arguments)


class _Unroutable(Exception):
    """A call the compile route cannot read (its wrapper says why)."""


def _base(name: str) -> str:
    """The registry key of a memo name: ``scan@mesh4`` (a mesh twin,
    ``registry.dispatch_mesh``) is ``scan``."""
    return name.split("@", 1)[0]


def _ensure(name: str, args, statics: dict, sources=None) -> dict:
    """Load the libraries a call of ``name`` launches (building any that
    is missing), make its plan, write its manifest row and emit
    ``aot_hit``/``aot_miss``; returns the row with its key and
    ``expected``, its ``libraries`` by name (``library_files`` as the
    manifest holds them). A mesh twin's name (``<key>@mesh<n>``) routes
    as its key at the full operands' shapes, and dates its row by
    ``sources`` (by default its key's :data:`KERNEL_SOURCES`)."""
    from tpukernels_torch import _build

    device = _device_of(args)
    base = _base(name)
    try:
        call = _bind(base, args, statics)
        kind = device_kind(device)
        key = cache_key(name, args, statics, kind=kind)
        if sources is None:
            sources = KERNEL_SOURCES.get(base, ())
        prior = manifest_entry(key, sources)
        t0 = time.perf_counter()
        with trace.span(f"aot/plan/{name}", key=key):
            knobs, finish = _route(base, call, device)
        plan_s = time.perf_counter() - t0
    except Exception as e:  # noqa: BLE001 — the wrapper raises its own
        raise _Unroutable(repr(e)) from e
    on_card = device is not None and device.type == "cuda"
    libs = libraries(base, knobs) if on_card else ()
    t0 = time.perf_counter()
    if libs:
        _build.build(libs)
    t1 = time.perf_counter()
    with trace.span(f"aot/load/{name}", key=key):
        for lib in libs:
            _build.library(lib)
    t2 = time.perf_counter()
    if finish is not None:
        finish()
    t3 = time.perf_counter()
    build_s, load_s = t1 - t0, t2 - t1
    plan_s += t3 - t2
    obs_metrics.inc("aot.ensures")
    obs_metrics.observe("aot.load_s", load_s)
    obs_metrics.observe("aot.plan_s", plan_s)
    expected = "miss" if prior is None else "hit"
    obs_metrics.inc("aot.misses" if prior is None else "aot.hits")
    fields = dict(key=key, libraries=list(libs), build_s=round(build_s, 6),
                  load_s=round(load_s, 6), plan_s=round(plan_s, 6))
    if prior is None:
        journal.emit("aot_miss", **fields)
    else:
        fields["prior_build_s"] = prior.get("build_s")
        journal.emit("aot_hit", **fields)
    row = _record(key, sources, libs, build_s, load_s, plan_s)
    return {**row, "key": key, "expected": expected,
            "library_files": row["libraries"], "libraries": list(libs)}


# per key, the operands whose shape and dtype its wrapper's plan reads:
# the others must match them or the wrapper refuses the call
_PLANNED = {"vector_add": (1,), "sgemm": (1, 2), "stencil2d": (0,),
            "stencil3d": (0,), "scan": (0,), "scan_exclusive": (0,),
            "histogram": (0,), "scan_histogram": (0,), "nbody": (0,)}


def _key_fn(name: str):
    """The memo key's maker for calls of ``name`` (made once a key):
    ``(args, statics) -> key`` from the device, shape and dtype of the
    operands the wrapper's plan reads (:data:`_PLANNED`), the statics, and
    the raw values (``tuning.cache.env_reader``) of the knobs of every
    SearchSpace whose sources hold one of the key's wrapper modules, with
    ``TPKT_SGEMM_PRECISION`` for SGEMM. It leaves out the tuning cache: a
    promotion changes no operand and no env, and the wrapper's own plan
    memo follows it (``tuning.space.plan_memo``), so nothing stale runs."""
    fn = _KEY_FNS.get(name)
    if fn is None:
        from tpukernels_torch import registry

        base = _base(name)
        mine = {f"{_K}{w}.py" for w in _WRAPPERS.get(base, ())}
        names = set(_EXTRA_PROGRAM_ENV) if base == "sgemm" else set()
        for k in registry.tunable_kernels():
            sp = registry.tunables(k)
            if mine & set(sp.sources):
                names.update(sp.envs)
        knobs = tcache.env_reader(sorted(names))
        i, *rest = _PLANNED[base]
        if rest:
            (j,) = rest

            def fn(args, statics):
                a = args[i]
                return (name, a.device, a.shape, a.dtype, args[j].shape,
                        knobs(), tuple(statics.items()) if statics else None)
        else:
            def fn(args, statics):
                a = args[i]
                return (name, a.device, a.shape, a.dtype, knobs(),
                        tuple(statics.items()) if statics else None)
        fn = _KEY_FNS[name] = fn
    return fn


def _memo_key(name: str, args, statics) -> tuple:
    """What selects an ensured row in this process (:func:`_key_fn`); for
    a call given another way, every operand's shape and dtype."""
    try:
        return (_KEY_FNS.get(name) or _key_fn(name))(args, statics)
    except (IndexError, AttributeError):
        return (name, _device_of(args), *map(_aval_of, args),
                tuple(statics.items()))


def ensure(name: str, args, statics=None, sources=None) -> dict:
    """The ensured row of this call's key: from the memo, else made by
    :func:`_ensure` (once a process per memo key, under a lock).
    Raises ``_Unroutable`` for a call its wrapper would refuse."""
    statics = statics or {}
    memo = _memo_key(name, args, statics)
    row = _MEMO.get(memo)
    if row is not None:
        return row
    with _ENSURE_LOCK:
        row = _MEMO.get(memo)
        if row is None:
            row = _MEMO[memo] = _ensure(name, args, statics, sources)
        return row


def run_cached(name: str, fn, args, statics=None, sources=None):
    """``fn(*args, **statics)`` after the call's key is ensured: the
    first call of a key in a process loads its libraries, makes its plan
    and records it (:func:`_ensure`); every later call is one memo
    lookup. A call the layer cannot read goes to ``fn`` alone, which
    raises its own error; were ``fn`` to take it, the layer raises.
    ``name`` may be a mesh twin's, ``<key>@mesh<n>`` (``sources`` then
    dates its row; see :func:`_ensure`)."""
    try:
        ensure(name, args, statics, sources)
    except _Unroutable as e:
        fn(*args, **(statics or {}))
        raise RuntimeError(f"aot: {name} took a call its compile route "
                           f"could not read: {e}") from e.__cause__
    return fn(*args, **(statics or {}))


# ------------------------------------------------------------------ #
# precompile and prewarm                                             #
# ------------------------------------------------------------------ #

def avatar_args(name: str, device) -> tuple:
    """The :data:`BENCH_CONFIGS` operands of ``name`` as :class:`Avatar`
    on ``device`` (a host scalar as the float or int a caller passes)."""
    import torch

    dt = {"f32": torch.float32, "i32": torch.int32}
    return tuple(
        (1.0 if kind == "f32" else 1) if not shape
        else Avatar(shape, dt[kind], device)
        for kind, shape in BENCH_CONFIGS[name]["args"])


def _device(device):
    """``device`` as a torch.device, the card by default (with its index,
    as a tensor on it names it)."""
    import torch

    from tpukernels_torch.utils import pick_device

    dev = pick_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def precompile(name: str, device=None) -> dict:
    """Ensure ``name`` at its :data:`BENCH_CONFIGS` avatar on ``device``
    (the card unless ``"cpu"``; on the CPU nothing is built): load its
    libraries, building any that is missing, and make its plan, without
    allocating an operand; then the integrity guard's first-trust canary
    (``integrity.aot_smoke``). Returns ``{kernel, key, expected: hit|miss,
    wall_s}`` with the row's libraries and seconds. Raises KeyError for a
    key without a config and RuntimeError when the layer is off."""
    if not enabled():
        raise RuntimeError("aot.precompile: TPKT_AOT_CACHE=0 turns the "
                           "compile discipline off; unset it to prewarm")
    if name not in BENCH_CONFIGS:
        raise KeyError(f"kernel {name!r} has no registered benchmark "
                       f"config; known: {sorted(BENCH_CONFIGS)}")
    from tpukernels_torch.resilience import integrity

    dev = _device(device)
    args = avatar_args(name, dev)
    t0 = time.perf_counter()
    row = ensure(name, args, dict(BENCH_CONFIGS[name]["statics"]))
    wall = time.perf_counter() - t0
    integrity.aot_smoke(name, device=dev)
    return {"kernel": name, "key": row["key"], "expected": row["expected"],
            "wall_s": round(wall, 6), "libraries": row["libraries"],
            "build_s": row["build_s"], "load_s": row["load_s"],
            "plan_s": row["plan_s"]}


def prewarm_all(names=None, echo=None, device=None) -> list:
    """:func:`precompile` every configuration of record (or ``names``);
    one row a kernel, ``{"kernel", "error"}`` for one that failed, the
    rest going on."""
    echo = echo or (lambda line: None)
    rows = []
    for name in names if names is not None else sorted(BENCH_CONFIGS):
        try:
            row = precompile(name, device)
        except Exception as e:  # noqa: BLE001 — reported per kernel
            row = {"kernel": name, "error": repr(e)}
            echo(f"  {name:<16} FAILED: {e!r}")
        else:
            echo(f"  {name:<16} expected={row['expected']:<4} "
                 f"wall={row['wall_s']:.3f}s build={row['build_s']:.3f}s "
                 f"libraries={','.join(row['libraries']) or '-'}")
        rows.append(row)
    return rows
