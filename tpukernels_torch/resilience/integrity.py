"""Output-integrity guard of the port, with its canary contracts.

The port's own copy of ``tpukernels/resilience/integrity.py``.
``registry.dispatch`` passes every result through :func:`guard`, which
never raises: a wrong answer becomes a journaled, counted and, when it
repeats, quarantined event, not a crash of the run around it. Three
tiers (``TPKT_INTEGRITY``: unset or ``1`` full, ``tripwire`` tier 1
only, ``0``/``off``/``none`` off, which makes the guard one check of the
knob):

1. **Tripwire**, always on: every float leaf of the result is reduced
   to max |x| in one read (``torch.linalg.vector_norm`` at ord inf, which
   carries NaN and inf through) and the leaves' values are read back
   with one synchronisation. Int32 results (the scan family,
   histogram) need no scan and no synchronisation.
2. **Fingerprint envelopes**, for the exact (int32) keys: a canary run's
   CRC32 of the raw bytes against the envelope recorded from the CPU
   oracle (``integrity.json`` in ``_cachedir.integrity_dir``), bitwise.
   An envelope recorded under another torch version, or before the
   newest commit touching the key's ``TUNABLES.sources``, is rejected
   loudly (stderr and an ``output_integrity_rejected`` event) and
   treated as absent. Float envelopes keep norm bands for ``--check``.
3. **Oracle cross-check**: the canary run against the oracle,
   elementwise at :func:`tolerance`. Float keys, and exact keys with no
   valid envelope, take this tier.

Tiers 2 and 3 run a canary: ``registry.lookup(key)`` (not ``dispatch``:
no recursion, no call counted) on :func:`build_args`'s operands, on the
device of the guarded result (or the one the caller names: the C entry
guards host buffers, and its canary runs on the card), through the same
``output_fault`` point as the guarded result. The oracle runs on the CPU
from the same numpy operands, once per process, so the card's result is
never judged by the card. A canary runs on the first guarded call of a key a process makes
(first trust), every ``TPKT_INTEGRITY_SAMPLE``-th call after (default
64; 0 keeps only the first), and on every call of a suspect or
quarantined key.

A failure emits ``output_integrity_failed`` (kernel, site, tier,
detail, config, statics, ``plan_memo_dropped``, ``aot_memo_dropped``,
``aot_manifest_dropped``), invalidates what the compile discipline
ensured for the key (``aot.invalidate_kernel``: its memo entries, its
memoised launch plans and its manifest rows; the built ``.so`` stays,
since it is keyed by a hash of its sources and a rebuild would give the
same code), marks the key suspect in this process and counts the
failure per (key, config) per day in ``integrity_quarantine.json``; at
``TPKT_INTEGRITY_QUARANTINE_AFTER`` (default 2) failures the pair is
quarantined (``output_integrity_quarantined``, then ``_repeat`` on
later failures). A clean canary lifts the per-process suspicion. An
exception inside the guard is counted in ``integrity.check_errors``,
journaled as ``output_integrity_check_error`` and printed on stderr.

Counters (``obs/metrics.py``): ``integrity.checks``,
``integrity.deep_checks``, ``integrity.tier<N>.<key>`` per canary tier
run, ``integrity.failures``, ``integrity.quarantines``,
``integrity.rejections``, ``integrity.check_errors``.

CLI: ``python -m tpukernels_torch.resilience.integrity --record``
records every envelope from the CPU oracle; ``--check [--device cpu]``
runs each canary on the card (or the CPU) against its envelope; with no
mode it prints the manifest and today's quarantine. ``--kernels a,b``
narrows both. Exit 0 all good, 1 a mismatch or failed record, 2 usage
(or no card for a ``--check`` without ``--device cpu``).
"""

from __future__ import annotations

import datetime
import math
import os
import sys
import threading
import time
import zlib

import numpy as np
import torch

from tpukernels_torch import _cachedir
from tpukernels_torch.obs import metrics as obs_metrics
from tpukernels_torch.obs import trace
from tpukernels_torch.resilience import faults, journal
# the canary contracts live in a module without torch (a torch-free load
# client builds the probe operands); re-exported under their names here
from tpukernels_torch.resilience.canary import (  # noqa: F401
    CANARY_CONFIGS, SEED, build_args)
from tpukernels_torch.tuning import cache as tcache

_DISABLED = ("0", "off", "none")

# per-process state (reset() drops it). Two threads may guard at once
# (the serving daemon's workers): the call count is taken under a lock,
# so the sampling cadence loses no call; a first-trust canary that two
# threads start together runs twice, which costs time and no answer
_CALLS_LOCK = threading.Lock()
_CALLS: dict = {}        # (site, kernel) -> guarded calls
_DEEP_DONE: set = set()  # (site, kernel) whose first-trust canary ran
_SUSPECT: set = set()    # kernels whose last check failed
_QUAR_WARNED: set = set()
_REJECT_NOTED: set = set()
_FILE_MEMO: dict = {}    # path -> (stat key, parsed)
_ORACLE_MEMO: dict = {}  # kernel -> oracle leaves (numpy)
_LEDGER: dict = {}       # path -> (monotonic time of the last look, parsed)
_PATHS: dict = {}        # TPKT_INTEGRITY_DIR (raw) -> (manifest, ledger)
RECHECK_S = 1.0  # how long a read of the quarantine ledger is trusted


def _env(name: str):
    """``os.environ.get(name)`` at the cost of a dict lookup
    (``tuning.cache.env_raw``): the guard reads its knobs on every
    call."""
    raw = tcache.env_raw(name)
    return os.fsdecode(raw) if isinstance(raw, bytes) else raw


def _knob():
    raw = _env("TPKT_INTEGRITY")
    return None if raw is None else raw.strip().lower()


def enabled() -> bool:
    k = _knob()
    return k is None or k not in _DISABLED


def tier1_only() -> bool:
    """``TPKT_INTEGRITY=tripwire``: the tripwire without the canaries."""
    return _knob() == "tripwire"


def _positive_env(name: str, default: int, least: int) -> int:
    raw = _env(name)
    if raw is None or not raw.strip():
        return default
    try:
        n = int(raw)
    except ValueError:
        n = least - 1
    if n < least:
        raise ValueError(f"{name}={raw!r}: expected an int >= {least}")
    return n


def sample_every() -> int:
    """``TPKT_INTEGRITY_SAMPLE``: a canary every N-th guarded call of a
    key (default 64); 0 keeps only the first-trust canary."""
    return _positive_env("TPKT_INTEGRITY_SAMPLE", 64, 0)


def quarantine_after() -> int:
    """``TPKT_INTEGRITY_QUARANTINE_AFTER``: failures of one (key,
    config) in a day that quarantine it (default 2)."""
    return _positive_env("TPKT_INTEGRITY_QUARANTINE_AFTER", 2, 1)


def _paths():
    d = tcache.env_raw("TPKT_INTEGRITY_DIR")
    p = _PATHS.get(d)
    if p is None:
        p = _PATHS[d] = (_cachedir.integrity_manifest_path(),
                         _cachedir.integrity_quarantine_path())
    return p


def manifest_path() -> str:
    return _paths()[0]


def quarantine_path() -> str:
    return _paths()[1]


def reset():
    """Drop the per-process state (tests, and ``chip_smoke.py`` between
    its phases)."""
    _CALLS.clear()
    _DEEP_DONE.clear()
    _SUSPECT.clear()
    _QUAR_WARNED.clear()
    _REJECT_NOTED.clear()
    _FILE_MEMO.clear()
    _ORACLE_MEMO.clear()
    _LEDGER.clear()


# ------------------------------------------------------------------ #
# canary contracts                                                   #
# ------------------------------------------------------------------ #

def tolerance(name: str):
    """("exact", None, None) or ("band", rtol, atol) for one kernel's
    canary comparison."""
    cfg = CANARY_CONFIGS[name]
    if cfg.get("exact"):
        return ("exact", None, None)
    return ("band", cfg["rtol"], cfg["atol"])


def canary_key(name: str) -> str:
    """``kernel|shapes|dtypes|statics`` over the canary operands, the
    reference's key: one envelope polices every device."""
    shapes, dtypes = [], []
    for a in build_args(name):
        if isinstance(a, np.ndarray):
            shapes.append("x".join(str(d) for d in a.shape))
            dtypes.append(str(a.dtype))
        else:
            shapes.append("-")
    statics = CANARY_CONFIGS[name]["statics"]
    stat = ",".join(f"{k}={v}" for k, v in sorted(statics.items())) or "-"
    return "|".join((name, "+".join(shapes),
                     "+".join(sorted(set(dtypes))) or "-", stat))


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


def _leaves(outputs) -> list:
    return list(outputs) if isinstance(outputs, (tuple, list)) else [outputs]


def _np_leaves(outputs) -> list:
    return [leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor)
            else np.asarray(leaf) for leaf in _leaves(outputs)]


def oracle_outputs(name: str) -> list:
    """The oracle's result on the canary operands, on the CPU, as numpy
    leaves; computed once per process."""
    hit = _ORACLE_MEMO.get(name)
    if hit is None:
        from tpukernels_torch import interop

        args = interop.to_port(name, build_args(name), "cpu")
        ref = oracle(name)(*args, **CANARY_CONFIGS[name]["statics"])
        hit = _ORACLE_MEMO[name] = _np_leaves(ref)
    return hit


def fingerprint(outputs) -> list:
    """Per leaf: shape, dtype, CRC32 of the raw bytes (the bitwise
    authority of the exact keys) and, for floats, finiteness and the
    float64 l2, sum and absmax the bands compare."""
    rows = []
    for a in _np_leaves(outputs):
        row = {
            "shape": "x".join(str(d) for d in a.shape) or "-",
            "dtype": str(a.dtype),
            "crc": zlib.crc32(np.ascontiguousarray(a).tobytes()),
        }
        if np.issubdtype(a.dtype, np.floating):
            a64 = a.astype(np.float64)
            row["finite"] = bool(np.isfinite(a).all())
            row["l2"] = float(np.sqrt(np.sum(a64 * a64)))
            row["sum"] = float(np.sum(a64))
            row["absmax"] = float(np.max(np.abs(a64))) if a.size else 0.0
        rows.append(row)
    return rows


# ------------------------------------------------------------------ #
# envelope manifest (tier 2)                                         #
# ------------------------------------------------------------------ #

def _read_json(p: str) -> dict:
    return _cachedir.read_json_memoized(p, _FILE_MEMO)


def _write_json(p: str, mutate) -> dict:
    def _load(path):
        _FILE_MEMO.pop(path, None)
        return _read_json(path)

    data = _cachedir.locked_json_update(p, mutate, load=_load)
    _FILE_MEMO.pop(p, None)
    _LEDGER.pop(p, None)
    return data


def _sources(name: str) -> tuple:
    """The files whose newest commit dates the key's envelope: its
    ``TUNABLES.sources``, as for its tuning-cache entries."""
    from tpukernels_torch import registry

    return tuple(registry.tunables(name).sources)


def _reject(key: str, reason: str, **fields):
    if (key, reason) in _REJECT_NOTED:
        return
    _REJECT_NOTED.add((key, reason))
    obs_metrics.inc("integrity.rejections")
    print(f"# integrity-envelope rejected: {key} ({reason})",
          file=sys.stderr)
    journal.emit("output_integrity_rejected", key=key, reason=reason,
                 **fields)


def envelope(name: str):
    """The valid envelope of ``name``'s canary, or None: absent, or
    recorded under another torch version, or before the newest commit
    touching the key's sources (rejected loudly). Outside a git
    checkout the sha is not known and not checked."""
    key = canary_key(name)
    entry = _read_json(manifest_path()).get("entries", {}).get(key)
    if not isinstance(entry, dict):
        return None
    if entry.get("torch") != torch.__version__:
        _reject(key, f"recorded under torch {entry.get('torch')}, "
                     f"running {torch.__version__}")
        return None
    sources = _sources(name)
    sha = tcache.source_sha(sources) if sources else None
    if sha is not None and entry.get("source_sha") not in (None, sha):
        _reject(key, "stale: a commit touching " + ",".join(sources)
                + " postdates this envelope",
                entry_sha=entry.get("source_sha"), current_sha=sha)
        return None
    return entry


def record_envelope(name: str) -> dict:
    """Record ``name``'s envelope from its CPU oracle into the
    manifest; returns the entry."""
    fps = fingerprint(oracle_outputs(name))
    key = canary_key(name)
    sources = _sources(name)
    entry = {
        "fingerprints": fps,
        "torch": torch.__version__,
        "source_sha": tcache.source_sha(sources) if sources else None,
        "git_head": journal.git_head(),
        "recorded": round(time.time(), 3),
        "recorded_on": "cpu",
    }
    _write_json(manifest_path(),
                lambda data: data.setdefault("entries", {}).__setitem__(
                    key, entry))
    journal.emit("output_integrity_envelope", kernel=name, key=key,
                 leaves=len(fps))
    return entry


def record_all(names=None, echo=None) -> list:
    """Record every key's envelope (or ``names``'); one row a key,
    ``{"kernel", "error"}`` where its oracle failed."""
    echo = echo or (lambda line: None)
    rows = []
    for name in (names if names is not None else sorted(CANARY_CONFIGS)):
        try:
            entry = record_envelope(name)
        except Exception as e:  # noqa: BLE001 — reported per kernel
            rows.append({"kernel": name, "error": repr(e)})
            echo(f"  {name:<16} FAILED: {e!r}")
        else:
            rows.append({"kernel": name, "key": canary_key(name),
                         "leaves": len(entry["fingerprints"])})
            echo(f"  {name:<16} recorded "
                 f"({len(entry['fingerprints'])} leaf fingerprint(s))")
    return rows


def _band_close(a, b, rel, absolute) -> bool:
    return abs(a - b) <= absolute + rel * max(abs(a), abs(b))


def fingerprint_mismatch(name, got_rows, want_rows):
    """A description of how a canary's fingerprints differ from the
    envelope's, or None: exact keys by CRC, float keys by the norm
    bands (``max(1e-3, 10 rtol)`` relative, scaled by the envelope's
    absmax)."""
    if len(got_rows) != len(want_rows):
        return f"leaf count {len(got_rows)} != envelope {len(want_rows)}"
    kind, rtol, _atol = tolerance(name)
    for i, (got, want) in enumerate(zip(got_rows, want_rows)):
        if (got.get("shape"), got.get("dtype")) != (want.get("shape"),
                                                   want.get("dtype")):
            return (f"leaf {i}: shape/dtype {got.get('shape')}/"
                    f"{got.get('dtype')} != envelope {want.get('shape')}/"
                    f"{want.get('dtype')}")
        if kind == "exact":
            if got.get("crc") != want.get("crc"):
                return (f"leaf {i}: checksum {got.get('crc')} != envelope "
                        f"{want.get('crc')} (exact kernel)")
            continue
        if got.get("finite") is not True:
            return f"leaf {i}: non-finite values"
        band_rel = max(1e-3, 10.0 * (rtol or 0.0))
        scale = max(abs(want.get("absmax") or 0.0), 1.0)
        for stat in ("l2", "absmax", "sum"):
            g, w = got.get(stat), want.get(stat)
            if g is None or w is None:
                continue
            if not _band_close(g, w, band_rel, band_rel * scale):
                return (f"leaf {i}: {stat} {g} outside the envelope band "
                        f"around {w}")
    return None


# ------------------------------------------------------------------ #
# canary runs (tiers 2 and 3)                                        #
# ------------------------------------------------------------------ #

def run_canary(name: str, site: str = "manual", device=None):
    """One run of the key's wrapper on its canary operands on
    ``device`` (the card unless ``"cpu"``), through the guard's
    ``output_fault`` point."""
    from tpukernels_torch import interop, registry

    args = interop.to_port(name, build_args(name), device)
    out = registry.lookup(name)(*args, **CANARY_CONFIGS[name]["statics"])
    mode = faults.output_fault(site, name)
    return _corrupt(out, mode) if mode else out


def cross_check(name: str, site: str = "manual", device=None):
    """Tier 3: a canary run against the CPU oracle, elementwise at
    :func:`tolerance`. Returns a failure description or None."""
    got = _np_leaves(run_canary(name, site, device))
    want = oracle_outputs(name)
    if len(got) != len(want):
        return f"kernel returned {len(got)} leaves, oracle {len(want)}"
    kind, rtol, atol = tolerance(name)
    for i, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape:
            return f"leaf {i}: shape {g.shape} != oracle {w.shape}"
        if kind == "exact":
            if not np.array_equal(g, w):
                return (f"leaf {i}: {int(np.sum(g != w))} element(s) differ "
                        "from the oracle (exact kernel)")
        elif not np.allclose(g, w, rtol=rtol, atol=atol, equal_nan=False):
            bad = int(np.sum(~np.isclose(g, w, rtol=rtol, atol=atol)))
            return (f"leaf {i}: {bad} element(s) outside rtol={rtol}/"
                    f"atol={atol} of the oracle")
    return None


def fingerprint_check(name: str, site: str = "manual", device=None):
    """Tier 2: ``(ran, failure)``, a canary run's fingerprints against
    the valid envelope; ``ran`` is False when there is none."""
    ent = envelope(name)
    if ent is None:
        return False, None
    out = run_canary(name, site, device)
    return True, fingerprint_mismatch(name, fingerprint(out),
                                      ent.get("fingerprints") or [])


def _deep_check(site: str, name: str, device):
    """(tier, failure or None): an exact key's envelope when it has a
    valid one (tier 2), else the oracle (tier 3)."""
    obs_metrics.inc("integrity.deep_checks")
    tier, failure = 3, None
    if tolerance(name)[0] == "exact":
        ran, failure = fingerprint_check(name, site, device)
        if ran:
            tier = 2
    if tier == 3:
        failure = cross_check(name, site, device)
    obs_metrics.inc(f"integrity.tier{tier}.{name}")
    return tier, failure


# ------------------------------------------------------------------ #
# quarantine ledger                                                  #
# ------------------------------------------------------------------ #

def config_token() -> str:
    """The config half of a quarantine key: the compile discipline's
    fingerprint (``aot.tunable_env_fingerprint``: the ``TPKT_*`` knobs set
    in the env, sorted, and the tuning cache's content token), or
    ``default`` when it is empty."""
    from tpukernels_torch import aot

    return aot.tunable_env_fingerprint() or "default"


def _quarantine_key(kernel, config=None) -> str:
    return f"{kernel}|{config or config_token()}"


def _today() -> str:
    return datetime.date.today().isoformat()


def _ledger() -> dict:
    """The quarantine ledger, looked at again after :data:`RECHECK_S`
    (it is consulted on every guarded call) or after this process
    writes it."""
    p = quarantine_path()
    now = time.monotonic()
    seen = _LEDGER.get(p)
    if seen is None or now - seen[0] >= RECHECK_S:
        seen = _LEDGER[p] = (now, _read_json(p))
    return seen[1]


def note_failure(kernel, config=None, detail=None):
    """Count one failure of (kernel, config) today; returns
    ``(failures_today, quarantined, transitioned)``."""
    key = _quarantine_key(kernel, config)
    today = _today()
    threshold = quarantine_after()
    state = {}

    def mutate(data):
        entries = data.setdefault("entries", {})
        ent = entries.get(key)
        if not isinstance(ent, dict) or ent.get("day") != today:
            ent = {"day": today, "failures": 0, "quarantined": False}
        ent["failures"] += 1
        ent["last_detail"] = str(detail)[:200] if detail else None
        ent["last_t"] = round(time.time(), 3)
        transitioned = not ent["quarantined"] and ent["failures"] >= threshold
        if transitioned:
            ent["quarantined"] = True
        entries[key] = ent
        state.update(ent, transitioned=transitioned)

    _write_json(quarantine_path(), mutate)
    return state["failures"], state["quarantined"], state["transitioned"]


def is_quarantined(kernel, config=None) -> bool:
    entries = _ledger().get("entries")
    if not entries:
        return False
    ent = entries.get(_quarantine_key(kernel, config))
    return (isinstance(ent, dict) and ent.get("day") == _today()
            and bool(ent.get("quarantined")))


def quarantined_entries() -> dict:
    """Today's quarantined (kernel, config) entries."""
    today = _today()
    return {k: v for k, v in (_read_json(quarantine_path()).get("entries")
                              or {}).items()
            if isinstance(v, dict) and v.get("day") == today
            and v.get("quarantined")}


# ------------------------------------------------------------------ #
# corruption and tripwire                                            #
# ------------------------------------------------------------------ #

def _corrupt(outputs, mode):
    """One injected corruption of the first leaf (the first float leaf
    for ``nan``), on a copy: ``nan`` writes a NaN, ``corrupt`` adds
    max(1, |v|) to a float or 41 to an int."""
    leaves = _leaves(outputs)
    idx = 0
    if mode == "nan":
        idx = next((i for i, leaf in enumerate(leaves)
                    if leaf.is_floating_point()), 0)
    leaf = leaves[idx].clone()
    first = leaf.view(-1)[:1]
    if not leaf.is_floating_point():
        first += 41
    elif mode == "nan":
        first.fill_(float("nan"))
    else:
        v = float(first)
        first.fill_(v + max(1.0, abs(v)))
    if not isinstance(outputs, (tuple, list)):
        return leaf
    leaves[idx] = leaf
    return type(outputs)(leaves)


def tripwire_ok(outputs) -> bool:
    """Tier 1: every float leaf is finite. One max-|x| reduction a float
    leaf, their values read back with one synchronisation; int leaves
    are skipped (no reduction, no synchronisation)."""
    flags = []
    for leaf in _leaves(outputs):
        if isinstance(leaf, float):
            if not math.isfinite(leaf):
                return False
        elif (isinstance(leaf, torch.Tensor) and leaf.is_floating_point()
              and leaf.numel()):
            flags.append(torch.linalg.vector_norm(leaf, float("inf")))
    if not flags:
        return True
    if len(flags) == 1:
        return math.isfinite(flags[0].item())
    return bool(torch.isfinite(torch.stack(flags)).all())


def _device_of(outputs):
    for leaf in _leaves(outputs):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return torch.device("cpu")


# ------------------------------------------------------------------ #
# the guard                                                          #
# ------------------------------------------------------------------ #

def _check_error(kernel, site, error: str):
    obs_metrics.inc("integrity.check_errors")
    print(f"# output-integrity check error: {kernel} at {site} ({error})",
          file=sys.stderr)
    journal.emit("output_integrity_check_error", kernel=kernel, site=site,
                  error=error)


def _fail(site, kernel, tier, detail, statics=None):
    obs_metrics.inc("integrity.failures")
    _SUSPECT.add(kernel)
    config = config_token()
    from tpukernels_torch import aot

    dropped = aot.invalidate_kernel(kernel)
    print(f"# output-integrity FAILED: {kernel} at {site} (tier {tier}: "
          f"{detail})", file=sys.stderr)
    journal.emit("output_integrity_failed", kernel=kernel, site=site,
                 tier=tier, detail=detail, config=config,
                 statics=dict(statics) if statics else None,
                 plan_memo_dropped=dropped["plan_memo_dropped"],
                 aot_memo_dropped=dropped["memo_dropped"],
                 aot_manifest_dropped=dropped["manifest_dropped"])
    try:
        failures, quarantined, transitioned = note_failure(kernel, config,
                                                           detail)
    except Exception as e:  # noqa: BLE001 — the failure event landed
        _check_error(kernel, site, f"quarantine ledger write failed: {e!r}")
        return
    if transitioned:
        obs_metrics.inc("integrity.quarantines")
        print(f"# output-integrity QUARANTINED: {kernel} (config {config}) "
              f"after {failures} failure(s) today", file=sys.stderr)
        journal.emit("output_integrity_quarantined", kernel=kernel,
                     config=config, failures=failures,
                     threshold=quarantine_after())
    elif quarantined:
        journal.emit("output_integrity_quarantined_repeat", kernel=kernel,
                     config=config, failures=failures)


def guard(site: str, kernel, outputs, statics=None, device=None):
    """Check one result and return it, unchanged unless a fault plan
    corrupts it; never raises (see the module's docstring). A canary
    runs on ``device``, by default the device of the first tensor of
    ``outputs``: the C entry guards host buffers and names the card its
    adapter ran on. A corrupted leaf is a new tensor (the caller's
    stays as it was), so a caller that must see the corruption in its
    own buffer copies each returned leaf that is not its own back."""
    if not enabled():
        return outputs
    obs_metrics.inc("integrity.checks")
    with _CALLS_LOCK:
        n = _CALLS[(site, kernel)] = _CALLS.get((site, kernel), 0) + 1
    failure = tier = None
    try:
        mode = faults.output_fault(site, kernel)
        if mode:
            outputs = _corrupt(outputs, mode)
        if not tripwire_ok(outputs):
            failure, tier = "non-finite value in guarded result", 1
        elif not tier1_only() and kernel in CANARY_CONFIGS:
            every = sample_every()
            quarantined = kernel in _SUSPECT or is_quarantined(kernel)
            if quarantined and kernel not in _QUAR_WARNED:
                _QUAR_WARNED.add(kernel)
                print(f"# output-integrity: {kernel} is quarantined or "
                      "suspect - canary-checking every call",
                      file=sys.stderr)
            if ((site, kernel) not in _DEEP_DONE or quarantined
                    or (every > 0 and n % every == 0)):
                with trace.span(f"integrity/canary/{kernel}", site=site):
                    tier, failure = _deep_check(
                        site, kernel, device or _device_of(outputs))
                _DEEP_DONE.add((site, kernel))
    except Exception as e:  # noqa: BLE001 — the guard must not crash
        _check_error(kernel, site, repr(e))
        return outputs
    if failure is not None:
        try:
            _fail(site, kernel, tier, failure, statics)
        except Exception as e:  # noqa: BLE001 — never crash the run
            _check_error(kernel, site, f"failure handling errored: {e!r}")
    elif tier is not None:
        _SUSPECT.discard(kernel)
    return outputs


def aot_smoke(name: str, device=None) -> None:
    """The first-trust canary of a precompile (``aot.precompile``): no
    dispatch follows it, so the guard's own first-call canary would not
    run. Once a process and key under site ``aot`` (sharing the
    first-trust memo), on ``device`` (the card by default); a failure
    invalidates what was just ensured. Never raises."""
    if not enabled() or tier1_only() or name not in CANARY_CONFIGS:
        return
    with _CALLS_LOCK:
        if ("aot", name) in _DEEP_DONE:
            return
        _DEEP_DONE.add(("aot", name))
    try:
        with trace.span(f"integrity/canary/{name}", site="aot"):
            tier, failure = _deep_check("aot", name, device)
        if failure is not None:
            _fail("aot", name, tier, failure)
    except Exception as e:  # noqa: BLE001 — never crash a prewarm
        _check_error(name, "aot", repr(e))


# ------------------------------------------------------------------ #
# command line                                                       #
# ------------------------------------------------------------------ #

def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m tpukernels_torch.resilience.integrity",
        description="Record, check or print the integrity envelopes.")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--record", action="store_true",
                      help="record every envelope from the CPU oracle")
    mode.add_argument("--check", action="store_true",
                      help="run each canary against its envelope")
    ap.add_argument("--kernels", help="comma-separated registry keys")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="where --check runs the canaries (default: card)")
    try:
        args = ap.parse_args(argv)
    except SystemExit as e:
        return 0 if e.code == 0 else 2
    names = None
    if args.kernels:
        names = [n.strip() for n in args.kernels.split(",") if n.strip()]
        unknown = [n for n in names if n not in CANARY_CONFIGS]
        if unknown:
            print(f"integrity: unknown kernel(s) {unknown}; known: "
                  f"{sorted(CANARY_CONFIGS)}", file=sys.stderr)
            return 2
    if args.record:
        print(f"recording oracle envelopes -> {manifest_path()}")
        rows = record_all(names, echo=print)
        failed = [r["kernel"] for r in rows if "error" in r]
        print(f"integrity envelopes: {len(rows) - len(failed)} recorded, "
              f"{len(failed)} failed"
              + (f" ({','.join(failed)})" if failed else ""))
        return 1 if failed else 0
    if args.check:
        from tpukernels_torch.utils import pick_device

        try:
            device = pick_device(args.device)
        except RuntimeError as e:
            print(f"integrity: {e}", file=sys.stderr)
            return 2
        rc = 0
        for name in names or sorted(CANARY_CONFIGS):
            ran, failure = fingerprint_check(name, device=device)
            if not ran:
                print(f"  {name:<16} SKIP (no valid envelope - run --record "
                      "first)")
            elif failure:
                print(f"  {name:<16} FAIL: {failure}")
                rc = 1
            else:
                print(f"  {name:<16} ok")
        print(f"integrity check on {device}:", "FAILED" if rc else "OK")
        return rc
    entries = _read_json(manifest_path()).get("entries") or {}
    print(f"integrity envelope manifest: {manifest_path()} "
          f"({len(entries)} entr(ies))")
    for key in sorted(entries):
        ent = entries[key]
        print(f"  {key:<48} torch={ent.get('torch')} "
              f"recorded_on={ent.get('recorded_on')} "
              f"leaves={len(ent.get('fingerprints') or [])}")
    quar = quarantined_entries()
    if quar:
        print(f"quarantined today ({len(quar)}):")
        for key, ent in sorted(quar.items()):
            print(f"  {key}: {ent.get('failures')} failure(s) - "
                  f"{ent.get('last_detail')}")
    return 0


if __name__ == "__main__":
    from tpukernels_torch.resilience import integrity as _module

    sys.exit(_module.main())
