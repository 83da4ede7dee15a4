"""Where the port keeps its state, and how it reads and writes it.

The port's own copy of ``tuning_cache_path``, ``read_json_memoized``,
``note_torn_artifact``, ``locked_json_update``, the AOT manifest's path,
the integrity guard's paths, the serving daemon's paths, the SLO
artifact's path and the adaptive bucket optimizer's paths in
``tpukernels/_cachedir.py``, of ``scaling_dir`` in
``tpukernels/obs/scaling.py``, of ``rollup_dir`` in
``tpukernels/obs/rollup.py`` and of the revalidation supervisor's
checkpoint and stamp directory in ``tpukernels/resilience/supervisor.py``,
and the bench's artifact directory (the reference's ``docs/logs``).
The state lives in the repository's ``.tpkt_cache/`` (gitignored) unless
an env var redirects it; the env is read on every call, so a test's
redirect takes effect at once.
"""

from __future__ import annotations

import json
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# every state directory a knob redirects, and where it lies under
# <repo>/.tpkt_cache when no knob does ("": that folder itself)
STATE_DIRS = {"TPKT_TUNING_CACHE_DIR": "", "TPKT_AOT_DIR": "",
              "TPKT_INTEGRITY_DIR": "", "TPKT_SLO_DIR": "",
              "TPKT_ADAPT_DIR": "", "TPKT_SCALING_DIR": "scaling",
              "TPKT_ROLLUP_DIR": "rollup",
              "TPKT_SUPERVISOR_DIR": "supervisor", "TPKT_BENCH_DIR": "bench"}


def _under(base: str, var: str) -> str:
    sub = STATE_DIRS.get(var, "")
    return os.path.join(base, sub) if sub else base


def state_dirs_under(base: str) -> dict:
    """Each :data:`STATE_DIRS` knob set to its place under ``base``, as
    it lies under ``<repo>/.tpkt_cache``: how a campaign or a report
    moves the whole state at once."""
    return {var: _under(base, var) for var in STATE_DIRS}


def _state_dir(var: str, env: dict | None) -> str:
    target = os.environ if env is None else env
    return target.get(var) or _under(os.path.join(_REPO, ".tpkt_cache"),
                                     var)


def tuning_cache_path(env: dict | None = None) -> str:
    """``$TPKT_TUNING_CACHE_DIR/tuning.json``, else
    ``<repo>/.tpkt_cache/tuning.json``."""
    return os.path.join(_state_dir("TPKT_TUNING_CACHE_DIR", env),
                        "tuning.json")


def aot_manifest_path(env: dict | None = None) -> str:
    """The compile discipline's manifest (``aot.py``):
    ``$TPKT_AOT_DIR/aot.json``, else ``<repo>/.tpkt_cache/aot.json``."""
    return os.path.join(_state_dir("TPKT_AOT_DIR", env), "aot.json")


def integrity_dir(env: dict | None = None) -> str:
    """State directory of the output-integrity guard
    (``resilience/integrity.py``): its envelope manifest and quarantine
    ledger. ``$TPKT_INTEGRITY_DIR``, else ``<repo>/.tpkt_cache``; tests
    and chaos runs redirect it, so an injected fault never quarantines
    the repository's own kernel configurations."""
    return _state_dir("TPKT_INTEGRITY_DIR", env)


def integrity_manifest_path(env: dict | None = None) -> str:
    return os.path.join(integrity_dir(env), "integrity.json")


def integrity_quarantine_path(env: dict | None = None) -> str:
    return os.path.join(integrity_dir(env), "integrity_quarantine.json")


def slo_path(env: dict | None = None) -> str:
    """The latency-SLO verdict artifact (``obs/slo.py``):
    ``$TPKT_SLO_DIR/slo.json``, else ``<repo>/.tpkt_cache/slo.json``; a
    test or a throwaway load run redirects it, so an injected breach
    never lands in the repository's own verdicts."""
    return os.path.join(_state_dir("TPKT_SLO_DIR", env), "slo.json")


def adapt_dir(env: dict | None = None) -> str:
    """State directory of the adaptive bucket optimizer
    (``serve/adapt.py``): its candidate (``adapt.json``) and the promoted
    bucket table (``buckets.json``). ``$TPKT_ADAPT_DIR``, else
    ``<repo>/.tpkt_cache``."""
    return _state_dir("TPKT_ADAPT_DIR", env)


def adapt_path(env: dict | None = None) -> str:
    """The candidate artifact, ``adapt.json``."""
    return os.path.join(adapt_dir(env), "adapt.json")


def adapt_buckets_path(env: dict | None = None) -> str:
    """The promoted bucket table, ``buckets.json``: the stable file an
    operator points ``TPKT_SERVE_BUCKETS`` at, so a promotion lands behind
    an unchanged env value and a daemon's ``undrain`` picks it up."""
    return os.path.join(adapt_dir(env), "buckets.json")


def serve_dir(env: dict | None = None) -> str:
    """Runtime directory of the serving daemon (``serve/server.py``): its
    Unix-domain socket and its flocked pidfile. ``$TPKT_SERVE_DIR``, else
    ``<repo>/.tpkt_cache``; tests redirect it, so a test daemon never
    collides with an operator's."""
    return _state_dir("TPKT_SERVE_DIR", env)


def scaling_dir(env: dict | None = None) -> str:
    """Where the distributed layer's scaling artifacts go
    (``obs/scaling.py``: the bandwidth sweep, the overlap probe, the
    weak-scaling sweep). ``$TPKT_SCALING_DIR``, else
    ``<repo>/.tpkt_cache/scaling``; a rehearsal redirects it, so its
    artifacts never mix with the card's."""
    return _state_dir("TPKT_SCALING_DIR", env)


def rollup_dir(env: dict | None = None) -> str:
    """Where the daily rollups go (``obs/rollup.py``):
    ``$TPKT_ROLLUP_DIR``, else ``<repo>/.tpkt_cache/rollup``. The
    reference keeps its rollups beside its journals in ``docs/logs``;
    that folder holds the reference's TPU evidence, so the port never
    writes there."""
    return _state_dir("TPKT_ROLLUP_DIR", env)


def supervisor_dir(env: dict | None = None) -> str:
    """State of the revalidation supervisor (``resilience/supervisor.py``,
    ``python -m tpukernels_torch.revalidate``): its checkpoint
    ``supervisor_<date>.jsonl``, its stamps under ``.revalidate_stamps/``
    and its steps' logs under ``logs/``. ``$TPKT_SUPERVISOR_DIR``, else
    ``<repo>/.tpkt_cache/supervisor``; ``TPKT_SUPERVISOR_CHECKPOINT`` and
    ``TPKT_REVALIDATE_STAMP_DIR`` move the checkpoint and the stamps
    alone. The reference keeps all three under ``docs/logs``, which
    holds its TPU evidence, so the port never writes there."""
    return _state_dir("TPKT_SUPERVISOR_DIR", env)


def bench_dir(env: dict | None = None) -> str:
    """Where the bench's persisted lines go, one
    ``bench_%Y-%m-%d_%H%M%S.json`` a run (the queue's ``bench`` step
    writes them; ``bench.check_regression --union-persisted``,
    ``promote_baseline`` and ``obs/trend.py`` read them):
    ``$TPKT_BENCH_DIR``, else ``<repo>/.tpkt_cache/bench``. The reference
    keeps its lines in ``docs/logs``, which holds its TPU evidence, so the
    port never writes there."""
    return _state_dir("TPKT_BENCH_DIR", env)


def bench_baseline_path(env: dict | None = None) -> str:
    """The port's H100 medians the bench's gate and trend judge against,
    and ``promote_baseline`` writes: ``$TPKT_BENCH_BASELINE``, else
    ``tpukernels_torch/baseline_h100.json`` (committed). Never
    ``BASELINE.json``, the reference's TPU figures."""
    target = os.environ if env is None else env
    return target.get("TPKT_BENCH_BASELINE") or os.path.join(
        _REPO, "tpukernels_torch", "baseline_h100.json")


def serve_socket_path(env: dict | None = None) -> str:
    """The daemon's socket: ``$TPKT_SERVE_SOCKET`` when set (also the C
    entry's routing switch, ``capi.py``), else ``serve.sock`` under
    :func:`serve_dir`."""
    target = os.environ if env is None else env
    return target.get("TPKT_SERVE_SOCKET") or os.path.join(
        serve_dir(env), "serve.sock")


def serve_pidfile_path(env: dict | None = None) -> str:
    """The daemon's pidfile, held under ``flock`` while it runs."""
    return os.path.join(serve_dir(env), "serve.pid")


_TORN_NOTED: set = set()


def read_json_memoized(path: str, memo: dict) -> dict:
    """The parsed JSON object in ``path``, memoized on its (mtime, size)
    in the caller's ``memo``; {} when the file is absent, unreadable or
    not an object. A file that exists but does not parse is reported
    once per process (:func:`note_torn_artifact`), never raised."""
    try:
        st = os.stat(path)
    except OSError:
        return {}
    stat_key = (st.st_mtime_ns, st.st_size)
    hit = memo.get(path)
    if hit and hit[0] == stat_key:
        return hit[1]
    try:
        with open(path) as f:
            data = json.load(f)
    except OSError:
        return {}
    except ValueError as e:
        note_torn_artifact(path, str(e))
        data = {}
    if not isinstance(data, dict):
        data = {}
    memo[path] = (stat_key, data)
    return data


def note_torn_artifact(path: str, reason: str) -> None:
    """A persisted file that exists but does not parse: one stderr note
    and one ``artifact_rejected`` journal event, once per path per
    process; never raises (observability must not fail the read it
    observes)."""
    if path in _TORN_NOTED:
        return
    _TORN_NOTED.add(path)
    print(f"# torn artifact rejected: {path} ({reason})", file=sys.stderr)
    from tpukernels_torch.resilience import journal

    journal.emit("artifact_rejected", path=path, reason=reason)


def locked_json_update(path: str, mutate, load=None) -> dict:
    """flock-serialised read-modify-write of one JSON state file: a lock
    file beside it, a fresh read under the lock (``load(path)``, which
    must return a dict no one else holds, or a plain tolerant read),
    ``mutate(data)`` in place, and a
    crash-consistent write (``resilience/atomic.py``). Returns the
    written dict."""
    import fcntl

    from tpukernels_torch.resilience import atomic

    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(f"{path}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        data = load(path) if load is not None else read_json_memoized(
            path, {})
        mutate(data)
        atomic.dump_json(path, data)
    return data
