"""Where the port keeps its state, and how it reads and writes it.

The port's own copy of ``tuning_cache_path``, ``read_json_memoized``,
``note_torn_artifact``, ``locked_json_update``, the integrity guard's
paths and the serving daemon's paths in ``tpukernels/_cachedir.py``. The state lives in the repository's
``.tpkt_cache/`` (gitignored) unless an env var redirects it; the env is
read on every call, so a test's redirect takes effect at once.
"""

from __future__ import annotations

import json
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _state_dir(var: str, env: dict | None) -> str:
    target = os.environ if env is None else env
    return target.get(var) or os.path.join(_REPO, ".tpkt_cache")


def tuning_cache_path(env: dict | None = None) -> str:
    """``$TPKT_TUNING_CACHE_DIR/tuning.json``, else
    ``<repo>/.tpkt_cache/tuning.json``."""
    return os.path.join(_state_dir("TPKT_TUNING_CACHE_DIR", env),
                        "tuning.json")


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


def serve_dir(env: dict | None = None) -> str:
    """Runtime directory of the serving daemon (``serve/server.py``): its
    Unix-domain socket and its flocked pidfile. ``$TPKT_SERVE_DIR``, else
    ``<repo>/.tpkt_cache``; tests redirect it, so a test daemon never
    collides with an operator's."""
    return _state_dir("TPKT_SERVE_DIR", env)


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
