"""Persistent tuning cache: the knob values a sweep found best, per key

    kernel|shape|dtype|device_kind      e.g. sgemm|1024x1024x1024|float32|nvidia_h100_80gb_hbm3

The port's copy of ``tpukernels/tuning/cache.py``. One JSON file,
``$TPKT_TUNING_CACHE_DIR/tuning.json`` or else the repository's
``.tpkt_cache/tuning.json``. Each entry holds the params and what scopes
them: the torch and CUDA versions, the sha of the newest commit touching
the space's ``sources``, the HEAD at the time, the measured value and
its control, and a wall-clock stamp. :func:`get` checks the versions and
the sha when it reads: an entry tuned under another torch or CUDA, or
before the kernel's sources last changed, is rejected loudly (one stderr
line per key and reason, and a count in :data:`COUNTS`), never applied.
Outside a git checkout the sha is not known and not checked.

Every wrapper consults the cache on every call (SAXPY and SGEMM through
a launch plan memoised on :func:`state`), so reads are memoized:
the parsed file is kept for :data:`RECHECK_S` seconds before the file is
looked at again (one ``stat`` costs more than the whole lookup from the
memo; ``chip_smoke.py`` phase 4 prints both), and re-read only when its
(mtime, size) changed. :func:`put` drops the memo, so a process sees
its own writes at once and another process's within ``RECHECK_S``.
:func:`put` is atomic (``_cachedir.locked_json_update``): flock, a
fresh read under the lock, a temporary file, fsync, rename.
``TPKT_TUNING_CACHE=0`` (or ``off``/``none``) turns lookups off.

An entry a ``--smoke`` sweep promoted (``tuning/runner.py``: values
measured with collapsed repeat counts on the CPU, so meaningless) is
honoured only in a run with ``TPKT_BENCH_SMOKE=1``; it is keyed
``device_kind=cpu`` besides, so it can never steer a card run.

Hits, misses and rejections are counted in :data:`COUNTS`; a rejection
also journals ``tuning_rejected`` (once a key and reason, as the stderr
line), a write ``tuning_cache_put``.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

from tpukernels_torch import _cachedir
from tpukernels_torch.resilience import journal

_REPO = _cachedir._REPO
_DISABLED = ("0", "off", "none")
RECHECK_S = 1.0
_FILE_MEMO: dict = {}  # path -> (stat_key, parsed)
_FRESH: dict = {}  # path -> (monotonic time of the last look, parsed)
_SHA_MEMO: dict = {}  # (root, sources) -> sha or None
_KIND_MEMO: dict = {}  # CUDA device index -> kind
_PATHS: dict = {}  # TPKT_TUNING_CACHE_DIR (or None) -> path()
_REJECT_NOTED: set = set()  # (key, reason) already on stderr
COUNTS = {"hits": 0, "misses": 0, "rejections": 0}


_ENV = getattr(os.environ, "_data", None)  # the dict behind os.environ
_ENV_KEYS: dict = {}  # variable name -> the key that dict files it under


def env_raw(name: str):
    """The value of the environment variable ``name`` as ``os.environ``
    stores it (bytes on POSIX), None when it is unset. It follows every
    change made through ``os.environ``, as ``os.environ.get`` does, for
    a dict lookup: ``os.environ.get`` encodes the name and decodes the
    value on every read and raises and catches a KeyError on a miss,
    1.6 us a read where a whole call of a small kernel takes 20-30. For
    memo keys and the checks below, on every kernel call's path."""
    if _ENV is None:
        return os.environ.get(name)
    key = _ENV_KEYS.get(name)
    if key is None:
        key = _ENV_KEYS[name] = os.environ.encodekey(name)
    return _ENV.get(key)


def env_reader(names):
    """A function of no arguments returning the raw values of the
    variables ``names`` (as :func:`env_raw` reads each) in one tuple: for
    a memo key read on every call."""
    if _ENV is None:
        return lambda: tuple(map(os.environ.get, names))
    keys = tuple(os.environ.encodekey(n) for n in names)
    get = _ENV.get
    return lambda: tuple(map(get, keys))


def enabled() -> bool:
    if env_raw("TPKT_TUNING_CACHE") is None:
        return True
    return os.environ["TPKT_TUNING_CACHE"].strip().lower() not in _DISABLED


def path() -> str:
    d = env_raw("TPKT_TUNING_CACHE_DIR")
    p = _PATHS.get(d)
    if p is None:
        p = _PATHS[d] = _cachedir.tuning_cache_path()
    return p


def _load(p) -> dict:
    now = time.monotonic()
    seen = _FRESH.get(p)
    if seen is not None and now - seen[0] < RECHECK_S:
        return seen[1]
    data = _cachedir.read_json_memoized(p, _FILE_MEMO)
    _FRESH[p] = (now, data)
    return data


def state():
    """What :func:`get` reads now: None with lookups off, else the
    parsed file, the same object for as long as the memo keeps it (a
    changed file, or a :func:`put`, gives a new one)."""
    return _load(path()) if enabled() else None


def forget() -> None:
    """Drop the memo: the next lookup reads the file."""
    _FILE_MEMO.clear()
    _FRESH.clear()


def canon_shape(shape) -> str:
    if not shape:
        return "-"
    return "x".join(str(int(d)) for d in shape)


def canon_dtype(dtype) -> str:
    """A dtype as the reference writes it: ``float32``, not
    ``torch.float32``."""
    if dtype is None:
        return "-"
    return str(dtype).removeprefix("torch.")


def device_kind(device=None) -> str:
    """``cpu`` for the CPU, else the card's name lowercased with spaces
    as ``_`` (``nvidia_h100_80gb_hbm3``). ``device`` None means the
    card when there is one."""
    import torch

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    idx = torch.cuda.current_device() if device.index is None else device.index
    kind = _KIND_MEMO.get(idx)
    if kind is None:
        kind = _KIND_MEMO[idx] = (
            torch.cuda.get_device_name(idx).lower().replace(" ", "_"))
    return kind


def key_str(kernel, shape=None, dtype=None, kind=None) -> str:
    if kind is None:
        kind = device_kind()
    return "|".join((kernel, canon_shape(shape), canon_dtype(dtype), kind))


def _git(*args, root=None):
    try:
        r = subprocess.run(["git", "-C", root or _REPO, *args],
                           capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    out = r.stdout.strip()
    return out if r.returncode == 0 and out else None


def source_sha(sources, root=None):
    """Sha of the newest commit touching any of ``sources``, or None
    without git or history; memoized per process."""
    memo = (root or _REPO, tuple(sources))
    if memo not in _SHA_MEMO:
        _SHA_MEMO[memo] = (_git("log", "-1", "--format=%H", "--", *sources,
                                root=root) if sources else None)
    return _SHA_MEMO[memo]


def _versions():
    import torch

    return torch.__version__, torch.version.cuda


_INSTALLED: list = []  # [(torch version, CUDA version)] once read


def installed_versions():
    """``(torch.__version__, torch.version.cuda)`` without importing
    torch: a loaded torch answers itself; otherwise the literals of the
    installed package's ``version.py`` (which is what those two read),
    parsed, not run. For the processes that judge artifacts and never
    touch the card (``loadgen --serve``, ``serve.optimize propose``)."""
    if "torch" in sys.modules:
        return _versions()
    if not _INSTALLED:
        import ast
        import importlib.util

        spec = importlib.util.find_spec("torch")
        if spec is None or not spec.submodule_search_locations:
            raise ModuleNotFoundError("torch is not installed")
        src = os.path.join(list(spec.submodule_search_locations)[0],
                           "version.py")
        found = {}
        with open(src) as f:
            for node in ast.parse(f.read()).body:
                if isinstance(node, ast.Assign):
                    targets, value = node.targets, node.value
                elif isinstance(node, ast.AnnAssign):
                    targets, value = [node.target], node.value
                else:
                    continue
                for t in targets:
                    if isinstance(t, ast.Name) and isinstance(
                            value, ast.Constant):
                        found[t.id] = value.value
        _INSTALLED.append((found.get("__version__"), found.get("cuda")))
    return _INSTALLED[0]


def reject(key, reason, **fields) -> None:
    """Count a rejected entry or value; one stderr line and one
    ``tuning_rejected`` event per (key, reason) per process."""
    COUNTS["rejections"] += 1
    if (key, reason) in _REJECT_NOTED:
        return
    _REJECT_NOTED.add((key, reason))
    print(f"# tuning-cache rejected: {key} ({reason})", file=sys.stderr)
    journal.emit("tuning_rejected", key=key, reason=reason, **fields)


def get(space, shape=None, dtype=None, kind=None, device=None):
    """The params of a valid entry for (space.kernel, shape, dtype, the
    kind ``kind`` or that of ``device``), or None: cache off, no entry,
    or a stale one (rejected)."""
    if not enabled():
        return None
    entries = _load(path()).get("entries")
    if not isinstance(entries, dict) or not entries:
        COUNTS["misses"] += 1
        return None
    key = key_str(space.kernel, shape, dtype,
                  kind if kind is not None else device_kind(device))
    entry = entries.get(key)
    if not isinstance(entry, dict):
        COUNTS["misses"] += 1
        return None
    if entry.get("smoke") and os.environ.get("TPKT_BENCH_SMOKE") != "1":
        reject(key, "smoke entry ignored outside TPKT_BENCH_SMOKE=1")
        return None
    torch_v, cuda_v = _versions()
    if entry.get("torch") != torch_v:
        reject(key, f"tuned on torch {entry.get('torch')}, running {torch_v}")
        return None
    if entry.get("cuda") != cuda_v:
        reject(key, f"tuned on CUDA {entry.get('cuda')}, running {cuda_v}")
        return None
    sha = source_sha(space.sources)
    if sha is not None and entry.get("source_sha") not in (None, sha):
        reject(key, "stale: a commit touching " + ",".join(space.sources)
               + " postdates this entry")
        return None
    params = entry.get("params")
    if not isinstance(params, dict):
        COUNTS["misses"] += 1
        return None
    COUNTS["hits"] += 1
    return params


def put(space, params: dict, shape=None, dtype=None, kind=None,
        device=None, value=None, control=None, smoke=False,
        versions=None) -> str:
    """Write one entry atomically; returns its key. ``kind`` and
    ``versions`` (torch, CUDA) let the sweep runner stamp the identity
    its bench children measured under instead of this process's."""
    key = key_str(space.kernel, shape, dtype,
                  kind if kind is not None else device_kind(device))
    torch_v, cuda_v = versions if versions is not None else _versions()
    entry = {
        "params": {k: v for k, v in params.items() if v is not None},
        "value": value,
        "control": control,
        "torch": torch_v,
        "cuda": cuda_v,
        "source_sha": source_sha(space.sources),
        "git_head": _git("rev-parse", "HEAD"),
        "recorded": round(time.time(), 3),
        "smoke": bool(smoke),
    }

    def mutate(data):
        entries = data.get("entries")
        data["entries"] = dict(entries if isinstance(entries, dict) else {})
        data["entries"][key] = entry

    _cachedir.locked_json_update(path(), mutate)
    forget()
    journal.emit("tuning_cache_put", key=key, params=entry["params"],
                 value=value, control=control, smoke=bool(smoke))
    return key
