"""Where the port keeps its state, and how it reads it back.

The port's own copy of ``tuning_cache_path`` and ``read_json_memoized``
in ``tpukernels/_cachedir.py``. The state lives in the repository's
``.tpkt_cache/`` (gitignored) unless an env var redirects it; the env is
read on every call, so a test's redirect takes effect at once.
"""

from __future__ import annotations

import json
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tuning_cache_path(env: dict | None = None) -> str:
    """``$TPKT_TUNING_CACHE_DIR/tuning.json``, else
    ``<repo>/.tpkt_cache/tuning.json``."""
    target = os.environ if env is None else env
    d = target.get("TPKT_TUNING_CACHE_DIR") or os.path.join(_REPO,
                                                           ".tpkt_cache")
    return os.path.join(d, "tuning.json")


_TORN_NOTED: set = set()


def read_json_memoized(path: str, memo: dict) -> dict:
    """The parsed JSON object in ``path``, memoized on its (mtime, size)
    in the caller's ``memo``; {} when the file is absent, unreadable or
    not an object. A file that exists but does not parse is reported
    once per process on stderr, never raised."""
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
        if path not in _TORN_NOTED:
            _TORN_NOTED.add(path)
            print(f"# torn artifact rejected: {path} ({e})", file=sys.stderr)
        data = {}
    if not isinstance(data, dict):
        data = {}
    memo[path] = (stat_key, data)
    return data
