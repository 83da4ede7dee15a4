"""What every long-lived serve process shares and that needs no device.

The daemon (``server.py``), the fleet router (``router.py``), its health
manager (``health.py``) and the guardian (``guardian.py``) read their
knobs through the same fail-loud parsers and hold their liveness the same
way: a pidfile under ``flock`` for the process's lifetime. In the
reference these live in ``tpukernels/serve/server.py`` (``_int_knob``,
``_float_knob``, ``_on_knob``, ``_hold_pidfile``) and
``tpukernels/serve/health.py`` (``pidfile_state``); the port keeps them
here because its ``server.py`` imports torch, and the router, the health
manager and the guardian must not: they never touch the card.

Standard library only.
"""

from __future__ import annotations

import os
import time

# the daemon's per-request patience; the router derives its own upstream
# patience from the same knob (``TPKT_SERVE_REQUEST_TIMEOUT_S``)
DEFAULT_REQUEST_TIMEOUT_S = 60.0


def int_knob(name: str, default: int, floor: int = 1) -> int:
    """``int(os.environ[name])``, ``default`` when unset or blank; a
    value that does not parse or lies under ``floor`` raises
    ValueError naming the knob."""
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return default
    try:
        val = int(raw)
    except ValueError:
        val = floor - 1
    if val < floor:
        raise ValueError(
            f"{name}={raw!r}: expected an int >= {floor}"
        )
    return val


def float_knob(name: str, default: float, floor: float = 0.0) -> float:
    """:func:`int_knob` for a float."""
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return default
    try:
        val = float(raw)
    except ValueError:
        val = floor - 1.0
    if val < floor:
        raise ValueError(
            f"{name}={raw!r}: expected a number >= {floor}"
        )
    return val


def on_knob(name: str, default: bool = True) -> bool:
    """An on-by-default switch knob (the TPKT_AOT_CACHE convention):
    ``0``/``off``/``none``/``false`` disable, anything else keeps the
    default."""
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return default
    return raw.strip().lower() not in ("0", "off", "none", "false")


def hold_pidfile(path: str):
    """Write-and-flock a daemon pidfile for the process lifetime —
    the revalidate_lib.sh watcher-lock convention: liveness is the
    flock, the recorded pid is the diagnosis. Returns the held file
    (kept open) or raises RuntimeError when another process holds it."""
    import fcntl

    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    # a+ so a losing contender can never truncate the holder's pid
    f = open(path, "a+")
    # a few NB retries: a liveness probe takes the flock for a flash —
    # a status check racing our startup must not read as "another
    # daemon" and abort us
    for attempt in range(5):
        try:
            fcntl.flock(f, fcntl.LOCK_EX | fcntl.LOCK_NB)
            break
        except OSError:
            if attempt < 4:
                time.sleep(0.1)
                continue
            f.seek(0)
            pid = f.readline().strip()
            f.close()
            raise RuntimeError(
                f"another serve daemon holds {path}"
                + (f" (pid {pid})" if pid else "")
            ) from None
    f.seek(0)
    f.truncate()
    f.write(f"{os.getpid()}\n")
    f.flush()
    return f


def pidfile_state(path: str):
    """``(held, pid_or_None)``: ``held`` means a LIVE process flocks
    the pidfile (test the lock, never trust the recorded pid alone)."""
    import fcntl

    try:
        f = open(path)
    except OSError:
        return False, None
    with f:
        content = f.readline().strip()
        pid = int(content) if content.isdigit() else None
        try:
            fcntl.flock(f.fileno(), fcntl.LOCK_EX | fcntl.LOCK_NB)
            fcntl.flock(f.fileno(), fcntl.LOCK_UN)
        except OSError:
            return True, pid
    return False, pid
