"""Nested span tracing into the port's journal.

The port's own copy of ``tpukernels/obs/trace.py``. ``with
span("dispatch/sgemm"):`` times one phase and, on exit, emits one
``span`` journal event (``resilience/journal.py``) with its slash-joined
path, wall seconds, depth, ``ok`` and any keyword fields.
``registry.dispatch`` opens ``dispatch/<key>`` and the integrity guard
``integrity/canary/<key>`` inside it.

``with request_ctx(rid):`` binds a request id to the calling thread:
every span the thread emits inside it carries ``request_id``, so the
serving daemon's worker tags its wait, pad and dispatch spans, and the
nested ones that know nothing of requests, with the client's id. The
binding is always on; only span emission waits on ``TPKT_TRACE``.

``TPKT_TRACE`` is read once, at import (a process that sets it later
calls :func:`reload`): unset or ``0``/``off``/``none`` makes
:func:`span` one module-global check that returns a shared no-op
object. The span stack is per thread.
"""

from __future__ import annotations

import os
import threading
import time

from tpukernels_torch.resilience import journal

_DISABLED = ("", "0", "off", "none")


def _read_enabled() -> bool:
    raw = os.environ.get("TPKT_TRACE")
    return raw is not None and raw.strip().lower() not in _DISABLED


_ENABLED = _read_enabled()
_TLS = threading.local()  # .stack: open span names; .request: its id


def _stack() -> list:
    s = getattr(_TLS, "stack", None)
    if s is None:
        s = _TLS.stack = []
    return s


def enabled() -> bool:
    return _ENABLED


def reload() -> bool:
    """Re-read ``TPKT_TRACE`` and clear this thread's span stack."""
    global _ENABLED
    _ENABLED = _read_enabled()
    _stack().clear()
    return _ENABLED


def current_path() -> str | None:
    """Slash-joined path of the innermost open span, or None."""
    s = _stack()
    return "/".join(s) if s else None


def current_request() -> str | None:
    """The calling thread's request id, or None."""
    return getattr(_TLS, "request", None)


class _RequestCtx:
    """Binds a request id to the calling thread, and restores the one
    bound before on exit."""

    __slots__ = ("rid", "prev")

    def __init__(self, rid):
        self.rid = rid

    def __enter__(self):
        self.prev = getattr(_TLS, "request", None)
        _TLS.request = self.rid
        return self

    def __exit__(self, *exc):
        _TLS.request = self.prev
        return False


def request_ctx(request_id):
    """Context manager binding ``request_id`` to the calling thread: the
    spans emitted inside it carry it. None is a valid binding (a client
    that sends no id): the spans then carry none."""
    return _RequestCtx(request_id)


class _NoopSpan:
    """The shared do-nothing span of the disabled path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()

# keys the emitter owns: a caller field of the same name is prefixed
# with ``param_`` instead of clobbering them
_RESERVED = ("kind", "ts", "t", "pid", "git_head", "name", "wall_s",
             "depth", "ok", "request_id")


def _payload(fields: dict) -> dict:
    out = {("param_" + k if k in _RESERVED else k): v
           for k, v in fields.items()}
    rid = getattr(_TLS, "request", None)
    if rid is not None:
        out["request_id"] = rid
    return out


class _Span:
    __slots__ = ("name", "fields", "path", "t0", "depth")

    def __init__(self, name: str, fields: dict):
        self.name = name
        self.fields = fields

    def __enter__(self):
        s = _stack()
        s.append(self.name)
        self.depth = len(s)
        self.path = "/".join(s)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        wall = time.perf_counter() - self.t0
        s = _stack()
        if s and s[-1] == self.name:
            s.pop()
        payload = _payload(self.fields)
        payload.update(name=self.path, wall_s=round(wall, 6),
                       depth=self.depth, ok=exc_type is None)
        journal.emit("span", **payload)
        return False


def span(name: str, /, **fields):
    """Context manager timing one named phase; ``fields`` ride on the
    event. With tracing off: one global check and a shared no-op."""
    if not _ENABLED:
        return _NOOP
    return _Span(name, fields)


def emit_span(name: str, wall_s: float, /, **fields):
    """Emit one span measured elsewhere (from timestamps), joined onto
    this thread's open span path and tagged with its request, as
    :func:`span` would."""
    if not _ENABLED:
        return
    s = _stack()
    payload = _payload(fields)
    payload.update(name="/".join([*s, name]) if s else name,
                   wall_s=round(wall_s, 6), depth=len(s) + 1, ok=True)
    journal.emit("span", **payload)


def aggregate_spans(events) -> dict:
    """``{name: {"count", "total_s", "max_s"}}`` over ``span`` events."""
    agg: dict = {}
    for ev in events:
        if ev.get("kind") != "span":
            continue
        name = ev.get("name", "?")
        wall = ev.get("wall_s") or 0.0
        a = agg.get(name)
        if a is None:
            agg[name] = {"count": 1, "total_s": wall, "max_s": wall}
        else:
            a["count"] += 1
            a["total_s"] += wall
            a["max_s"] = max(a["max_s"], wall)
    return agg
