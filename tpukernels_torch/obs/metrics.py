"""Process-local metrics: counters, gauges and histograms.

The port's own copy of the recording half of
``tpukernels/obs/metrics.py``, and of its :func:`emit_snapshot`. A record
is a dict update under one module lock, with no I/O, so callers record
on every call: ``registry.dispatch`` counts ``dispatch.calls.<key>`` and
observes ``dispatch.wall_s.<key>``; the C entry (``capi.run_from_c``)
counts ``capi.calls.<k>`` and ``capi.errors.<k>`` and observes
``capi.wall_s.<k>``; the integrity guard counts
``integrity.checks``, ``integrity.deep_checks``,
``integrity.tier<N>.<key>``, ``integrity.failures``,
``integrity.quarantines``, ``integrity.rejections`` and
``integrity.check_errors``.

A histogram keeps its count, sum, min and max and a log-bucketed
distribution (four buckets an octave, about 19 % wide, one boundary
scheme for every histogram, so two runs observing the same values
produce the same buckets); :func:`snapshot` derives p50/p95/p99 from the
buckets, clamped to the exact max. State is per process and
thread-safe; :func:`reset` and :func:`clear` exist for tests and for
callers that read a window. :func:`emit_snapshot` writes the whole state
to the journal once; the C entry calls it at shutdown, since a C host
never finalises its interpreter.
"""

from __future__ import annotations

import math
import threading

from tpukernels_torch.resilience import journal

_LOCK = threading.Lock()
_COUNTERS: dict = {}
_GAUGES: dict = {}
_HISTS: dict = {}  # name -> [count, sum, min, max, {bucket: count}]

_BUCKET_LOG = math.log(2.0) / 4.0
_NONPOS_BUCKET = -(1 << 30)


def bucket_index(value: float) -> int:
    """The log bucket of one sample: floor(log(v) / log(2^(1/4))), one
    sentinel bucket for samples <= 0."""
    if value <= 0.0:
        return _NONPOS_BUCKET
    return math.floor(math.log(value) / _BUCKET_LOG)


def bucket_upper(idx: int) -> float:
    """Upper bound of bucket ``idx`` (0.0 for the sentinel)."""
    if idx == _NONPOS_BUCKET:
        return 0.0
    return math.exp((idx + 1) * _BUCKET_LOG)


def percentiles(count: int, max_value: float, buckets: dict,
                qs=(0.5, 0.95, 0.99)) -> list:
    """Count-weighted percentiles from a log-bucket dict: quantile q is
    the upper bound of the bucket holding the ceil(q * count)-th sample,
    clamped to the exact max. Keys may be ints or their str() forms."""
    items = sorted((int(k), v) for k, v in buckets.items())
    out = []
    for q in qs:
        rank = max(1, math.ceil(q * count))
        val = max_value
        cum = 0
        for idx, c in items:
            cum += c
            if cum >= rank:
                val = min(bucket_upper(idx), max_value)
                break
        out.append(val)
    return out


def inc(name: str, n: float = 1):
    """Add ``n`` (default 1) to counter ``name``, creating it at 0."""
    with _LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def gauge(name: str, value: float):
    """Set gauge ``name`` to ``value`` (last write wins)."""
    with _LOCK:
        _GAUGES[name] = value


def observe(name: str, value: float):
    """Record one sample into histogram ``name``."""
    b = bucket_index(value)
    with _LOCK:
        h = _HISTS.get(name)
        if h is None:
            _HISTS[name] = [1, value, value, value, {b: 1}]
            return
        h[0] += 1
        h[1] += value
        if value < h[2]:
            h[2] = value
        if value > h[3]:
            h[3] = value
        h[4][b] = h[4].get(b, 0) + 1


def counter(name: str, default=0):
    """The value of counter ``name``."""
    with _LOCK:
        return _COUNTERS.get(name, default)


def counters(prefix: str = "") -> dict:
    """The counters whose name starts with ``prefix``."""
    with _LOCK:
        return {k: v for k, v in _COUNTERS.items() if k.startswith(prefix)}


def _hist_row(v) -> dict:
    p50, p95, p99 = percentiles(v[0], v[3], v[4])
    return {
        "count": v[0],
        "sum": round(v[1], 6),
        "min": round(v[2], 6),
        "max": round(v[3], 6),
        "p50": round(p50, 6),
        "p95": round(p95, 6),
        "p99": round(p99, 6),
        # str keys: a snapshot read back from JSON has the same shape
        "buckets": {str(i): c for i, c in sorted(v[4].items())},
    }


def snapshot() -> dict:
    """``{"counters", "gauges", "histograms": {name: {count, sum, min,
    max, p50, p95, p99, buckets}}}``, a copy."""
    with _LOCK:
        return {
            "counters": dict(_COUNTERS),
            "gauges": dict(_GAUGES),
            "histograms": {k: _hist_row(v) for k, v in _HISTS.items()},
        }


def emit_snapshot(site: str | None = None):
    """Emit one ``metrics`` journal event holding the full snapshot; a
    no-op when nothing was recorded or journaling is off, so a process
    that records nothing never creates a journal file."""
    if not (_COUNTERS or _GAUGES or _HISTS):
        return
    if journal.path() is None:
        return
    journal.emit("metrics", site=site, **snapshot())


def clear(prefix: str) -> None:
    """Drop the counters, gauges and histograms whose name starts with
    ``prefix``."""
    with _LOCK:
        for d in (_COUNTERS, _GAUGES, _HISTS):
            for k in [k for k in d if k.startswith(prefix)]:
                del d[k]


def reset():
    """Drop all recorded state."""
    with _LOCK:
        _COUNTERS.clear()
        _GAUGES.clear()
        _HISTS.clear()
