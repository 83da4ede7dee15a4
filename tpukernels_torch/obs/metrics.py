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
to the journal once: at every Python process's exit (an ``atexit``
hook), and from the C entry at shutdown, since a C host never finalises
its interpreter.

Live streaming (``TPKT_METRICS_FLUSH_S``, off by default): the serving
daemon starts :func:`start_flusher`, a thread that emits one
``metrics_snapshot`` event an interval: a per-process ``seq``, counter
deltas since the last flush (zero deltas left out), every gauge, and the
histogram rows whose count moved (each row whole). The exit ``metrics``
event stays the full final state; :func:`merge_journal_metrics` is the
one way to fold both back into per-process state.
"""

from __future__ import annotations

import atexit
import math
import os
import sys
import threading
import time

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


def _recorded() -> bool:
    return bool(_COUNTERS or _GAUGES or _HISTS)


def emit_snapshot(site: str | None = None):
    """Emit one ``metrics`` journal event holding the full snapshot; a
    no-op when nothing was recorded or journaling is off, so a process
    that records nothing never creates a journal file."""
    if not _recorded():
        return
    if journal.path() is None:
        return
    journal.emit("metrics", site=site, **snapshot())


# the flusher's state, under _LOCK: the last snapshot's seq, the counter
# values and histogram counts it saw (deltas are taken against them),
# and the wall time of the last flush ([] before the first)
_SEQ = 0
_FLUSH_COUNTERS: dict = {}
_FLUSH_HIST_COUNTS: dict = {}
_LAST_FLUSH: list = []
_FLUSHER: threading.Thread | None = None
_FLUSHER_STOP = threading.Event()


def flush_interval_s(env=None) -> float | None:
    """``TPKT_METRICS_FLUSH_S`` in seconds, or None (the flusher off)
    when unset, empty or ``0``/``off``/``none``/``false``; any other
    value that is not a positive number raises ValueError."""
    raw = (os.environ if env is None else env).get("TPKT_METRICS_FLUSH_S")
    if raw is None or raw.strip().lower() in ("", "0", "off", "none",
                                              "false"):
        return None
    try:
        val = float(raw)
    except ValueError:
        val = -1.0
    if not val > 0.0:
        raise ValueError(
            f"TPKT_METRICS_FLUSH_S={raw!r}: expected a positive number of "
            "seconds, or 0/off/none/false to disable")
    return val


def emit_periodic_snapshot(site: str | None = None) -> int | None:
    """Emit one delta-encoded ``metrics_snapshot`` event and return its
    seq; None (nothing emitted) when journaling is off or nothing was
    ever recorded."""
    global _SEQ
    if journal.path() is None:
        return None
    with _LOCK:
        if not _recorded():
            return None
        deltas = {}
        for k, v in _COUNTERS.items():
            d = v - _FLUSH_COUNTERS.get(k, 0)
            if d:
                deltas[k] = d
        hists = {k: _hist_row(v) for k, v in _HISTS.items()
                 if v[0] != _FLUSH_HIST_COUNTS.get(k)}
        gauges = dict(_GAUGES)
        _SEQ += 1
        seq = _SEQ
        _FLUSH_COUNTERS.clear()
        _FLUSH_COUNTERS.update(_COUNTERS)
        _FLUSH_HIST_COUNTS.clear()
        _FLUSH_HIST_COUNTS.update({k: v[0] for k, v in _HISTS.items()})
        _LAST_FLUSH[:] = [time.time()]
    journal.emit("metrics_snapshot", seq=seq, site=site, counters=deltas,
                 gauges=gauges, histograms=hists)
    return seq


def last_flush_age_s() -> float | None:
    """Seconds since the last periodic snapshot; None before the first.
    A value that grows past the interval means the flusher died."""
    with _LOCK:
        if not _LAST_FLUSH:
            return None
        return max(0.0, time.time() - _LAST_FLUSH[0])


def _flusher_loop(interval_s: float):
    site = "flush:" + os.path.basename(sys.argv[0] or "?")
    # no blanket except: journal.emit never raises, so an exception here
    # is a bug, and a dead thread is what last_flush_age_s reports
    while not _FLUSHER_STOP.wait(interval_s):
        emit_periodic_snapshot(site=site)


def start_flusher(interval_s: float | None = None) -> bool:
    """Start the flusher thread (idempotent); the interval defaults to
    ``TPKT_METRICS_FLUSH_S``. False (no thread) when that is off."""
    global _FLUSHER
    if interval_s is None:
        interval_s = flush_interval_s()
    if interval_s is None:
        return False
    if _FLUSHER is not None and _FLUSHER.is_alive():
        return True
    _FLUSHER_STOP.clear()
    _FLUSHER = threading.Thread(target=_flusher_loop, args=(interval_s,),
                                daemon=True, name="tpkt-metrics-flusher")
    _FLUSHER.start()
    return True


def stop_flusher():
    """Stop the flusher thread if it runs."""
    global _FLUSHER
    t, _FLUSHER = _FLUSHER, None
    if t is not None and t.is_alive():
        _FLUSHER_STOP.set()
        t.join(timeout=5.0)
    _FLUSHER_STOP.clear()


def merge_journal_metrics(events) -> dict:
    """Per-process metric state rebuilt from journal events: a pid with
    a full ``metrics`` event takes its latest one outright; otherwise
    its ``metrics_snapshot`` events, deduplicated by (pid, seq), are
    folded in seq order (counter deltas summed, gauges and histogram
    rows latest-wins). Returns ``{pid: {"counters", "gauges",
    "histograms", "site", "seq", "final", "t", "ts"}}``; ``final`` says
    whether the pid ended with a full snapshot, ``seq`` is its highest
    snapshot seq (None when it has only ``metrics``)."""
    finals: dict = {}
    snaps: dict = {}
    for e in events:
        kind = e.get("kind")
        if kind == "metrics":
            finals[e.get("pid")] = e
        elif kind == "metrics_snapshot" and isinstance(e.get("seq"), int):
            snaps.setdefault(e.get("pid"), {})[e["seq"]] = e
    out: dict = {}
    for pid, by_seq in snaps.items():
        if pid in finals:
            continue
        counters: dict = {}
        gauges: dict = {}
        hists: dict = {}
        for seq in sorted(by_seq):
            e = by_seq[seq]
            for k, d in (e.get("counters") or {}).items():
                if isinstance(d, (int, float)):
                    counters[k] = counters.get(k, 0) + d
            gauges.update(e.get("gauges") or {})
            hists.update({k: row for k, row in
                          (e.get("histograms") or {}).items()
                          if isinstance(row, dict)})
        last = by_seq[max(by_seq)]
        out[pid] = {"counters": counters, "gauges": gauges,
                    "histograms": hists, "site": last.get("site"),
                    "seq": max(by_seq), "final": False, "t": last.get("t"),
                    "ts": last.get("ts")}
    for pid, e in finals.items():
        seqs = snaps.get(pid)
        out[pid] = {"counters": dict(e.get("counters") or {}),
                    "gauges": dict(e.get("gauges") or {}),
                    "histograms": dict(e.get("histograms") or {}),
                    "site": e.get("site"),
                    "seq": max(seqs) if seqs else None, "final": True,
                    "t": e.get("t"), "ts": e.get("ts")}
    return out


def clear(prefix: str) -> None:
    """Drop the counters, gauges and histograms whose name starts with
    ``prefix``."""
    with _LOCK:
        for d in (_COUNTERS, _GAUGES, _HISTS):
            for k in [k for k in d if k.startswith(prefix)]:
                del d[k]


def reset():
    """Drop all recorded state, the flusher's bookkeeping too."""
    global _SEQ
    with _LOCK:
        _COUNTERS.clear()
        _GAUGES.clear()
        _HISTS.clear()
        _FLUSH_COUNTERS.clear()
        _FLUSH_HIST_COUNTS.clear()
        _LAST_FLUSH.clear()
        _SEQ = 0


def _atexit_flush():
    emit_snapshot(site="atexit:" + os.path.basename(sys.argv[0] or "?"))


atexit.register(_atexit_flush)
