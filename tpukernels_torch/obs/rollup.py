"""Daily journal rollups: one compact, validated artifact a day.

The port's copy of ``tpukernels/obs/rollup.py``. The journal is per day
and per run; the long-horizon questions ("has the scan's p99 crept over
a week?", "what shape mix should the bucket optimizer mine when today
had no traffic?") need a compact series. :func:`build` compacts one
day's journal events into one ``rollup_<date>.json`` holding what those
readers use:

- ``counters``: the fleet's metric counters, rebuilt a pid at a time by
  ``obs.metrics.merge_journal_metrics`` (snapshots deduplicated by (pid,
  seq), a final ``metrics`` event authoritative);
- ``requests``: per kernel, the wall-time histogram of the OK
  ``serve_request`` events, in the metrics module's log buckets (the
  same ``percentiles`` arithmetic reads it);
- ``shape_mix``: ``serve.adapt.shape_mix`` rows, which
  ``adapt.window_mix`` folds into a multi-day window;
- ``kinds``: a census of the day's event kinds.

The artifact is written atomically (``resilience/atomic.py``), stamped
with the installed torch version (read without importing torch,
``tuning.cache.installed_versions``) and the newest commit touching
:data:`SOURCES`, and validated when read: a torn file, another schema, a
date that is not its file name's, another torch or a stale sha is
rejected loudly (one stderr line and one ``artifact_rejected`` event
with ``family: "rollup"``, once a process and cause) and read as absent.
The body holds no time stamp: the same events give byte-identical JSON,
so a second roll-up of a day is a no-op and a changed rollup means
changed evidence.

Rollups live in ``_cachedir.rollup_dir()`` (``TPKT_ROLLUP_DIR``, else
``.tpkt_cache/rollup``), never in ``docs/logs/``, which holds the
reference's TPU evidence. The journal they compact is the directory
``TPKT_HEALTH_JOURNAL`` resolves to (a directory, or a file's folder):
the port's journal has no default file, so with journaling off there is
nothing to roll up and the CLI says so (rc 1).

    python -m tpukernels_torch.obs.rollup [--date YYYY-MM-DD]

compacts every dated ``health_<date>.jsonl`` there (or one date) and
prunes rollups past :data:`RETENTION_DAYS`. Standard library only.
"""

from __future__ import annotations

import datetime
import glob
import os
import re
import sys

from tpukernels_torch import _cachedir
from tpukernels_torch.obs import metrics as obs_metrics
from tpukernels_torch.resilience import journal

SCHEMA = 1
# pruned by the CLI: long enough for quarterly forensics
RETENTION_DAYS = 90

# sources whose newer commit invalidates a persisted rollup: the
# compactor, the histogram and merge arithmetic, and the miner whose
# shape_mix rows the artifact stores
SOURCES = (
    "tpukernels_torch/obs/rollup.py",
    "tpukernels_torch/obs/metrics.py",
    "tpukernels_torch/serve/adapt.py",
)

_ROLLUP_RE = re.compile(r"rollup_(\d{4}-\d{2}-\d{2})\.json$")

_MEMO: dict = {}
_REJECT_NOTED: set = set()


def reset():
    """Drop per-process state (tests)."""
    _MEMO.clear()
    _REJECT_NOTED.clear()


def rollup_dir() -> str:
    return _cachedir.rollup_dir()


def rollup_path(date_str: str) -> str:
    return os.path.join(rollup_dir(), f"rollup_{date_str}.json")


# which files ``TPKT_HEALTH_JOURNAL`` names is the journal's one policy
journal_dir = journal.directory
journal_dates = journal.dated_files


def _torch_version():
    from tpukernels_torch.tuning import cache as tcache

    return tcache.installed_versions()[0]


def build(date_str: str, events, bad_lines: int = 0) -> dict:
    """The rollup body of one day's events: pure and free of time
    stamps, so the same events give byte-identical JSON."""
    from tpukernels_torch.serve import adapt
    from tpukernels_torch.tuning import cache as tcache

    kinds: dict = {}
    for e in events:
        k = e.get("kind")
        if isinstance(k, str):
            kinds[k] = kinds.get(k, 0) + 1

    merged = obs_metrics.merge_journal_metrics(events)
    counters: dict = {}
    for state in merged.values():
        for name, v in state["counters"].items():
            if isinstance(v, (int, float)):
                counters[name] = counters.get(name, 0) + v

    hists: dict = {}
    for e in events:
        if e.get("kind") != "serve_request" or not e.get("ok"):
            continue
        kernel = e.get("kernel")
        w = e.get("wall_s")
        if not kernel or not isinstance(w, (int, float)):
            continue
        h = hists.get(kernel)
        if h is None:
            hists[kernel] = [1, float(w), float(w), float(w),
                             {obs_metrics.bucket_index(w): 1}]
        else:
            h[0] += 1
            h[1] += float(w)
            h[2] = min(h[2], float(w))
            h[3] = max(h[3], float(w))
            b = obs_metrics.bucket_index(w)
            h[4][b] = h[4].get(b, 0) + 1
    requests = {
        k: obs_metrics._hist_row(v) for k, v in sorted(hists.items())
    }

    return {
        "schema": SCHEMA,
        "date": date_str,
        "torch": _torch_version(),
        "source_sha": tcache.source_sha(SOURCES),
        "git_head": journal.git_head(),
        "events": len(events),
        "bad_lines": bad_lines,
        "pids": len(merged),
        "kinds": kinds,
        "counters": counters,
        "requests": requests,
        "shape_mix": adapt.shape_mix(events),
    }


def write_day(date_str: str, paths=None):
    """Compact one day's journal files into ``rollup_<date>.json``
    (atomic; a ``rollup_written`` event). Returns the path, or None when
    the day has no events."""
    if paths is None:
        paths = journal_dates().get(date_str, [])
    events, bad = journal.load_events(paths)
    if not events:
        return None
    art = build(date_str, events, bad_lines=bad)
    p = rollup_path(date_str)
    os.makedirs(os.path.dirname(p), exist_ok=True)
    from tpukernels_torch.resilience import atomic

    atomic.dump_json(p, art)
    _MEMO.pop(p, None)
    journal.emit(
        "rollup_written", path=p, date=date_str,
        events=len(events), bad_lines=bad,
        kernels=sorted(art["requests"]),
        requests=sum(r["count"] for r in art["requests"].values()),
    )
    return p


def _reject(p: str, reason: str, emit: bool = True, **fields):
    """One stderr line and one ``artifact_rejected`` event a process,
    path and cause. A torn file's event is the shared reader's own
    (``_cachedir.note_torn_artifact``), so ``emit`` is False there."""
    memo = (p, reason)
    if memo in _REJECT_NOTED:
        return
    _REJECT_NOTED.add(memo)
    print(f"# rollup rejected: {os.path.basename(p)}: {reason}",
          file=sys.stderr)
    if emit:
        journal.emit("artifact_rejected", path=p, reason=reason,
                     family="rollup", **fields)


def load_day(date_str: str, validate: bool = True):
    """The validated rollup of one date, or None. A rollup written under
    another torch, or older than a commit to :data:`SOURCES`, is stale:
    a day compacted by last month's mining code must not steer today's
    bucket table."""
    p = rollup_path(date_str)
    data = _cachedir.read_json_memoized(p, _MEMO)
    if not data:
        if os.path.exists(p):
            _reject(p, "torn or empty", emit=False)
        return None
    if data.get("schema") != SCHEMA:
        _reject(p, f"schema {data.get('schema')!r}, expected {SCHEMA}")
        return None
    if data.get("date") != date_str:
        _reject(p, f"date {data.get('date')!r} does not match filename")
        return None
    if not validate:
        return data
    if data.get("torch") != _torch_version():
        _reject(p, f"written under torch {data.get('torch')}, "
                   f"running {_torch_version()}")
        return None
    from tpukernels_torch.tuning import cache as tcache

    sha = tcache.source_sha(SOURCES)
    if sha is not None and data.get("source_sha") not in (None, sha):
        _reject(p, "stale: a commit touching " + ",".join(SOURCES)
                + " postdates this rollup",
                entry_sha=data.get("source_sha"), current_sha=sha)
        return None
    return data


def rollup_dates() -> list:
    """Dates (ascending) with a rollup file on disk; validity is checked
    by :func:`load_day`."""
    out = []
    for p in sorted(glob.glob(os.path.join(rollup_dir(), "rollup_*.json"))):
        m = _ROLLUP_RE.search(os.path.basename(p))
        if m:
            out.append(m.group(1))
    return out


def load_series(days: int | None = None, end_date: str | None = None,
                validate: bool = True) -> list:
    """``[(date, rollup), ...]`` ascending over the validated rollups:
    at most the last ``days`` dates, none after ``end_date``. A rejected
    rollup is skipped, never replaced."""
    dates = rollup_dates()
    if end_date is not None:
        dates = [d for d in dates if d <= end_date]
    if days is not None:
        dates = dates[-days:]
    out = []
    for d in dates:
        data = load_day(d, validate=validate)
        if data is not None:
            out.append((d, data))
    return out


def prune(retention_days: int = RETENTION_DAYS,
          today: str | None = None) -> list:
    """Unlink the rollups older than ``retention_days`` (by the date in
    the file name); returns the paths pruned."""
    if today is None:
        today = datetime.date.today().isoformat()
    cutoff = (datetime.date.fromisoformat(today)
              - datetime.timedelta(days=retention_days)).isoformat()
    pruned = []
    for d in rollup_dates():
        if d < cutoff:
            p = rollup_path(d)
            try:
                os.unlink(p)
            except OSError:
                continue
            _MEMO.pop(p, None)
            pruned.append(p)
    return pruned


def main(argv=None) -> int:
    """Compact every dated journal file present (or one date) and prune
    past retention: 0 done, 1 journaling off, 2 usage."""
    argv = list(sys.argv[1:] if argv is None else argv)
    date = None
    while argv:
        a = argv.pop(0)
        if a == "--date" and argv:
            date = argv.pop(0)
        else:
            print(f"usage: python -m tpukernels_torch.obs.rollup "
                  f"[--date YYYY-MM-DD]  (got {a!r})", file=sys.stderr)
            return 2
    if journal_dir() is None:
        print("rollup: TPKT_HEALTH_JOURNAL is unset or off - no journal "
              "to roll up", file=sys.stderr)
        return 1
    by_date = journal_dates()
    if date is not None:
        by_date = {date: by_date.get(date, [])}
    wrote = 0
    for d, paths in by_date.items():
        p = write_day(d, paths)
        if p:
            wrote += 1
            print(f"rollup: {p}")
        else:
            print(f"rollup: {d}: no events, skipped")
    for p in prune():
        print(f"rollup: pruned {p}")
    print(f"rollup: {wrote} day(s) written, "
          f"{len(by_date) - wrote} skipped")
    return 0


if __name__ == "__main__":
    sys.exit(main())
