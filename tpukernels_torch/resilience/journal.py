"""Structured JSONL health-event log of the port.

The port's own copy of ``tpukernels/resilience/journal.py``. Every
resilience decision (an injected fault, an integrity failure, a
quarantine, a rejected envelope) and every span of ``obs/trace.py`` is
appended as one JSON line, so a run can be reconstructed from the
journal alone.

Routing (``TPKT_HEALTH_JOURNAL``, read on every call):

- unset, or ``0``/``off``/``none`` — journaling off, the default in
  every context (the port has no CLI that picks a default file);
- a directory — ``health_<date>.jsonl`` inside it;
- anything else — the journal file itself.

Events are best-effort: a full disk or an unwritable path degrades
observability and never fails the run being observed. Each record
carries an ISO timestamp, a unix ``t``, the ``pid`` and the
repository's ``git_head`` (None where the tree is not a git checkout).
"""

from __future__ import annotations

import datetime
import glob
import json
import os
import re
import subprocess
import time

_REPO = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
_DISABLED = ("", "0", "off", "none")
_HEAD_CACHE: list = []  # [sha or None] once resolved (per process)


def git_head(root=None):
    """HEAD sha of ``root`` (default: this repository), or None outside
    a git checkout or without git; never raises. For the default root, a
    copy of the repository without ``.git`` takes ``TPKT_GIT_HEAD``
    instead (the commit its caller copied it from), so its bench lines
    and events still name their code. Cached per process for the default
    root: the journal stamps every event."""
    if root is None and _HEAD_CACHE:
        return _HEAD_CACHE[0]
    try:
        r = subprocess.run(["git", "-C", root or _REPO, "rev-parse", "HEAD"],
                           capture_output=True, text=True, timeout=30)
        sha = r.stdout.strip() if r.returncode == 0 else ""
    except (OSError, subprocess.SubprocessError):
        sha = ""
    if not sha and root is None:
        sha = os.environ.get("TPKT_GIT_HEAD", "").strip()
    sha = sha or None
    if root is None:
        _HEAD_CACHE.append(sha)
    return sha


def resolve(raw):
    """One ``TPKT_HEALTH_JOURNAL`` value as a file path, or None when it
    means off: a directory means a dated file inside it."""
    if raw is None or raw.strip().lower() in _DISABLED:
        return None
    if os.path.isdir(raw):
        return os.path.join(
            raw, f"health_{datetime.date.today().isoformat()}.jsonl")
    return raw


def path():
    """The journal file of this process now, or None when it is off."""
    return resolve(os.environ.get("TPKT_HEALTH_JOURNAL"))


_DATED = re.compile(r"health_(\d{4}-\d{2}-\d{2})\.jsonl$")


def directory():
    """The folder of the dated journal files: the one
    ``TPKT_HEALTH_JOURNAL`` names, or the folder of the file it names;
    None when journaling is off."""
    raw = os.environ.get("TPKT_HEALTH_JOURNAL")
    p = resolve(raw)
    if p is None:
        return None
    return raw if os.path.isdir(raw) else (os.path.dirname(p) or ".")


def dated_files() -> dict:
    """``{date: [paths]}`` of the ``health_<date>.jsonl`` files in
    :func:`directory`, ascending by date ({} with journaling off)."""
    d = directory()
    if d is None:
        return {}
    out: dict = {}
    for p in sorted(glob.glob(os.path.join(d, "health_*.jsonl"))):
        m = _DATED.search(os.path.basename(p))
        if m:
            out.setdefault(m.group(1), []).append(p)
    return dict(sorted(out.items()))


def reader_paths(explicit=None) -> list:
    """The journal files a report reads: ``explicit``, else
    ``TPKT_HEALTH_JOURNAL`` (a directory: its newest dated file), else
    none. Never a default file: the port has none."""
    if explicit:
        return list(explicit)
    raw = os.environ.get("TPKT_HEALTH_JOURNAL")
    if resolve(raw) is None:
        return []
    if os.path.isdir(raw):
        dated = dated_files()
        return dated[max(dated)] if dated else []
    return [raw]


def load_events(paths):
    """``(events, bad_lines)`` from JSONL journal files, in file and line
    order. Blank lines and missing files are skipped and a line that
    does not parse is counted, not raised: a journal cut by a crash is
    when its reader needs what survived."""
    events, bad = [], 0
    for p in paths:
        try:
            f = open(p)
        except OSError:
            continue
        with f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    bad += 1
                    continue
                if isinstance(rec, dict):
                    events.append(rec)
    return events, bad


def emit(kind: str, **fields):
    """Append one event; never raises."""
    p = path()
    if p is None:
        return
    now = time.time()
    rec = {
        "ts": datetime.datetime.fromtimestamp(now).isoformat(
            timespec="seconds"),
        "t": round(now, 3),
        "pid": os.getpid(),
        "git_head": git_head(),
        "kind": kind,
    }
    rec.update(fields)
    try:
        d = os.path.dirname(p)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(p, "a") as f:
            f.write(json.dumps(rec, default=repr) + "\n")
    except OSError:
        pass
