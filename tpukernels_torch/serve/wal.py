"""Bounded fsync'd write-ahead log for the fleet router's accepted
requests.

The port's copy of ``tpukernels/serve/wal.py``, record for record: a
log either package writes reads the same in the other.

The router is the fleet's admission point: once it answers (or will
answer) "accepted", the request must survive the router's own death.
This JSONL log (``router.wal`` beside ``fleet.json``) records one
``req`` line per accepted dispatch — appended and ``fsync``'d BEFORE
the forward, so a SIGKILL at any later instant leaves a durable
descriptor — and one ``ack`` line when the request reaches ANY
terminal reply (success, shed, relayed error: the client got an
answer, nothing left to replay). A respawned router replays the
unacknowledged entries once through the ``replay`` idempotency header
(``protocol.py``; kernels are pure, request_ids are preserved,
consumers dedupe by id).

Bounded, O(inflight): appends and acks grow the file, but every
``COMPACT_SLACK``-or-``4 x pending`` operations it is rewritten
crash-consistently (the port's ``resilience/atomic.py``) to hold only the
still-pending entries — steady-state size tracks the in-flight window,
not traffic volume. A torn LAST line (the crash landed mid-append,
before the fsync returned) is normal crash residue, skipped on read:
that request was never durably accepted, and the client's reconnect
budget owns its retry; a respawned router cuts it off before its first
append. Torn MIDDLE lines cannot happen — every append is fsync'd
before the next starts.

Single-writer by design (the router process; ``threading.Lock``
serializes its client threads). Standard library only.
"""

from __future__ import annotations

import json
import os
import sys
import threading

# compaction cadence: rewrite once the op count since the last
# compaction exceeds max(this, 4 x pending) — rare enough to amortize,
# tight enough that the file stays O(inflight)
COMPACT_SLACK = 64


def read_pending(path: str) -> dict:
    """Unacknowledged entries of a (possibly crash-torn) WAL, in
    append order: ``{key: entry}``. Tolerant of a torn tail line
    (normal crash residue — see module docstring); missing file reads
    as empty. Usable without a :class:`Wal` instance (fsck, tests)."""
    pending: dict = {}
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError:
        return pending
    for line in raw.split(b"\n"):
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            continue  # torn tail: never durably accepted
        if not isinstance(rec, dict):
            continue
        key = rec.get("key")
        if rec.get("op") == "req" and key is not None:
            pending[key] = rec.get("e")
        elif rec.get("op") == "ack":
            pending.pop(key, None)
    return pending


def _drop_torn_tail(path: str):
    """Cut a torn last line (bytes after the last newline) off the log
    before appending to it: appended after the fragment, the next
    record would share its line and be lost with it on the next read.
    (The reference appends after the fragment.)"""
    try:
        with open(path, "rb+") as f:
            data = f.read()
            if data and not data.endswith(b"\n"):
                f.truncate(data.rfind(b"\n") + 1)
                os.fsync(f.fileno())
    except OSError:
        pass


class Wal:
    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        # recover-then-append: entries pending at open time are the
        # previous incarnation's replay debt — the router drains them
        # via take_pending() before serving
        self._pending = read_pending(path)
        _drop_torn_tail(path)
        self._f = open(path, "ab")
        self._ops = 0

    def append(self, key: str, entry: dict):
        with self._lock:
            self._write({"op": "req", "key": key, "e": entry})
            self._pending[key] = entry
            self._maybe_compact()

    def ack(self, key: str):
        with self._lock:
            if key not in self._pending:
                return
            del self._pending[key]
            self._write({"op": "ack", "key": key})
            self._maybe_compact()

    def take_pending(self) -> dict:
        """Snapshot of the pending entries (append order) for replay.
        Entries stay pending until individually ack'd — a second crash
        mid-replay re-replays the remainder."""
        with self._lock:
            return dict(self._pending)

    def depth(self) -> int:
        with self._lock:
            return len(self._pending)

    def close(self):
        """Close the handle; a WAL with nothing pending is removed —
        a clean shutdown leaves no file to mistake for replay debt."""
        with self._lock:
            try:
                self._f.close()
            except OSError:
                pass
            if not self._pending:
                try:
                    os.unlink(self.path)
                except OSError:
                    pass

    # ------------------------------------------------------------ #
    # internals (call under self._lock)                            #
    # ------------------------------------------------------------ #

    def _write(self, rec: dict):
        line = (json.dumps(rec, sort_keys=True) + "\n").encode("utf-8")
        try:
            self._f.write(line)
            self._f.flush()
            os.fsync(self._f.fileno())
        except (OSError, ValueError) as e:  # ValueError: closed file

            # a WAL that cannot persist must not take down serving —
            # it degrades (loudly) to the client-retry-only story
            print(f"# wal: append failed on {self.path}: {e}",
                  file=sys.stderr)

    def _maybe_compact(self):
        self._ops += 1
        if self._ops < max(COMPACT_SLACK, 4 * len(self._pending)):
            return
        from tpukernels_torch.resilience import atomic

        text = "".join(
            json.dumps({"op": "req", "key": k, "e": e}, sort_keys=True)
            + "\n"
            for k, e in self._pending.items()
        )
        try:
            self._f.close()
            atomic.write_text(self.path, text)
        except OSError as e:
            print(f"# wal: compaction failed on {self.path}: {e}",
                  file=sys.stderr)
        finally:
            self._f = open(self.path, "ab")
        self._ops = 0
