"""Length-prefixed JSON + raw-buffer wire protocol of the serving daemon.

The port's copy of ``tpukernels/serve/protocol.py``: the frames, the
version, the header fields, the dtype codes and the ``/dev/shm`` segment
names are byte for byte the reference's, so the reference's clients
drive the port's daemon and the port's client drives the reference's.
Only the knobs carry the port's prefix (``TPKT_SERVE_SHM``,
``TPKT_SERVE_SHM_MIN_BYTES``).

One frame = a fixed 16-byte preamble (``TPK1`` magic, big-endian
header length, big-endian total payload length), a UTF-8 JSON header,
then the concatenated raw little-endian C-order array buffers the
header describes. Requests:

    {"v": 1, "op": "dispatch", "id": 7, "kernel": "scan",
     "statics": {}, "request_id": "c3f2a-12",
     "args": [{"shape": [4093], "dtype": "int32"}]}
    + one payload buffer per ``args`` entry

    {"v": 1, "op": "ping"}        # liveness / stats, no payload

A dispatch header may carry a deadline: ``deadline_ms`` (the total
budget) and ``budget_ms`` (what is left at the moment the frame was
sent, stamped again at every hop). No absolute time crosses the wire:
each receiver turns the budget into its own monotonic deadline
(:func:`deadline_from_header`) and each forwarder stamps the remainder
(:func:`stamp_budget`). ``replay`` (a fleet router's count of earlier
delivery attempts) and ``request_id`` (the client's trace id) ride
along; a server that does not know a field ignores it.

Responses:

    {"v": 1, "id": 7, "ok": true,
     "outputs": [{"shape": [4093], "dtype": "int32"}], ...}
    + one payload buffer per ``outputs`` entry

    {"v": 1, "id": 7, "ok": false, "error": "...",
     "kind": "overloaded", "retry_after_s": 0.25}

Two payload lanes:

- **inline** — payload bytes ride the socket after the header, split
  by ``_lens``; each byte crosses the kernel's socket buffer twice,
  which is what ``serve.bytes_copied`` counts.
- **shm** — a payload at or over ``TPKT_SERVE_SHM_MIN_BYTES`` (64 KiB)
  moves through a named ``/dev/shm`` segment the sender writes and the
  receiver maps read-only; only ``{"name", "nbytes"}`` rides the header
  (``_shm``, one slot a payload, null = inline). Negotiated at ping
  time (``lanes`` in the pong). Request segments are created and
  unlinked by the client; response segments are created by the server
  and unlinked by the client once it maps them (the server keeps an
  aged ledger, and sweeps dead creators' segments at start).

Transport only: no socket is created here, and the dtype table is the
C ABI's two dtypes. Standard library and numpy.
"""

from __future__ import annotations

import itertools
import json
import mmap
import os
import re
import struct
import time

import numpy as np

VERSION = 1
MAGIC = b"TPK1"
_PREAMBLE = struct.Struct(">4sIQ")

# sanity bounds, not resource limits: a header over 1 MiB or a frame
# over 4 GiB is a desynced/hostile stream, not a big request
MAX_HEADER = 1 << 20
MAX_PAYLOAD = 1 << 32

# at or under this many payload bytes, one syscall (head + payloads
# joined) beats streaming buffers separately; over it, buffers stream
# as-is so no user-space frame copy is ever materialized
SMALL_FRAME = 1 << 16

# the C ABI's dtype surface (capi._DTYPES), by canonical numpy name
DTYPES = {
    "float32": np.float32,
    "int32": np.int32,
}

# ------------------------------------------------------------------ #
# request deadlines (docs/SERVING.md §deadlines)                     #
# ------------------------------------------------------------------ #

def deadline_from_header(header, now=None):
    """The frame's remaining budget converted into THIS process's own
    local monotonic deadline, or ``None`` when the request carries no
    deadline. ``budget_ms`` (the per-hop remainder) wins; a header
    with only ``deadline_ms`` (a minimal client that never recomputes)
    falls back to it. Malformed values read as no-deadline — a wire
    field from an arbitrary client is tolerated like any unknown
    field, never a crash surface."""
    raw = header.get("budget_ms")
    if raw is None:
        raw = header.get("deadline_ms")
    if (not isinstance(raw, (int, float)) or isinstance(raw, bool)
            or raw < 0):
        return None
    if now is None:
        now = time.monotonic()
    return now + raw / 1000.0


def budget_ms_remaining(deadline_at, now=None) -> float:
    """Milliseconds left until a local monotonic deadline, clamped at
    0 — the one subtraction every layer's expiry check shares. Only
    ever called with a deadline THIS process derived from a received
    budget, so no cross-process clock comparison can occur."""
    if now is None:
        now = time.monotonic()
    return max(0.0, (deadline_at - now) * 1000.0)


def stamp_budget(header, deadline_at, now=None) -> dict:
    """A copy of ``header`` with ``budget_ms`` recomputed from a local
    monotonic deadline — the per-hop re-stamp a forwarder (client
    retry, router forward/hedge) applies so the downstream process
    sees the budget net of time already spent here. ``deadline_at``
    None returns the header unchanged (no deadline, nothing to
    stamp)."""
    if deadline_at is None:
        return header
    out = dict(header)
    out["budget_ms"] = round(budget_ms_remaining(deadline_at, now), 3)
    return out


# ------------------------------------------------------------------ #
# shm lane plumbing                                                  #
# ------------------------------------------------------------------ #

SHM_DIR = "/dev/shm"
DEFAULT_SHM_MIN_BYTES = 1 << 16

# creator pid is IN the name: leak-on-crash cleanup needs nothing but
# a directory listing and a kill -0 (sweep_stale_segments)
_SHM_NAME_RE = re.compile(r"^tpkserve-(\d+)-\d+-[0-9a-f]+$")
_SHM_SEQ = itertools.count()
_SHM_PROBE: list = []  # memoized shm_available() verdict


class ProtocolError(Exception):
    """The stream is not speaking this protocol (bad magic, absurd
    lengths, truncated frame, unknown dtype, torn shm segment).
    Callers must treat the connection as poisoned — there is no
    resync."""


def _view(p) -> memoryview:
    """A flat byte view of one payload buffer — no copy for bytes /
    bytearray / C-contiguous arrays, which is every payload the
    serving stack produces (``pack_arrays`` canonicalizes)."""
    m = p if isinstance(p, memoryview) else memoryview(p)
    if m.format != "B" or m.ndim != 1:
        m = m.cast("B")
    return m


def shm_min_bytes() -> int:
    """``TPKT_SERVE_SHM_MIN_BYTES`` (default 64 KiB), fail-loud parse:
    below it, one inline syscall beats creating + mapping a segment."""
    raw = os.environ.get("TPKT_SERVE_SHM_MIN_BYTES")
    if raw is None or not raw.strip():
        return DEFAULT_SHM_MIN_BYTES
    try:
        val = int(raw)
    except ValueError:
        val = -1
    if val < 0:
        raise ValueError(
            f"TPKT_SERVE_SHM_MIN_BYTES={raw!r}: expected an int >= 0"
        )
    return val


def shm_available() -> bool:
    """Can this process create and map ``/dev/shm`` segments? Probed
    once (create + map + unlink of a page) and memoized — the
    negotiation predicate, not a knob."""
    if not _SHM_PROBE:
        try:
            seg = ShmSegment(8)
            try:
                seg.write(b"\0" * 8)
                mm = open_shm(seg.name, 8)
                mm.close()
            finally:
                seg.close()
                seg.unlink()
            _SHM_PROBE.append(True)
        except (OSError, ProtocolError, ValueError):
            _SHM_PROBE.append(False)
    return _SHM_PROBE[0]


def shm_enabled() -> bool:
    """The shm lane's routing predicate: ``TPKT_SERVE_SHM`` not
    switched off (``0``/``off``/``none``/``false``) AND the host can
    actually map (:func:`shm_available`)."""
    raw = os.environ.get("TPKT_SERVE_SHM")
    if raw is not None and raw.strip().lower() in (
            "0", "off", "none", "false"):
        return False
    return shm_available()


class ShmSegment:
    """One creator-owned shared-memory segment: a raw ``/dev/shm``
    file sized exactly ``nbytes``, mapped read-write by its creator.
    The creator writes payload bytes in (:meth:`write`), ships only
    ``{"name", "nbytes"}`` over the wire, and — per the lifecycle
    contract in the module docstring — whoever the contract names
    unlinks it; :meth:`unlink` after the fact is idempotent."""

    __slots__ = ("name", "nbytes", "_mm")

    def __init__(self, nbytes: int):
        if nbytes <= 0 or nbytes > MAX_PAYLOAD:
            raise ValueError(f"bad shm segment size {nbytes}")
        self.nbytes = nbytes
        fd = None
        for _attempt in range(4):
            name = (f"tpkserve-{os.getpid()}-{next(_SHM_SEQ)}-"
                    f"{os.urandom(4).hex()}")
            try:
                fd = os.open(os.path.join(SHM_DIR, name),
                             os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
                break
            except FileExistsError:
                continue
        if fd is None:
            raise OSError(f"cannot create an shm segment under {SHM_DIR}")
        try:
            # fallocate, not ftruncate: tmpfs truncation is sparse, so
            # an exhausted /dev/shm would pass creation and SIGBUS the
            # first write — allocation must fail HERE as ENOSPC so the
            # caller's documented inline fallback can fire
            os.posix_fallocate(fd, 0, nbytes)
            self._mm = mmap.mmap(fd, nbytes)
        except BaseException:
            # never leak the file: the dead-pid sweep skips segments
            # whose creator (us) is alive
            with_err = os.path.join(SHM_DIR, name)
            try:
                os.unlink(with_err)
            except OSError:
                pass
            raise
        finally:
            os.close(fd)
        self.name = name

    def write(self, buf, offset: int = 0) -> int:
        """Copy ``buf`` into the segment at ``offset``; returns the
        byte count (the caller's ``serve.bytes_copied`` evidence —
        staging an already-materialized buffer is a counted copy)."""
        v = _view(buf)
        self._mm[offset:offset + v.nbytes] = v
        return v.nbytes

    def close(self):
        try:
            self._mm.close()
        except (BufferError, ValueError):
            pass  # live numpy exports keep the mapping until GC

    def unlink(self):
        try:
            os.unlink(os.path.join(SHM_DIR, self.name))
        except OSError:
            pass


def open_shm(name, nbytes):
    """Map one named segment read-only; returns the ``mmap`` (itself a
    valid payload buffer for :func:`unpack_arrays`). Any defect — a
    name outside the ``tpkserve-`` namespace, a missing file, a file
    shorter than the header claims — is a TORN segment: the stream
    that described it is desynced or hostile, so this raises
    :class:`ProtocolError` and the connection dies, never the
    daemon."""
    if not isinstance(name, str) or not _SHM_NAME_RE.match(name):
        raise ProtocolError(f"bad shm segment name {name!r}")
    if (not isinstance(nbytes, int) or isinstance(nbytes, bool)
            or nbytes <= 0 or nbytes > MAX_PAYLOAD):
        raise ProtocolError(f"bad shm segment size {nbytes!r}")
    try:
        fd = os.open(os.path.join(SHM_DIR, name), os.O_RDONLY)
    except OSError as e:
        raise ProtocolError(f"torn shm segment {name}: {e}") from None
    try:
        if os.fstat(fd).st_size < nbytes:
            raise ProtocolError(
                f"torn shm segment {name}: file is "
                f"{os.fstat(fd).st_size}B, header claims {nbytes}B"
            )
        try:
            return mmap.mmap(fd, nbytes, prot=mmap.PROT_READ)
        except (ValueError, OSError) as e:
            raise ProtocolError(
                f"torn shm segment {name}: {e}"
            ) from None
    finally:
        os.close(fd)


def unlink_shm(name) -> bool:
    """Unlink one segment by name (idempotent; bad names are ignored
    rather than trusted). The receiver-unlinks half of the response
    lifecycle, and the failed-send cleanup hook."""
    if not isinstance(name, str) or not _SHM_NAME_RE.match(name):
        return False
    try:
        os.unlink(os.path.join(SHM_DIR, name))
        return True
    except OSError:
        return False


def sweep_segments_for_pid(pid) -> tuple:
    """Targeted leak-on-crash cleanup: unlink every ``tpkserve-<pid>-*``
    segment of ONE dead creator, returning ``(count, bytes)`` so the
    caller's evidence (the fleet health manager's ``worker_dead``
    event) can carry the reclaimed byte count. The creator must
    actually be dead — a live (or recycled) pid is left alone; the
    generic start-time :func:`sweep_stale_segments` remains the
    backstop."""
    if not isinstance(pid, int) or pid <= 0:
        return 0, 0
    try:
        os.kill(pid, 0)
        return 0, 0             # alive (or recycled): not ours to sweep
    except ProcessLookupError:
        pass
    except OSError:
        return 0, 0             # EPERM: alive under another uid
    try:
        names = os.listdir(SHM_DIR)
    except OSError:
        return 0, 0
    removed, nbytes = 0, 0
    for name in names:
        m = _SHM_NAME_RE.match(name)
        if not m or int(m.group(1)) != pid:
            continue
        path = os.path.join(SHM_DIR, name)
        try:
            size = os.stat(path).st_size
            os.unlink(path)
        except OSError:
            continue
        removed += 1
        nbytes += size
    return removed, nbytes


def sweep_stale_segments() -> int:
    """Leak-on-crash cleanup: unlink every ``tpkserve-*`` segment
    whose creator pid is dead (the name carries it). Run at daemon /
    router start — a process that died between creating a segment and
    its peer unlinking it can leak at most until the next start."""
    try:
        names = os.listdir(SHM_DIR)
    except OSError:
        return 0
    removed = 0
    for name in names:
        m = _SHM_NAME_RE.match(name)
        if not m:
            continue
        try:
            os.kill(int(m.group(1)), 0)
            continue            # creator alive: its lifecycle, not ours
        except ProcessLookupError:
            pass
        except OSError:
            continue            # EPERM: alive under another uid
        try:
            os.unlink(os.path.join(SHM_DIR, name))
            removed += 1
        except OSError:
            pass
    return removed


def stage_shm_payloads(payloads, min_bytes=None):
    """Sender half of the shm lane: move every payload at or over the
    threshold into a fresh segment. Returns ``(descs, wire_payloads,
    segments, staged_bytes)`` — ``descs`` is the header's ``_shm``
    list (one slot per payload, null = still inline) or None when
    nothing crossed the threshold (the frame then has no shm marker
    at all and an old receiver parses it untouched);
    ``wire_payloads`` are the inline remainder in order; ``segments``
    must outlive the round trip and be closed/unlinked per the
    lifecycle contract; ``staged_bytes`` is the counted staging
    copy."""
    if min_bytes is None:
        min_bytes = shm_min_bytes()
    descs, wire, segs, staged = [], [], [], 0
    try:
        for p in payloads:
            v = _view(p)
            if v.nbytes >= max(1, min_bytes):
                seg = ShmSegment(v.nbytes)
                segs.append(seg)
                staged += seg.write(v)
                descs.append({"name": seg.name, "nbytes": v.nbytes})
            else:
                descs.append(None)
                wire.append(v)
    except (OSError, ValueError):
        # a failed creation mid-list (exhausted /dev/shm) must not
        # leak the segments already created — the caller falls back
        # to the inline lane
        for seg in segs:
            seg.close()
            seg.unlink()
        raise
    if not segs:
        return None, wire, [], 0
    return descs, wire, segs, staged


def check_shm_descs(header, n_payloads: int):
    """Structural validation of a frame's ``_shm`` against its arg
    specs and inline payload count WITHOUT opening anything — the
    fleet router's front-door check (docs/SERVING.md §fleet): a
    malformed descriptor must die there as a bad request, not ride
    upstream to poison worker connections and masquerade as
    transport loss. Raises :class:`ProtocolError`; a frame with no
    ``_shm`` passes untouched."""
    descs = header.get("_shm")
    if descs is None:
        return
    args = header.get("args") or []
    if not isinstance(descs, list) or len(descs) != len(args):
        raise ProtocolError(
            f"malformed _shm: expected {len(args)} slot(s), "
            f"got {descs!r}"
        )
    inline = 0
    for d in descs:
        if d is None:
            inline += 1
            continue
        if not (isinstance(d, dict)
                and isinstance(d.get("name"), str)
                and _SHM_NAME_RE.match(d["name"])
                and isinstance(d.get("nbytes"), int)
                and not isinstance(d.get("nbytes"), bool)
                and 0 < d["nbytes"] <= MAX_PAYLOAD):
            raise ProtocolError(f"malformed _shm slot {d!r}")
    if inline != n_payloads:
        raise ProtocolError(
            f"_shm leaves {inline} inline payload(s) but the frame "
            f"carries {n_payloads}"
        )


def resolve_shm_payloads(header, payloads):
    """Receiver half: splice mapped segments back into payload order.
    Pops ``_shm`` from ``header`` and returns ``(full_payloads,
    inline_bytes, maps)`` — ``maps`` are the read-only mmaps backing
    the spliced entries (kept alive by the numpy views
    :func:`unpack_arrays` builds over them; freed by refcount once
    the arrays die). A malformed ``_shm`` or a torn segment raises
    :class:`ProtocolError` — the poisoned-connection contract."""
    descs = header.pop("_shm", None)
    inline_bytes = sum(len(p) for p in payloads)
    if descs is None:
        return list(payloads), inline_bytes, []
    if not isinstance(descs, list):
        raise ProtocolError(f"malformed _shm {descs!r}")
    full, maps = [], []
    it = iter(payloads)
    try:
        for d in descs:
            if d is None:
                full.append(next(it))
                continue
            if not isinstance(d, dict):
                raise ProtocolError(f"malformed _shm slot {d!r}")
            mm = open_shm(d.get("name"), d.get("nbytes"))
            maps.append(mm)
            full.append(mm)
    except StopIteration:
        raise ProtocolError(
            "_shm names fewer inline payloads than the frame carries"
        ) from None
    if next(it, None) is not None:
        raise ProtocolError(
            "frame carries inline payloads _shm does not account for"
        )
    return full, inline_bytes, maps


# ------------------------------------------------------------------ #
# framing                                                            #
# ------------------------------------------------------------------ #

def _recv_exact(sock, n: int) -> bytes:
    """Read exactly ``n`` bytes or raise — a short read mid-frame is a
    peer that died, and half a frame is worse than none."""
    chunks = []
    while n:
        chunk = sock.recv(min(n, 1 << 20))
        if not chunk:
            raise ProtocolError(
                f"connection closed mid-frame ({n} byte(s) short)"
            )
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


def send_frame(sock, header, payloads=()) -> int:
    """Serialize one frame onto ``sock``. ``payloads`` is a sequence
    of buffer-likes (bytes, memoryviews, contiguous arrays) streamed
    as-is — no ``bytes()`` materialization on the send path; their
    lengths are recorded in the wire header (``_lens``) so
    :func:`recv_frame` can split the blob without trusting the
    semantic fields. Returns the inline payload bytes pushed through
    the socket — the send-side half of the ``serve.bytes_copied``
    accounting (an shm-lane frame returns 0: only names ride the
    wire)."""
    views = [_view(p) for p in payloads]
    wire = dict(header)
    wire["_lens"] = [v.nbytes for v in views]
    hb = json.dumps(wire, separators=(",", ":")).encode()
    total = sum(v.nbytes for v in views)
    if len(hb) > MAX_HEADER or total > MAX_PAYLOAD:
        raise ProtocolError(
            f"frame too large (header {len(hb)}B, payload {total}B)"
        )
    head = _PREAMBLE.pack(MAGIC, len(hb), total) + hb
    if total <= SMALL_FRAME:
        # small frames: one syscall beats avoiding a tiny join
        sock.sendall(b"".join([head, *views]))
        return total
    # multi-MB operand/output frames: stream each buffer as-is — the
    # kernel socket copy is the only byte-touching left on this path
    sock.sendall(head)
    for v in views:
        sock.sendall(v)
    return total


def recv_frame(sock):
    """Read one frame; returns ``(header, [payload_view, ...])`` —
    payloads are zero-copy memoryview slices over the one received
    blob — or ``None`` on a clean EOF at a frame boundary (the peer
    hung up between requests — not an error)."""
    first = sock.recv(1)
    if not first:
        return None
    raw = first + _recv_exact(sock, _PREAMBLE.size - 1)
    magic, hlen, total = _PREAMBLE.unpack(raw)
    if magic != MAGIC:
        raise ProtocolError(f"bad magic {magic!r}")
    if hlen > MAX_HEADER or total > MAX_PAYLOAD:
        raise ProtocolError(
            f"absurd frame lengths (header {hlen}B, payload {total}B)"
        )
    try:
        header = json.loads(_recv_exact(sock, hlen))
    except ValueError as e:
        raise ProtocolError(f"unparseable frame header: {e}") from None
    if not isinstance(header, dict):
        raise ProtocolError("frame header is not a JSON object")
    lens = header.pop("_lens", [])
    if not isinstance(lens, list) or any(
        not isinstance(n, int) or isinstance(n, bool) or n < 0
        for n in lens
    ):
        raise ProtocolError(f"malformed _lens {lens!r}")
    if sum(lens) != total:
        raise ProtocolError(
            f"payload lengths {lens} disagree with frame total {total}"
        )
    blob = memoryview(_recv_exact(sock, total))
    payloads, off = [], 0
    for n in lens:
        payloads.append(blob[off:off + n])
        off += n
    return header, payloads


# ------------------------------------------------------------------ #
# array <-> (spec, buffer)                                           #
# ------------------------------------------------------------------ #

def pack_arrays(arrays):
    """``([{"shape", "dtype"}, ...], [buffer, ...])`` for a sequence
    of numpy arrays (0-d arrays carry host scalars — the dispatch
    memo's canonicalization contract). Payloads are memoryviews over
    the arrays themselves — zero-copy for C-contiguous operands,
    which is every array this stack produces (``ascontiguousarray``
    canonicalizes the rest)."""
    specs, payloads = [], []
    for a in arrays:
        a = np.asarray(a)
        name = a.dtype.name
        if name not in DTYPES:
            raise ProtocolError(
                f"unsupported dtype {name!r}; the wire carries "
                f"{sorted(DTYPES)}"
            )
        specs.append({"shape": list(a.shape), "dtype": name})
        payloads.append(_view(np.ascontiguousarray(a)))
    return specs, payloads


def unpack_arrays(specs, payloads):
    """Rebuild numpy arrays from specs + raw buffers (bytes,
    memoryviews, or read-only shm mmaps — all zero-copy views);
    validates byte counts so a desynced stream fails loudly, never
    reshapes garbage."""
    if len(specs) != len(payloads):
        raise ProtocolError(
            f"{len(specs)} array spec(s) but {len(payloads)} payload(s)"
        )
    out = []
    for spec, raw in zip(specs, payloads):
        name = spec.get("dtype")
        if name not in DTYPES:
            raise ProtocolError(f"unsupported dtype {name!r} in spec")
        dt = np.dtype(DTYPES[name])
        shape = tuple(int(d) for d in spec.get("shape", ()))
        want = dt.itemsize * int(np.prod(shape, dtype=np.int64))
        if len(raw) != want:
            raise ProtocolError(
                f"payload is {len(raw)}B but {shape} {name} needs {want}B"
            )
        out.append(np.frombuffer(raw, dtype=dt).reshape(shape))
    return out
