"""Client side of the serving daemon.

The port's copy of ``tpukernels/serve/client.py``.
``ServeClient.dispatch(kernel, *arrays, **statics)`` mirrors
``registry.dispatch`` over the wire: numpy operands in (host scalars as
0-d arrays), numpy results out, a single array or a tuple. The C entry
(``capi.py``, when ``TPKT_SERVE_SOCKET`` is set) and ``chip_smoke.py``
use it; it speaks the reference's wire, so it drives the reference's
daemon too.

No torch: a client needs numpy and a socket; the device lives in the
daemon.

Failures: :class:`ServeError` for a dispatch error the daemon reports,
:class:`ServeRejected` (with ``retry_after_s``) for admission control,
:class:`ServeExpired` for a spent deadline, and ``OSError`` /
``ProtocolError`` for transport trouble (the caller decides whether it
has another path; ``capi`` has one).
"""

from __future__ import annotations

import os
import socket
import time

import numpy as np

from tpukernels_torch import _cachedir
from tpukernels_torch.obs import metrics as obs_metrics
from tpukernels_torch.serve import protocol

# transport failures a RESPAWNED daemon explains: the old connection
# died with the old process (reset / broken pipe / mid-frame EOF) but
# the socket path is live again — dispatch_with_backpressure retries
# these ONCE through a fresh connection (docs/SERVING.md
# §self-healing). A refused reconnect (daemon actually down)
# propagates as the hard error it is.
_RECONNECTABLE = (ConnectionResetError, BrokenPipeError,
                  protocol.ProtocolError)

# the ROUTER-crash window (docs/SERVING.md §guardian): between a
# router SIGKILL and its guardian-supervised respawn, connects are
# REFUSED (the socket file outlives the process) or the path briefly
# vanishes (the respawn re-binds). dispatch_with_backpressure absorbs
# this whole window — refused connects AND repeated resets — under the
# TPKT_CLIENT_RECONNECT_S budget, with the same request_id throughout.
_REFUSED = (ConnectionRefusedError, FileNotFoundError)
_ABSORBABLE = _RECONNECTABLE + _REFUSED

# seconds between reconnect attempts inside the budget window (scaled
# 0.5x-1.5x by the caller's seeded jitter, same decorrelation story
# as the rejection retries)
_RECONNECT_STEP_S = 0.25


def _reconnect_budget_s() -> float:
    """``TPKT_CLIENT_RECONNECT_S``: how long a client
    keeps re-trying a dead front socket before the transport error
    surfaces. 0 disables the window (only the single stale-connection
    retry remains). Fail-loud parse, like every knob."""
    raw = os.environ.get("TPKT_CLIENT_RECONNECT_S")
    if raw is None or not raw.strip():
        return 5.0
    try:
        val = float(raw)
    except ValueError:
        val = -1.0
    if val < 0.0:
        raise ValueError(
            f"TPKT_CLIENT_RECONNECT_S={raw!r}: expected a number >= 0"
        )
    return val


class ServeError(Exception):
    """The daemon answered, and the answer is a dispatch failure."""


class ServeRejected(ServeError):
    """Admission control turned the request away; ``retry_after_s``
    is the daemon's load-derived retry hint."""

    def __init__(self, msg, retry_after_s=0.1):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class ServeExpired(ServeError):
    """The request's deadline ran out before the fleet could (or
    would) serve it — the router refused an infeasible budget
    (``serve_deadline_infeasible``) or a layer expired it in flight
    (``serve_request_expired``). Deliberately NOT a
    :class:`ServeRejected`: retrying the same ever-shrinking budget
    is doomed, so backpressure retries must not absorb it —
    ``retry_after_s`` is the honest hint for a FRESH deadline."""

    def __init__(self, msg, retry_after_s=0.0):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


def default_socket_path() -> str:
    """``TPKT_SERVE_SOCKET`` when set (also the capi routing switch),
    else the serve dir's ``serve.sock`` (``tpukernels/_cachedir.py``)."""
    return _cachedir.serve_socket_path()


def default_deadline_ms():
    """``TPKT_DEADLINE_DEFAULT_MS`` (docs/SERVING.md §deadlines): the
    deadline stamped on every dispatch when neither the client nor
    the caller set one. Unset/0 = off — requests carry no deadline
    and every layer's expiry check stays a single ``is None`` test,
    the fault-plan hot-path discipline. Fail-loud parse, >= 0."""
    raw = os.environ.get("TPKT_DEADLINE_DEFAULT_MS")
    if raw is None or not raw.strip():
        return None
    try:
        val = float(raw)
    except ValueError:
        val = -1.0
    if val < 0.0:
        raise ValueError(
            f"TPKT_DEADLINE_DEFAULT_MS={raw!r}: expected a number >= 0"
        )
    return val or None


def dispatch_with_backpressure(cli, kernel, args, statics,
                               max_rejections: int = 10,
                               jitter=None):
    """``cli.dispatch`` honoring admission control: a
    :class:`ServeRejected` is retried after the daemon's
    ``retry_after_s`` hint, up to ``max_rejections`` times, then
    re-raised — the one backpressure policy both standing clients
    (``capi._dispatch``, ``loadgen.run_serve``) share; only the
    give-up action differs, so it stays with the caller. Transport
    errors and daemon-reported :class:`ServeError` propagate
    untouched.

    ``jitter`` (a ``random.Random``, deterministically seeded by the
    caller) decorrelates the retries: the raw hint is scaled by a
    uniform 0.5x-1.5x draw per retry, so a burst of clients rejected
    together does not sleep the same hint and re-stampede a
    recovering daemon in lockstep (the thundering-herd fix — seeded,
    so a loadgen run's schedule stays byte-reproducible). ``None``
    keeps the raw hint.

    One stale-connection transport failure is also absorbed: a
    client that held a connection to a daemon which was since
    RESTARTED on the same socket (the health manager's respawn, a
    rolling restart) sees ECONNRESET/EPIPE/mid-frame EOF on its next
    dispatch — that is retried exactly once through a fresh
    connection, with the SAME request_id (it is still one
    logical request). Kernels are pure,
    so the replay is safe even if the old daemon executed before
    dying.

    Beyond that single free retry, a ``TPKT_CLIENT_RECONNECT_S``
    budget (default 5 s) absorbs the ROUTER-crash window: refused
    connects and repeated resets are re-tried on a short seeded-jitter
    cadence — same request_id every attempt, so the respawned
    router's WAL-replay stash recognizes the retry — until the budget
    runs out, at which point the transport error surfaces as the hard
    failure it is (no silent hang). ``TPKT_CLIENT_RECONNECT_S=0``
    disables the window."""
    # one LOGICAL request, one causal id: backpressure retries of the
    # same request must not mint fresh request_ids, or the timeline
    # assembler would see N unrelated one-hop requests instead of one
    # request that waited out admission control
    rid = getattr(cli, "next_request_id", None)
    if rid is None:
        mint = getattr(cli, "mint_request_id", None)
        if mint is not None:
            rid = cli.next_request_id = mint()
    tries = 0
    reconnected = False
    deadline = None  # first transport failure starts the budget clock

    def _re_arm():
        # one logical request, one id AND one deadline: a retry must
        # not restart the budget clock any more than it may mint a
        # fresh request_id — the remaining budget keeps shrinking
        # across admission/reconnect retries (docs/SERVING.md
        # §deadlines)
        if rid is not None:
            cli.next_request_id = rid
        dl_at = getattr(cli, "last_deadline_at", None)
        if dl_at is not None:
            cli.next_deadline_at = dl_at

    while True:
        try:
            return cli.dispatch(kernel, *args, **statics)
        except ServeRejected as e:
            tries += 1
            if tries >= max_rejections:
                raise
            wait = e.retry_after_s
            if jitter is not None:
                wait *= 0.5 + jitter.random()
            time.sleep(wait)
            _re_arm()
        except _ABSORBABLE as e:
            # dispatch() already closed the poisoned socket; the next
            # call reconnects on the same path
            now = time.monotonic()
            if deadline is None:
                deadline = now + _reconnect_budget_s()
            if isinstance(e, _RECONNECTABLE) and not reconnected:
                # the stale-connection case: one immediate free retry
                # (the respawned-daemon story above)
                reconnected = True
            else:
                # the router-crash window: pace the reconnects until
                # the budget is spent, then surface the hard error
                if now >= deadline:
                    raise
                step = _RECONNECT_STEP_S
                if jitter is not None:
                    step *= 0.5 + jitter.random()
                time.sleep(min(step, max(0.0, deadline - now)))
            _re_arm()


class ServeClient:
    """One connection, one outstanding request at a time (the
    protocol's pipelining contract). Connects lazily and reconnects
    after transport errors; not thread-safe — give each client thread
    its own instance.

    Payload lanes (docs/SERVING.md §wire format): the first dispatch
    on a connection negotiates via a ping — a server advertising
    ``shm`` in its ``lanes`` gets operands at or over
    ``TPKT_SERVE_SHM_MIN_BYTES`` written straight into ``/dev/shm``
    segments (unlinked once the response arrives) and may answer the
    same way (this client maps, copies out, and unlinks immediately
    — the receiver-unlinks contract). Everything else — old servers,
    hosts without ``/dev/shm``, ``TPKT_SERVE_SHM=0`` — stays on the
    inline lane unchanged. ``inline_payloads``/``staged_payloads``/
    ``bytes_copied`` expose this side's lane traffic (mirrored into
    ``serve.bytes_copied.<kernel>``) so loadgen can stamp the
    copy-budget evidence."""

    def __init__(self, socket_path=None, timeout_s=None,
                 tenant=None, priority=None, deadline_ms=None):
        # tenant/priority ride every dispatch header: the fleet
        # router's admission point (per-tenant token buckets,
        # priority classes — docs/SERVING.md §fleet) reads them; the
        # single daemon carries tenant through to its journal
        # evidence and ignores priority
        self.socket_path = socket_path or default_socket_path()
        self.timeout_s = timeout_s
        self.tenant = tenant
        self.priority = priority
        self._sock = None
        self._rid = 0
        self._lanes = None      # negotiated at ping time; None=unknown
        self.inline_payloads = 0
        self.staged_payloads = 0
        self.bytes_copied = 0
        # request tracing (docs/OBSERVABILITY.md §request tracing):
        # every dispatch header carries a CLIENT-MINTED request_id —
        # set next_request_id to choose it (loadgen seeds them
        # deterministically), else one is minted per dispatch. Old
        # servers ignore the field (the shm-lane negotiation pattern:
        # request_trace in the pong says the server tags its journal).
        self.next_request_id = None
        self.last_request_id = None
        self.request_trace = None   # from the pong; None = unknown
        self._trace_seq = 0
        # deadlines (docs/SERVING.md §deadlines): per-client default
        # total budget in ms (falls back to TPKT_DEADLINE_DEFAULT_MS;
        # None/0 = no deadline). next_deadline_ms overrides ONE
        # dispatch; next_deadline_at (a local monotonic absolute)
        # CONTINUES an in-flight logical request's budget across
        # retries instead of restarting it — last_deadline_at is what
        # dispatch_with_backpressure restores from.
        self.deadline_ms = deadline_ms
        self.next_deadline_ms = None
        self.next_deadline_at = None
        self.last_deadline_at = None

    # ---------------------------------------------------------- #
    # transport                                                  #
    # ---------------------------------------------------------- #

    def _connected(self):
        if self._sock is None:
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            if self.timeout_s is not None:
                s.settimeout(self.timeout_s)
            try:
                s.connect(self.socket_path)
            except OSError:
                s.close()
                raise
            self._sock = s
        return self._sock

    def close(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
        # a reconnect may land on a restarted (or different) server:
        # renegotiate lanes rather than trust a stale advertisement
        self._lanes = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def _roundtrip(self, header, payloads=()):
        """One frame out, one frame back; returns ``(header, payloads,
        sent_inline_bytes)`` — the send-side copy accounting rides
        along so :meth:`dispatch` can attribute it per kernel."""
        sock = self._connected()
        try:
            sent = protocol.send_frame(sock, header, payloads)
            frame = protocol.recv_frame(sock)
        except (OSError, protocol.ProtocolError):
            self.close()  # poisoned stream: next call reconnects
            raise
        if frame is None:
            self.close()
            raise protocol.ProtocolError(
                "daemon hung up before answering"
            )
        return frame[0], frame[1], sent

    # ---------------------------------------------------------- #
    # operations                                                 #
    # ---------------------------------------------------------- #

    def ping(self) -> dict:
        """Liveness + stats (pid, served/rejected/requeued counts,
        queue depth, device_kind, the daemon's framework version) —
        and the lane negotiation point: the pong's ``lanes`` (absent on old
        servers = inline only) decides whether later dispatches may
        use the shm lane."""
        header, _payloads, _sent = self._roundtrip(
            {"v": protocol.VERSION, "op": "ping"}
        )
        lanes = header.get("lanes")
        self._lanes = ([str(x) for x in lanes]
                       if isinstance(lanes, list) else ["inline"])
        self.request_trace = bool(header.get("request_trace"))
        return header

    def stats(self) -> dict:
        """The read-only live-telemetry op (docs/SERVING.md §stats
        op): the pong plus the live metrics snapshot, pad-pool state
        and — against a router — per-worker ``worker_stats`` and the
        summed ``fleet`` row. An old server answers ``ok: False``
        with an unknown-op error; callers treat that as 'no stats
        plane', not a dead daemon."""
        header, _payloads, _sent = self._roundtrip(
            {"v": protocol.VERSION, "op": "stats"}
        )
        return header

    def undrain(self) -> dict:
        """A standalone daemon's table pickup: it re-reads
        ``TPKT_SERVE_BUCKETS`` (a promoted ``buckets.json`` behind an
        unchanged env value) and answers ``reloaded`` with the table's
        kernels, or ``ok: False`` with the old table still in effect."""
        header, _payloads, _sent = self._roundtrip(
            {"v": protocol.VERSION, "op": "undrain"}
        )
        return header

    def mint_request_id(self) -> str:
        """One fresh causal request id (pid-scoped, monotonic): the
        default when the caller never set ``next_request_id``."""
        self._trace_seq += 1
        return f"c{os.getpid():x}-{self._trace_seq}"

    def dispatch(self, kernel: str, *args, **statics):
        """One kernel request: numpy operands (host scalars as 0-d
        arrays — pass ``np.float32(x)``/``np.int32(n)``), numpy
        result(s) back, already sliced to the request's native shapes
        when the daemon bucketed it."""
        arrays = [np.asarray(a) for a in args]
        specs, payloads = protocol.pack_arrays(arrays)
        use_shm = False
        if protocol.shm_enabled():
            if self._lanes is None:
                self.ping()  # negotiate once per connection
            use_shm = "shm" in (self._lanes or ())
        self._rid += 1
        rid_trace = self.next_request_id
        self.next_request_id = None
        if rid_trace is None:
            rid_trace = self.mint_request_id()
        self.last_request_id = str(rid_trace)
        req = {"v": protocol.VERSION, "op": "dispatch",
               "id": self._rid, "kernel": kernel, "statics": statics,
               "request_id": self.last_request_id,
               "args": specs}
        if self.tenant is not None:
            req["tenant"] = self.tenant
        if self.priority is not None:
            req["priority"] = self.priority
        # deadline stamping: the total budget (deadline_ms) plus the
        # monotonic-safe remaining budget at THIS send (budget_ms,
        # recomputed per hop — docs/SERVING.md §deadlines). A retry of
        # the same logical request arrives with next_deadline_at set
        # and keeps the original clock.
        dl_ms = self.next_deadline_ms
        self.next_deadline_ms = None
        if dl_ms is None:
            dl_ms = self.deadline_ms
            if dl_ms is None:
                dl_ms = default_deadline_ms()
        dl_at = self.next_deadline_at
        self.next_deadline_at = None
        if dl_ms:
            if dl_at is None:
                dl_at = time.monotonic() + dl_ms / 1000.0
            req["deadline_ms"] = dl_ms
            req = protocol.stamp_budget(req, dl_at)
        else:
            dl_at = None
        self.last_deadline_at = dl_at
        segs: list = []
        if use_shm:
            req["shm_ok"] = True  # the server may answer via shm too
            try:
                descs, wire, segs, _staged = (
                    protocol.stage_shm_payloads(payloads)
                )
            except OSError:
                descs = None  # exhausted /dev/shm: inline still works
            if descs is not None:
                req["_shm"] = descs
                payloads = wire
        try:
            header, out_payloads, sent = self._roundtrip(req, payloads)
        finally:
            # request-segment lifecycle: the creator unlinks once the
            # round trip is over (the worker mapped them, or never
            # will) — crash windows are covered by the daemon's
            # dead-creator sweep
            for seg in segs:
                seg.close()
                seg.unlink()
        self._count(kernel, sent,
                    inline=len(payloads), staged=len(segs))
        if not header.get("ok"):
            msg = header.get("error") or "daemon error"
            if header.get("kind") == "overloaded":
                raise ServeRejected(
                    msg, float(header.get("retry_after_s") or 0.1)
                )
            if header.get("kind") in ("expired", "deadline_infeasible"):
                raise ServeExpired(
                    msg, float(header.get("retry_after_s") or 0.0)
                )
            raise ServeError(msg)
        resp_descs = [d for d in (header.get("_shm") or ()) if d]
        out_payloads, resp_inline, maps = (
            protocol.resolve_shm_payloads(header, out_payloads)
        )
        self._count(kernel, resp_inline)
        outs = protocol.unpack_arrays(
            header.get("outputs") or [], out_payloads
        )
        if maps:
            # receiver-unlinks contract: copy the results out of the
            # server's response segments, then free + unlink them NOW
            # (the returned arrays must not pin shared memory)
            outs = [np.array(o) for o in outs]
            del out_payloads
            for mm in maps:
                try:
                    mm.close()
                except BufferError:
                    pass
            for d in resp_descs:
                protocol.unlink_shm(d.get("name"))
        return outs[0] if len(outs) == 1 else tuple(outs)

    def _count(self, kernel: str, nbytes: int, inline: int = 0,
               staged: int = 0):
        """Client-side half of the copy accounting: inline payload
        bytes through the socket, mirrored into the same
        ``serve.bytes_copied.<kernel>`` counter the daemon keeps —
        every layer's number is its own socket traffic."""
        self.inline_payloads += inline
        self.staged_payloads += staged
        if nbytes:
            self.bytes_copied += nbytes
            obs_metrics.inc(f"serve.bytes_copied.{kernel}", nbytes)
