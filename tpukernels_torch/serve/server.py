"""The serving daemon of the port: ``python -m tpukernels_torch.serve``.

The port's counterpart of ``tpukernels/serve/server.py``. A long-lived
process on a Unix-domain socket takes dispatch requests (kernel, shapes,
dtypes, statics, raw operand bytes; ``serve/protocol.py``, the
reference's wire unchanged) from any number of clients and runs each
through the port's ``registry.dispatch`` on the card: the fault point,
the kernel's wrapper and the output-integrity guard the other entry
points trust. After the first request of a (kernel, bucket), a request
builds nothing and plans nothing.

Everything above the dispatch is the reference's logic:

- **Shape bucketing** (``bucketing.py``): operands are zero-padded up to
  the avatar of record (pad up only, capped, per-kernel rules), so the
  clients' shapes fold onto a few warm configurations;
  ``serve.bucket_pad_frac`` observes the waste.
- **Continuous batching**: requests of one bucket are coalesced onto one
  worker and served back to back (``serve.batch_size``). The window is
  adaptive (``TPKT_SERVE_BATCH_ADAPT``, on by default): 0 when the queue
  is empty, widening toward ``TPKT_SERVE_BATCH_WINDOW_MS`` under a
  burst, from the admission path's inter-arrival average
  (``serve.batch_window_ms``).
- **The shm lane**: payloads at or over ``TPKT_SERVE_SHM_MIN_BYTES``
  ride ``/dev/shm`` segments (negotiated at ping time), responses are
  written once into segments of their own, and the pad staging buffers
  are reused per bucket; ``serve.bytes_copied.<kernel>`` counts every
  byte copied beyond the one move from producer to consumer.
- **Admission control**: the queue is bounded (``TPKT_SERVE_QUEUE_MAX``);
  at depth a request is rejected at once with a ``retry_after_s`` hint
  (``serve_rejected``).
- **Deadlines**: a client's budget rides every hop (``budget_ms``); work
  whose budget is spent is expired at the worker instead of dispatched
  (``serve_request_expired``), the batching window never passes half the
  tightest budget in the batch, and the ``cancel`` op drops a queued
  request or suppresses an in-flight one's answer (``serve_cancelled``).
- **Worker watchdog**: a request in flight past
  ``TPKT_SERVE_REQUEST_TIMEOUT_S`` × 1.5 is classified slow or wedged
  (``watchdog.classify_timeout`` over a liveness probe); a slow one gets
  its grace doubled once, a wedged worker is abandoned and replaced, and
  its request is requeued once (``serve_request_requeued``) before it
  fails loudly.
- **Replay memo** (the port's own): a successful answer of a request that
  carries a request_id is kept (``REPLAY_MEMO_*``: small answers, for a
  while), and a replay of that request_id (``replay`` > 0, from a fleet
  router's write-ahead log after the router died) is answered from it
  instead of run again (``serve_request_deduped``), so a request that
  the dead router had already forwarded is delivered once.

What touches the device is the port's own. The daemon serves on the
card (``TPKT_SERVE_DEVICE`` unset; with no card it refuses to start) or,
with ``TPKT_SERVE_DEVICE=cpu``, on the CPU with the plain versions, as
the tests run it; nothing falls back from the card to the CPU. A worker
uploads the operands with ``torch.from_numpy(...).to(device)`` (host
scalars go as Python numbers), dispatches, and brings the outputs back
with ``.cpu().numpy()``, all inside its ``serve/<kernel>`` span. The
operands are read-only numpy views of the socket's bytes or of an shm
mapping: uploading to the card reads them once (no extra copy); on the
CPU, where a tensor would alias them, they are copied first and the
copy is counted in ``bytes_copied``. Both workers launch on the
device's default stream, so device work is ordered and only host work
overlaps. The liveness probe runs a one-element add on a stream of its
own and polls its event, so a slow kernel on the default stream reads
as slow, not wedged.

Observability: a ``serve/<kernel>`` span a request (and
``serve/wait/queue``, ``serve/wait/lock``, ``serve/pad``), the
``serve.*`` counters and histograms, and the ``serve_start``,
``serve_request``, ``serve_rejected``, ``serve_request_requeued``,
``serve_request_expired``, ``serve_cancelled``,
``serve_request_deduped`` and ``serve_stop`` journal kinds. The worker
binds the client's ``request_id`` as its trace context
(``trace.request_ctx``), so every span of a request carries it. The daemon prints nothing to stdout; notes go to stderr.

Run it: ``python -m tpukernels_torch.serve [--socket PATH] [--queue-max
N] [--workers N] [--batch-window-ms MS] [--request-timeout-s S]``. The
integrity guard defaults to ``tripwire`` (an explicit ``TPKT_INTEGRITY``
wins), the journal to a dated file in the serve directory, and
``TPKT_METRICS_FLUSH_S`` starts the metrics flusher. SIGTERM/SIGINT stop
it cleanly: the listener closes, the socket and the flocked pidfile are
removed, and ``serve_stop`` records the totals.
"""

from __future__ import annotations

import collections
import os
import queue as _queue_mod
import socket
import struct
import sys
import threading
import time
import warnings

import numpy as np
import torch

from tpukernels_torch import _cachedir
from tpukernels_torch.kernels import LAUNCHES
from tpukernels_torch.obs import metrics as obs_metrics
from tpukernels_torch.obs import trace
from tpukernels_torch.resilience import faults, journal, watchdog
from tpukernels_torch.serve import bucketing, protocol
from tpukernels_torch.serve.proc import (
    DEFAULT_REQUEST_TIMEOUT_S,
    float_knob,
    hold_pidfile,
    int_knob,
    on_knob,
)
from tpukernels_torch.tuning import cache as tcache
from tpukernels_torch.utils import pick_device

DEFAULT_QUEUE_MAX = 64
DEFAULT_WORKERS = 2
DEFAULT_BATCH_WINDOW_MS = 2.0

# adaptive batching aims to gather about this many same-bucket
# requests per window under burst: the window widens to ~7 projected
# inter-arrival gaps (capped by TPKT_SERVE_BATCH_WINDOW_MS) and
# collapses to 0 the moment the queue is empty, so an idle request
# never pays the window (docs/SERVING.md §continuous batching)
BATCH_TARGET = 8

# response shm segments the client should have mapped-and-unlinked
# long ago (its own socket timeout bounds the wait) are reclaimed by
# the watchdog after this grace — the leak-on-crash backstop for a
# client that died between our send and its map
SHM_RESPONSE_GRACE_S = 120.0

# the replay memo (``Server._memo_put``): answers kept by request_id so
# that a replay of a request this daemon already ran is answered, not
# run again. A fleet router that dies between its forward and the
# answer's relay replays the request from its write-ahead log; only
# requests up to the log's inline cap are replayed, so only answers
# this small are kept, for as long as the router's own stash keeps a
# replayed result unclaimed
REPLAY_MEMO_MAX_B = 1 << 20       # one answer's payload bytes
REPLAY_MEMO_TOTAL_B = 64 << 20    # all answers kept
REPLAY_MEMO_TTL_S = 8 * DEFAULT_REQUEST_TIMEOUT_S + 30

# kernel-level SO_SNDTIMEO on accepted sockets: a client that stops
# READING (SIGSTOP'd, hung) would otherwise block a worker forever in
# sendall once the response outgrows the socket buffer — invisibly to
# the watchdog, which tracks dispatch, not delivery. Send-only, so an
# idle client's connection (blocked in recv on our side) lives forever.
SEND_TIMEOUT_S = 30.0


class _Request:
    """One in-flight dispatch request and its lifecycle state."""

    __slots__ = ("serial", "rid", "kernel", "statics", "arrays",
                 "spec", "pad_frac", "bucket", "conn", "t_enq",
                 "t_start", "requeues", "patience", "done", "lock",
                 "worker_ident", "tenant", "shm_ok", "request_id",
                 "shapes", "dtypes", "replayed", "deadline_at")

    def __init__(self, serial, rid, kernel, statics, arrays, spec,
                 pad_frac, bucket, conn, tenant=None, shm_ok=False,
                 request_id=None, replayed=None, deadline_at=None):
        self.serial = serial  # server-side key: client ids can collide
        self.rid = rid
        # the client-minted causal id (docs/OBSERVABILITY.md §request
        # tracing); None for pre-tracing clients. The requested (pre-
        # pad) shapes/dtypes ride to the serve_request shape-mix
        # record — the input of the reference's bucket-table optimizer
        # (``serve/adapt.py``).
        self.request_id = request_id
        self.shapes = [list(a.shape) for a in arrays]
        self.dtypes = [a.dtype.name for a in arrays]
        self.kernel = kernel
        self.statics = statics
        self.arrays = arrays
        self.spec = spec
        self.pad_frac = pad_frac
        self.bucket = bucket
        self.conn = conn
        self.tenant = tenant
        # the router's replay-idempotency count (protocol.py): >0
        # means a dead sibling may already have executed this request
        # — safe (kernels are pure), recorded on the serve_request
        # evidence so postmortems see the delivery history
        self.replayed = replayed
        # this process's monotonic instant the client's budget runs
        # out (protocol.deadline_from_header) — no absolute client
        # time ever crosses the wire, so clock skew cannot expire (or
        # resurrect) a request; None means no deadline
        self.deadline_at = deadline_at
        self.shm_ok = shm_ok       # client negotiated the shm lane
        self.t_enq = time.perf_counter()
        self.t_start = None
        self.requeues = 0
        self.patience = 0          # grace extensions granted (max 1)
        self.done = False          # guarded by self.lock
        self.lock = threading.Lock()
        self.worker_ident = None

    def claim_done(self) -> bool:
        """Atomically claim the right to respond — the one guard that
        makes a watchdog-requeued request and its abandoned original
        worker unable to both answer the client."""
        with self.lock:
            if self.done:
                return False
            self.done = True
            return True


class _Conn:
    """A client connection plus its send lock: worker threads answer
    requests while the reader thread may be rejecting the client's
    next one — frames must never interleave on the wire."""

    __slots__ = ("sock", "send_lock", "lane_logged")

    def __init__(self, sock):
        self.sock = sock
        self.send_lock = threading.Lock()
        self.lane_logged = False   # serve_lane_negotiated once per conn

    def send(self, header, payloads=()) -> int:
        """Returns the inline payload bytes pushed through the socket
        (``send_frame``'s copy accounting)."""
        with self.send_lock:
            return protocol.send_frame(self.sock, header, payloads)


class _BoundedQueue:
    """Bounded FIFO with same-bucket extraction — the admission-control
    and coalescing surface. ``queue.Full`` at depth is the
    backpressure contract; ``take_matching`` pulls every queued
    request of one bucket WITHOUT disturbing the order of the rest."""

    def __init__(self, maxlen: int):
        self._d = collections.deque()
        self._cv = threading.Condition()
        self._max = maxlen

    def put_nowait(self, item, force: bool = False):
        with self._cv:
            if not force and len(self._d) >= self._max:
                raise _queue_mod.Full
            self._d.append(item)
            self._cv.notify()

    def get(self, timeout: float):
        with self._cv:
            if not self._d:
                self._cv.wait(timeout)
            if not self._d:
                return None
            return self._d.popleft()

    def take_matching(self, bucket: str, limit: int):
        with self._cv:
            taken, keep = [], collections.deque()
            for item in self._d:
                if item.bucket == bucket and len(taken) < limit:
                    taken.append(item)
                else:
                    keep.append(item)
            self._d = keep
            return taken

    def remove_request(self, request_id: str):
        """Pull ONE queued entry by its client-minted request_id — the
        pre-dispatch half of the best-effort ``cancel`` op. Returns
        the removed request or None (already dispatched / unknown)."""
        with self._cv:
            for item in self._d:
                if item.request_id == request_id:
                    self._d.remove(item)
                    return item
            return None

    def depth(self) -> int:
        with self._cv:
            return len(self._d)


def serve_device(requested=None) -> torch.device:
    """The device the daemon serves on: ``requested``, else
    ``TPKT_SERVE_DEVICE``, else the card (``pick_device``: raises when
    there is none). A CUDA device carries its index."""
    dev = pick_device(requested or os.environ.get("TPKT_SERVE_DEVICE")
                      or None)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Server:
    def __init__(self, socket_path=None, queue_max=None, workers=None,
                 batch_window_ms=None, request_timeout_s=None,
                 device=None):
        # the device first: with no card, a daemon that was not asked
        # for the CPU refuses to start
        self.device = serve_device(device)
        self._device_kind = tcache.device_kind(self.device)
        self._probe_stream = self._probe_buf = None
        if self.device.type == "cuda":
            # the operands of a request are read-only views (the socket's
            # bytes, an shm mapping); the upload only reads them
            warnings.filterwarnings(
                "ignore", message="The given NumPy array is not writable",
                category=UserWarning)
            self._probe_stream = torch.cuda.Stream(self.device)
            self._probe_buf = torch.zeros(1, device=self.device)
        self.socket_path = socket_path or _cachedir.serve_socket_path()
        self.queue_max = (queue_max if queue_max is not None
                          else int_knob("TPKT_SERVE_QUEUE_MAX",
                                         DEFAULT_QUEUE_MAX))
        self.workers = (workers if workers is not None
                        else int_knob("TPKT_SERVE_WORKERS",
                                       DEFAULT_WORKERS))
        self.batch_window_s = (
            batch_window_ms if batch_window_ms is not None
            else float_knob("TPKT_SERVE_BATCH_WINDOW_MS",
                             DEFAULT_BATCH_WINDOW_MS)
        ) / 1000.0
        self.request_timeout_s = (
            request_timeout_s if request_timeout_s is not None
            else float_knob("TPKT_SERVE_REQUEST_TIMEOUT_S",
                             DEFAULT_REQUEST_TIMEOUT_S, floor=0.1)
        )
        self._q = _BoundedQueue(self.queue_max)
        self._stop = threading.Event()
        self._listener = None
        self._lock = threading.Lock()       # shared mutable maps below
        self._inflight: dict = {}           # serial -> _Request (started)
        self._bucket_locks: dict = {}       # bucket -> [lock, holder]
        self._abandoned: set = set()        # wedged worker idents
        self._worker_pending: dict = {}     # ident -> deque of batch rest
        self._next_rid = 0
        self._served = 0
        self._rejected = 0
        self._requeued = 0
        self._expired = 0
        self._cancelled = 0
        self._t0 = time.time()
        self._service_ewma = 0.05           # retry-after hint basis
        # continuous batching: the admission path tracks an
        # inter-arrival EWMA (fast attack — one short gap IS a burst —
        # slow release) the coalescing window is derived from
        self.batch_adapt = on_knob("TPKT_SERVE_BATCH_ADAPT")
        self._arrival_ewma = None
        self._last_arrival = None
        self._last_window_ms = 0.0
        # zero-copy wire path: lane capability + copy accounting
        # (knobs validated here so a typo refuses to start the daemon,
        # the TPKT_SERVE_BUCKETS fail-fast rule)
        self._shm = protocol.shm_enabled()
        self._shm_min = protocol.shm_min_bytes()
        self._bytes_copied = 0
        self._shm_ledger: list = []         # (name, t) response segs
        self._pad_pool: dict = {}           # bucket -> {arg_i: buf}
        # request_id -> (t, kernel, bucket, specs, payloads, nbytes)
        self._memo: collections.OrderedDict = collections.OrderedDict()
        self._memo_bytes = 0
        self._deduped = 0
        # fail-fast: a misconfigured TPKT_SERVE_BUCKETS (typo'd path,
        # malformed JSON) must refuse to start the daemon, not surface
        # as a per-request "bad request" to every client — which capi
        # treats as authoritative and never falls back from
        bucketing.bucket_configs()

    # -------------------------------------------------------------- #
    # lifecycle                                                      #
    # -------------------------------------------------------------- #

    def serve_forever(self):
        d = os.path.dirname(self.socket_path)
        if d:
            os.makedirs(d, exist_ok=True)
        if os.path.exists(self.socket_path):
            # a dead daemon's stale socket; a LIVE one holds the
            # flocked pidfile and serve_ctl refuses to double-start
            os.unlink(self.socket_path)
        self._listener = socket.socket(socket.AF_UNIX,
                                       socket.SOCK_STREAM)
        self._listener.bind(self.socket_path)
        self._listener.listen(64)
        self._listener.settimeout(0.5)
        # leak-on-crash cleanup (docs/SERVING.md §shm lifecycle):
        # segments whose creator died before its peer unlinked them
        swept = protocol.sweep_stale_segments()
        journal.emit(
            "serve_start", socket=self.socket_path,
            queue_max=self.queue_max, workers=self.workers,
            batch_window_ms=round(self.batch_window_s * 1e3, 3),
            batch_adapt=self.batch_adapt,
            request_timeout_s=self.request_timeout_s,
            lanes=self._lanes(), shm_swept=swept,
        )
        for _ in range(self.workers):
            self._spawn_worker()
        threading.Thread(target=self._watchdog_loop, daemon=True,
                         name="serve-watchdog").start()
        try:
            while not self._stop.is_set():
                try:
                    conn, _addr = self._listener.accept()
                except socket.timeout:
                    continue
                except OSError:
                    break
                conn.setsockopt(
                    socket.SOL_SOCKET, socket.SO_SNDTIMEO,
                    struct.pack("ll", int(SEND_TIMEOUT_S), 0),
                )
                threading.Thread(
                    target=self._client_loop, args=(_Conn(conn),),
                    daemon=True, name="serve-client",
                ).start()
        finally:
            self.shutdown()

    def stop(self, *_sig):
        """Signal-handler-safe stop request."""
        self._stop.set()

    def shutdown(self):
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
            self._listener = None
            try:
                os.unlink(self.socket_path)
            except OSError:
                pass
            journal.emit(
                "serve_stop", served=self._served,
                rejected=self._rejected, requeued=self._requeued,
                uptime_s=round(time.time() - self._t0, 3),
            )

    def _spawn_worker(self):
        threading.Thread(target=self._worker_loop, daemon=True,
                         name="serve-worker").start()

    # -------------------------------------------------------------- #
    # client side: read, admit or reject                             #
    # -------------------------------------------------------------- #

    def _client_loop(self, conn: _Conn):
        try:
            while not self._stop.is_set():
                frame = protocol.recv_frame(conn.sock)
                if frame is None:
                    return
                header, payloads = frame
                op = header.get("op")
                if op == "ping":
                    conn.send(dict(self._stats(), v=protocol.VERSION,
                                   ok=True))
                elif op == "dispatch":
                    # shm resolution happens HERE, not in _admit: a
                    # torn segment is a desynced/hostile stream and
                    # must poison this CONNECTION (the ProtocolError
                    # contract), never become a per-request error
                    payloads, inline_bytes, shm_maps = (
                        protocol.resolve_shm_payloads(header, payloads)
                    )
                    if shm_maps and not conn.lane_logged:
                        conn.lane_logged = True
                        journal.emit("serve_lane_negotiated",
                                     lane="shm",
                                     kernel=header.get("kernel"),
                                     request=header.get("id"))
                    self._admit(conn, header, payloads,
                                inline_bytes=inline_bytes)
                elif op == "stats":
                    conn.send(self._stats_full())
                elif op == "cancel":
                    conn.send(self._cancel(header))
                elif op == "undrain":
                    conn.send(self._undrain())
                else:
                    conn.send({"v": protocol.VERSION,
                               "id": header.get("id"), "ok": False,
                               "kind": "error",
                               "error": f"unknown op {op!r}"})
        except (protocol.ProtocolError, OSError):
            pass  # poisoned/hung-up connection: drop it, serve on
        finally:
            try:
                conn.sock.close()
            except OSError:
                pass

    def _undrain(self) -> dict:
        """The standalone daemon's promoted-table pickup (the router
        forwards nothing here — its own ``undrain`` busts its own
        cache): re-read TPKT_SERVE_BUCKETS through ``bucketing.reload``
        and drop the avatar-shaped pad staging pool, whose buffers
        were sized for the OLD table's buckets. A malformed new table
        answers as an error and the old one stays in effect
        (docs/SERVING.md §adaptive buckets)."""
        try:
            table = bucketing.reload()
        except (OSError, ValueError) as e:
            return {"v": protocol.VERSION, "ok": False,
                    "kind": "error",
                    "error": f"undrain refused: TPKT_SERVE_BUCKETS "
                             f"reload failed: {e}"}
        with self._lock:
            self._pad_pool.clear()
        journal.emit(
            "serve_drain", worker=None, socket=self.socket_path,
            phase="undrain", inflight=len(self._inflight),
            kernels=sorted(table),
        )
        return {"v": protocol.VERSION, "ok": True,
                "reloaded": sorted(table)}

    def _stats(self) -> dict:
        with self._lock:
            inflight = len(self._inflight)
            # the bucket-lock table is exactly the set of buckets this
            # daemon has ever dispatched — the per-bucket ownership
            # answer a fleet status wants
            buckets = sorted(self._bucket_locks)
        return {
            "op": "pong", "pid": os.getpid(),
            "served": self._served, "rejected": self._rejected,
            "requeued": self._requeued, "expired": self._expired,
            "cancelled": self._cancelled, "deduped": self._deduped,
            "depth": self._q.depth(),
            "inflight": inflight, "buckets": buckets,
            "worker_id": os.environ.get("TPKT_SERVE_WORKER_ID"),
            "queue_max": self.queue_max, "workers": self.workers,
            # lane negotiation (docs/SERVING.md §wire format): a
            # client enables shm ONLY after seeing it advertised here,
            # so an old server (no "lanes" key) is spoken to inline
            "lanes": self._lanes(),
            "shm_min_bytes": self._shm_min if self._shm else None,
            # request-tracing advertisement (the lane-negotiation
            # pattern): this server tags its journal evidence with the
            # client-minted request_id; old servers lack the key and
            # simply ignore the header field
            "request_trace": True,
            # the zero-copy + continuous-batching evidence operators
            # read off `serve_ctl status` without opening the journal
            "bytes_copied": self._bytes_copied,
            "batch_window_ms": self._last_window_ms,
            "batch_adapt": self.batch_adapt,
            "uptime_s": round(time.time() - self._t0, 3),
            "device": str(self.device),
            "device_kind": self._device_kind,
            # where the reference reports jax's version; with CUDA's, the
            # versions a load client stamps its SLO verdicts with
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            # flusher liveness (docs/OBSERVABILITY.md §live telemetry):
            # None when TPKT_METRICS_FLUSH_S is off; a value growing
            # past the flush interval means the flusher thread died
            "last_snapshot_age_s": obs_metrics.last_flush_age_s(),
        }

    def _stats_full(self) -> dict:
        """The read-only ``stats`` op (docs/SERVING.md §stats op): the
        ping pong plus the live metrics snapshot, the per-bucket
        pad staging pool and the kernel launch counts. Touches ONLY
        ``self._lock`` and the metrics module lock — never a per-bucket
        dispatch lock, so a stats call against a daemon wedged in a
        dispatch still answers."""
        with self._lock:
            pad_pool = {
                b: {
                    "bufs": len(pool),
                    "bytes": sum(
                        int(getattr(buf, "nbytes", 0) or 0)
                        for buf in pool.values()
                    ),
                }
                for b, pool in self._pad_pool.items()
            }
        base = self._stats()
        base.update(
            op="stats", ok=True, v=protocol.VERSION,
            role="daemon",
            metrics=obs_metrics.snapshot(),
            pad_pool=pad_pool,
            # the port's own: the daemon's kernel launches by kernel
            # (kernels.LAUNCHES), how a caller shows its requests ran
            # through the hand-written kernels
            launches=dict(LAUNCHES),
            # the port's own: the caching allocator's bytes on the card
            # (None on the CPU), a worker's share of a card that several
            # fleet workers hold
            device_memory=(
                {"allocated": torch.cuda.memory_allocated(self.device),
                 "reserved": torch.cuda.memory_reserved(self.device)}
                if self.device.type == "cuda" else None),
        )
        return base

    def _lanes(self) -> list:
        return ["inline", "shm"] if self._shm else ["inline"]

    def _count_copied(self, kernel: str, nbytes: int):
        """One process-wide + one per-kernel bytes-copied bump — the
        counter the copy-budget smoke regresses (docs/SERVING.md
        §copy accounting)."""
        if not nbytes:
            return
        obs_metrics.inc(f"serve.bytes_copied.{kernel}", nbytes)
        with self._lock:
            self._bytes_copied += nbytes

    def _admit(self, conn: _Conn, header: dict, payloads,
               inline_bytes: int = 0):
        rid = header.get("id")
        now = time.perf_counter()
        with self._lock:
            # inter-arrival EWMA: fast attack (one short gap IS a
            # burst — the window must widen on the second arrival, not
            # the tenth), slow release back toward idle
            if self._last_arrival is not None:
                gap = now - self._last_arrival
                if (self._arrival_ewma is None
                        or gap < self._arrival_ewma):
                    self._arrival_ewma = gap
                else:
                    self._arrival_ewma = (0.8 * self._arrival_ewma
                                          + 0.2 * gap)
            self._last_arrival = now
        try:
            kernel = header["kernel"]
            statics = dict(header.get("statics") or {})
            arrays = protocol.unpack_arrays(
                header.get("args") or [], payloads
            )
            spec, how = bucketing.bucket_for(kernel, arrays, statics)
            pad_frac = how if spec is not None else 0.0
            # an over-avatar request dispatches at its own shape: the
            # port has no mesh tier yet (bucketing.mesh_tier_for)
            bucket = bucketing.bucket_id(kernel, spec, statics, arrays)
        except (KeyError, ValueError, TypeError, AttributeError,
                protocol.ProtocolError) as e:
            # TypeError/AttributeError cover structurally malformed
            # headers (scalar shapes, non-dict args/statics) that the
            # field accessors raise before any explicit validation —
            # they must become an error REPLY, not an unhandled
            # exception that kills this client's handler thread
            conn.send({"v": protocol.VERSION, "id": rid, "ok": False,
                       "kind": "error", "error": f"bad request: {e}"})
            return
        # the request's inline payload bytes crossed the socket — the
        # recv-side half of the copy accounting (an shm-lane request
        # counts 0 here: the worker maps what the client wrote)
        self._count_copied(kernel, inline_bytes)
        with self._lock:
            self._next_rid += 1
            serial = self._next_rid
        req_id = header.get("request_id")
        replay = header.get("replay")
        if (req_id is not None and isinstance(replay, int)
                and not isinstance(replay, bool) and replay > 0
                and self._answer_from_memo(conn, rid, str(req_id),
                                           kernel, bucket)):
            return
        req = _Request(serial, rid if rid is not None else serial,
                       kernel, statics, arrays, spec, pad_frac,
                       bucket, conn, tenant=header.get("tenant"),
                       shm_ok=bool(header.get("shm_ok")),
                       request_id=(str(req_id) if req_id is not None
                                   else None),
                       replayed=(int(replay)
                                 if isinstance(replay, int)
                                 and not isinstance(replay, bool)
                                 and replay > 0 else None),
                       deadline_at=protocol.deadline_from_header(
                           header))
        try:
            self._q.put_nowait(req)
        except _queue_mod.Full:
            self._reject(req)

    def _reject(self, req: _Request):
        with self._lock:
            self._rejected += 1
        obs_metrics.inc("serve.rejected")
        depth = self._q.depth()
        retry = round(max(0.05, (depth + 1) * self._service_ewma), 3)
        journal.emit(
            "serve_rejected", kernel=req.kernel, request=req.rid,
            request_id=req.request_id,
            depth=depth, queue_max=self.queue_max, retry_after_s=retry,
        )
        try:
            req.conn.send({
                "v": protocol.VERSION, "id": req.rid, "ok": False,
                "kind": "overloaded", "retry_after_s": retry,
                "error": (f"queue at depth {depth} >= "
                          f"{self.queue_max}; retry after {retry}s"),
            })
        except OSError:
            pass

    def _expire(self, req: _Request, where: str, queue_wait=None):
        """Answer a request whose budget died before dispatch — the
        doomed-work refusal (docs/SERVING.md §deadlines): the pad and
        dispatch phases are skipped entirely, the expiry is journaled
        where the budget went, and the client sees ``expired`` (NOT
        ``overloaded`` — retrying the same shrinking budget is
        doomed, so no retry_after_s choreography)."""
        if not req.claim_done():
            return
        with self._lock:
            self._expired += 1
        obs_metrics.inc("serve.expired")
        journal.emit(
            "serve_request_expired", site="server", where=where,
            kernel=req.kernel, request=req.rid,
            request_id=req.request_id, bucket=req.bucket,
            worker_id=os.environ.get("TPKT_SERVE_WORKER_ID"),
            queue_wait_s=(round(queue_wait, 6)
                          if queue_wait is not None else None),
        )
        try:
            req.conn.send({
                "v": protocol.VERSION, "id": req.rid, "ok": False,
                "kind": "expired",
                "error": (f"deadline expired before dispatch "
                          f"({where})"),
            })
        except (OSError, protocol.ProtocolError):
            pass

    def _memo_put(self, req: _Request, specs, payloads):
        """Keep a delivered-or-not answer by its request_id (module
        constants ``REPLAY_MEMO_*``); the oldest answers go first."""
        nbytes = sum(len(p) for p in payloads)
        if nbytes > REPLAY_MEMO_MAX_B:
            return
        now = time.perf_counter()
        with self._lock:
            old = self._memo.pop(req.request_id, None)
            if old is not None:
                self._memo_bytes -= old[5]
            self._memo[req.request_id] = (now, req.kernel, req.bucket,
                                          specs, payloads, nbytes)
            self._memo_bytes += nbytes
            while self._memo and (
                    self._memo_bytes > REPLAY_MEMO_TOTAL_B
                    or now - next(iter(self._memo.values()))[0]
                    > REPLAY_MEMO_TTL_S):
                self._memo_bytes -= self._memo.popitem(last=False)[1][5]

    def _answer_from_memo(self, conn, rid, req_id: str, kernel: str,
                          bucket: str) -> bool:
        """Answer a replayed request (``replay`` > 0) that this daemon
        already ran from its kept answer, without running it again:
        kernels are pure, so the answer is the same, and the request_id
        is delivered once. False when no answer of the same kernel and
        bucket is kept (the request then runs)."""
        with self._lock:
            hit = self._memo.get(req_id)
            if hit is None or hit[1] != kernel or hit[2] != bucket:
                return False
            self._deduped += 1
        _t, _k, _b, specs, payloads, _n = hit
        obs_metrics.inc("serve.replays_deduped")
        journal.emit(
            "serve_request_deduped", kernel=kernel, request=rid,
            request_id=req_id, bucket=bucket,
            worker_id=os.environ.get("TPKT_SERVE_WORKER_ID"),
        )
        try:
            sent = conn.send({"v": protocol.VERSION, "id": rid, "ok": True,
                              "outputs": specs, "deduped": True}, payloads)
        except (OSError, protocol.ProtocolError):
            return True
        self._count_copied(kernel, sent)
        return True

    def _cancel(self, header: dict) -> dict:
        """The best-effort ``cancel`` op (docs/SERVING.md §deadlines):
        a pre-dispatch cancel drops the queued entry outright; an
        in-flight (or batch-pending) cancel just claims the request's
        done flag so its eventual result is discarded instead of sent
        — a running dispatch cannot be interrupted, only its
        answer suppressed. A miss (already answered, unknown id) is
        success too: cancel is advisory, never load-bearing."""
        req_id = header.get("request_id")
        rid = str(req_id) if req_id is not None else None
        phase, kernel = "miss", None
        if rid is not None:
            dropped = self._q.remove_request(rid)
            if dropped is not None and dropped.claim_done():
                phase, kernel = "queued", dropped.kernel
            else:
                with self._lock:
                    cands = [r for r in self._inflight.values()
                             if r.request_id == rid]
                    for pend in self._worker_pending.values():
                        cands.extend(r for r in pend
                                     if r.request_id == rid)
                for r in cands:
                    if r.claim_done():
                        phase, kernel = "inflight", r.kernel
                        break
        if phase != "miss":
            with self._lock:
                self._cancelled += 1
            obs_metrics.inc("serve.cancelled")
            journal.emit(
                "serve_cancelled", site="server", phase=phase,
                kernel=kernel, request_id=rid,
                worker_id=os.environ.get("TPKT_SERVE_WORKER_ID"),
            )
        return {"v": protocol.VERSION, "op": "cancel", "ok": True,
                "id": header.get("id"),
                "cancelled": phase != "miss", "phase": phase}

    # -------------------------------------------------------------- #
    # worker side: coalesce, dispatch, respond                       #
    # -------------------------------------------------------------- #

    def _worker_loop(self):
        while not self._stop.is_set():
            if self._retire_if_abandoned():
                return
            first = self._q.get(timeout=0.5)
            if first is None:
                continue
            window = self._window_s(self._q.depth())
            window = self._clamp_window(window, (first,))
            self._last_window_ms = round(window * 1e3, 3)
            obs_metrics.gauge("serve.batch_window_ms",
                              self._last_window_ms)
            batch = [first]
            if window > 0:
                end = time.perf_counter() + window
                while True:
                    taken = self._q.take_matching(
                        first.bucket, self.queue_max - len(batch)
                    )
                    if taken:
                        batch.extend(taken)
                        # a tighter-deadline member joining the batch
                        # pulls the window in — coalescing must never
                        # spend budget the tightest member lacks
                        end = min(end, time.perf_counter()
                                  + self._clamp_window(window, taken))
                    rem = end - time.perf_counter()
                    if rem <= 0:
                        break
                    time.sleep(min(rem, 0.001))
            else:
                batch.extend(self._q.take_matching(
                    first.bucket, self.queue_max - len(batch)
                ))
            obs_metrics.observe("serve.batch_size", len(batch))
            # the unstarted remainder is SHARED with the watchdog
            # (self._worker_pending): members coalesced behind a
            # permanently wedged request live only on this thread's
            # stack, so the watchdog must be able to rescue them —
            # a hand-back that waits for the wedged _execute to
            # return would wait forever
            ident = threading.get_ident()
            pending = collections.deque(batch)
            with self._lock:
                self._worker_pending[ident] = pending
            size = len(batch)
            while True:
                with self._lock:
                    if not pending:
                        self._worker_pending.pop(ident, None)
                        break
                    req = pending.popleft()
                try:
                    self._execute(req, size)
                except Exception as e:  # noqa: BLE001 — pool must survive
                    # _execute answers dispatch failures itself; a bug
                    # that still escapes (a response-path surprise)
                    # must not kill the worker thread and strand the
                    # rest of the batch
                    print(f"# serve: worker error on {req.kernel}: "
                          f"{e!r}", file=sys.stderr)
                    if req.claim_done():
                        try:
                            req.conn.send({
                                "v": protocol.VERSION, "id": req.rid,
                                "ok": False, "kind": "error",
                                "error": f"internal worker error: {e!r}",
                            })
                        except (OSError, protocol.ProtocolError):
                            pass
                if self._retire_if_abandoned():
                    # the watchdog abandoned this worker and already
                    # requeued whatever was left in `pending`
                    return

    def _window_s(self, depth: int) -> float:
        """The continuous-batching coalescing window for one pickup.
        Fixed mode (``TPKT_SERVE_BATCH_ADAPT=0``) returns the knob
        verbatim. Adaptive mode: an EMPTY queue means the request is
        alone — dispatch NOW, idle traffic never pays the window; a
        non-empty queue under burst (inter-arrival EWMA shorter than
        the max window) widens to ~``BATCH_TARGET`` projected
        arrivals, capped at ``TPKT_SERVE_BATCH_WINDOW_MS``; arrivals
        slower than the cap mean waiting buys nothing — 0 again."""
        if not self.batch_adapt:
            return self.batch_window_s
        if depth <= 0:
            return 0.0
        gap = self._arrival_ewma
        if gap is None or gap >= self.batch_window_s:
            return 0.0
        return min(self.batch_window_s, gap * (BATCH_TARGET - 1))

    @staticmethod
    def _clamp_window(window: float, reqs) -> float:
        """The deadline clamp on the coalescing window: never widen
        past HALF the tightest remaining budget among ``reqs`` — the
        other half is left for the dispatch itself, so coalescing can
        delay a deadline-carrying request but never doom it.
        Deadline-free members leave the window alone."""
        if window <= 0:
            return window
        now = time.monotonic()
        for r in reqs:
            if r.deadline_at is not None:
                window = min(
                    window, max(0.0, (r.deadline_at - now) / 2)
                )
        return window

    def _retire_if_abandoned(self) -> bool:
        """True when the watchdog abandoned THIS worker — and forget
        its ident on the way out: thread idents are recycled after
        exit, and a stale entry would make a future worker be born
        'abandoned' and silently shrink the pool."""
        ident = threading.get_ident()
        with self._lock:
            if ident not in self._abandoned:
                return False
            self._abandoned.discard(ident)
        return True

    def _bucket_lock(self, bucket: str):
        """The bucket's ``[lock, holder_ident]`` cell, on demand."""
        with self._lock:
            cell = self._bucket_locks.get(bucket)
            if cell is None:
                cell = self._bucket_locks[bucket] = [
                    threading.Lock(), None
                ]
            return cell

    def _acquire_bucket(self, bucket: str):
        """Serialize same-bucket dispatches (the bucket's first request
        loads its kernels and makes its launch plans once). A
        legitimately slow holder — a first request that builds a
        library can outlast any fixed fraction of the request timeout
        — is waited out indefinitely; ONLY a lock whose holder the
        watchdog abandoned as wedged is replaced, so the bucket cannot
        stay poisoned forever and two workers never run the same
        bucket concurrently."""
        poll = max(0.05, min(0.5, self.request_timeout_s / 4))
        while True:
            cell = self._bucket_lock(bucket)
            if cell[0].acquire(timeout=poll):
                with self._lock:
                    if self._bucket_locks.get(bucket) is not cell:
                        # replaced while we were blocked on the stale
                        # lock: drop it, race for the current one
                        cell[0].release()
                        continue
                    cell[1] = threading.get_ident()
                return cell
            with self._lock:
                holder = cell[1]
                if (holder is not None
                        and holder in self._abandoned
                        and self._bucket_locks.get(bucket) is cell):
                    self._bucket_locks[bucket] = [
                        threading.Lock(), None
                    ]
                    # the abandoned holder may still be INSIDE its
                    # dispatch, aliasing this bucket's pad staging
                    # buffers (a CPU tensor shares them) — the
                    # retry must never re-zero/overwrite them under a
                    # live attempt, so it gets a fresh pool
                    self._pad_pool.pop(bucket, None)

    def _execute(self, req: _Request, batch_size: int):
        # ambient trace context for the whole attempt: every span the
        # worker thread emits below — the wait/pad phases here AND the
        # aot/integrity children nested under dispatch, which know
        # nothing about requests — carries req.request_id
        # (docs/OBSERVABILITY.md §request tracing)
        with trace.request_ctx(req.request_id):
            self._execute_attempt(req, batch_size)

    def _upload(self, kernel: str, args) -> list:
        """The operands as the wrapper takes them: a 0-d array as a
        Python number, an array as a tensor on the device. On the CPU a
        read-only operand is copied first, and the copy counted: the
        tensor would alias it."""
        out = []
        for a in args:
            if a.ndim == 0:
                out.append(a.item())
                continue
            if self.device.type == "cpu" and not a.flags.writeable:
                a = np.array(a)
                self._count_copied(kernel, a.nbytes)
            out.append(torch.from_numpy(a).to(self.device))
        return out

    def _execute_attempt(self, req: _Request, batch_size: int):
        from tpukernels_torch import registry

        with req.lock:
            if req.done:
                # cancelled while queued behind this batch (the
                # in-flight cancel path claimed the done flag): the
                # work was never started — skip it entirely
                return
        req.worker_ident = threading.get_ident()
        # local t_start: the watchdog nulls req.t_start on a requeue,
        # and this attempt may be the abandoned original unwinding
        # late — its own wall must not read a field the retry owns
        t_start = time.perf_counter()
        req.t_start = t_start
        with self._lock:
            self._inflight[req.serial] = req
        queue_wait = t_start - req.t_enq
        obs_metrics.observe("serve.queue_wait_s", queue_wait)
        # the admission-to-worker-start wait (batch coalescing window
        # included) as a pre-measured span: the request's first
        # timeline phase (docs/OBSERVABILITY.md §request tracing)
        trace.emit_span("serve/wait/queue", queue_wait,
                        kernel=req.kernel, bucket=req.bucket,
                        batch_size=batch_size,
                        window_ms=self._last_window_ms)
        if (req.deadline_at is not None
                and time.monotonic() >= req.deadline_at):
            # the budget died in the queue/coalescing window — skip
            # the pad/dispatch phases entirely (the wait span above
            # shows where it went) and answer the expiry now
            with self._lock:
                if self._inflight.get(req.serial) is req:
                    self._inflight.pop(req.serial, None)
            self._expire(req, where="worker", queue_wait=queue_wait)
            return
        if req.spec is not None and req.requeues == 0:
            # once per request, not per attempt: a retry would count
            # the same padding waste twice
            obs_metrics.observe("serve.bucket_pad_frac", req.pad_frac)
        cell = None
        try:
            # bucket lock FIRST: the per-bucket pad staging pool can
            # only be reused while this thread owns the bucket (and by
            # the time the lock releases, the upload and the completed
            # dispatch are done with the staging buffers)
            l0 = time.perf_counter()
            cell = self._acquire_bucket(req.bucket)
            trace.emit_span("serve/wait/lock",
                            time.perf_counter() - l0,
                            bucket=req.bucket)
            if req.spec is not None:
                with self._lock:
                    pool = self._pad_pool.setdefault(req.bucket, {})
                with trace.span("serve/pad", kernel=req.kernel,
                                bucket=req.bucket):
                    args, meta = bucketing.pad_args(
                        req.kernel, req.spec, req.arrays, pool=pool)
                # padding is a genuinely extra staging copy — counted,
                # unlike the one producer-to-consumer payload move
                self._count_copied(req.kernel,
                                   meta.get("copied_bytes") or 0)
            else:
                args, meta = req.arrays, None
            # upload, dispatch and the copy back (which waits for the
            # device) in one span: serve/<kernel> minus its nested
            # dispatch/<key> is the request's copies
            with trace.span(f"serve/{req.kernel}", bucket=req.bucket,
                            device=str(self.device)):
                out = registry.dispatch(req.kernel,
                                        *self._upload(req.kernel, args),
                                        **req.statics)
                outs = tuple(
                    o.cpu().numpy()
                    for o in (out if isinstance(out, (tuple, list))
                              else (out,))
                )
            if meta is not None:
                outs = bucketing.unpad_outputs(req.kernel, meta, outs)
        except Exception as e:  # noqa: BLE001 — reported to the client
            if req.claim_done():
                self._finish(req, None, error=repr(e),
                             wall=time.perf_counter() - t_start)
            return
        finally:
            if cell is not None:
                with self._lock:
                    if cell[1] == threading.get_ident():
                        cell[1] = None
                cell[0].release()
            # deregister only THIS attempt: after a watchdog requeue
            # the same request object is re-registered by its retry
            # worker, and an abandoned worker unwinding late must not
            # blind the watchdog to that retry
            with self._lock:
                if (self._inflight.get(req.serial) is req
                        and req.worker_ident == threading.get_ident()):
                    self._inflight.pop(req.serial, None)
        if req.claim_done():
            wall = time.perf_counter() - t_start
            with self._lock:
                self._service_ewma = (0.8 * self._service_ewma
                                      + 0.2 * wall)
            self._finish(req, outs, queue_wait=queue_wait,
                         batch_size=batch_size, wall=wall)
        # else: the watchdog already answered for this request (the
        # wedge finally unwound, or the requeue raced us) — discard

    def _finish(self, req: _Request, outs, error=None,
                queue_wait=None, batch_size=None, wall=None,
                kind="error"):
        if wall is None:
            # watchdog caller (wedged-twice): the retry attempt's own
            # start is still in req.t_start here. _execute passes its
            # attempt-local wall instead — req.t_start may belong to a
            # different attempt by the time a slow original unwinds.
            wall = time.perf_counter() - (req.t_start or req.t_enq)
        payloads = ()
        segs: list = []
        if error is None:
            # an out-of-contract output (a dtype outside the wire's
            # two) must become an error RESPONSE, not an exception
            # that kills the worker thread
            try:
                specs, payloads = protocol.pack_arrays(outs)
            except protocol.ProtocolError as e:
                error = f"unserializable output: {e}"
                payloads = ()
        if error is None:
            with self._lock:
                self._served += 1
            obs_metrics.inc(f"serve.requests.{req.kernel}")
            obs_metrics.observe(f"serve.wall_s.{req.kernel}", wall)
            header = {"v": protocol.VERSION, "id": req.rid, "ok": True,
                      "outputs": specs}
            payloads_kept = payloads
            if req.shm_ok and self._shm:
                # response lane: big outputs land in segments the
                # client maps-and-unlinks; only names ride the wire.
                # An exhausted /dev/shm degrades to inline, never to
                # a failed response.
                try:
                    shm_descs, payloads2, segs, _staged = (
                        protocol.stage_shm_payloads(payloads,
                                                    self._shm_min)
                    )
                except OSError:
                    shm_descs = None
                if shm_descs is not None:
                    header["_shm"] = shm_descs
                    payloads = payloads2
        else:
            obs_metrics.inc("serve.errors")
            header = {"v": protocol.VERSION, "id": req.rid, "ok": False,
                      "kind": kind, "error": error}
            payloads = ()
        if req.request_id is not None:
            obs_metrics.inc("serve.requests_traced")
            if error is None:
                self._memo_put(req, specs, payloads_kept)
        journal.emit(
            "serve_request", kernel=req.kernel, request=req.rid,
            request_id=req.request_id,
            worker_id=os.environ.get("TPKT_SERVE_WORKER_ID"),
            tenant=req.tenant,
            bucket=req.bucket, pad_frac=round(req.pad_frac, 6),
            bucketed=req.spec is not None,
            # the reference's field: None, the port has no mesh tier
            mesh_shape=None,
            # the per-request shape-mix record (requested, PRE-pad
            # shapes/dtypes): the input the reference's bucket-table
            # optimizer (serve/adapt.py) mines
            shapes=req.shapes, dtypes=req.dtypes,
            wall_s=round(wall, 6),
            queue_wait_s=round(queue_wait, 6)
            if queue_wait is not None else None,
            batch_size=batch_size, requeues=req.requeues,
            replayed=req.replayed,
            ok=error is None, error=error,
        )
        # delay_response fault point (docs/RESILIENCE.md): holds THIS
        # completed response on the floor for N s — the deterministic
        # slow-but-alive worker the hedged-dispatch chaos proof pins
        faults.response_fault(req.kernel)
        try:
            sent = req.conn.send(header, payloads)
        except (OSError, protocol.ProtocolError):
            # client gone/stalled; the work is journaled anyway — and
            # response segments no one will ever map are unlinked NOW
            for seg in segs:
                seg.close()
                seg.unlink()
        else:
            self._count_copied(req.kernel, sent)
            if segs:
                now = time.perf_counter()
                with self._lock:
                    self._shm_ledger.extend(
                        (seg.name, now) for seg in segs
                    )
                for seg in segs:
                    seg.close()  # the client unlinks on map; the aged
                    #              ledger is the crash backstop
                if not req.conn.lane_logged:
                    req.conn.lane_logged = True
                    journal.emit("serve_lane_negotiated", lane="shm",
                                 kernel=req.kernel, request=req.rid)

    # -------------------------------------------------------------- #
    # watchdog: abandon wedged workers, requeue once                 #
    # -------------------------------------------------------------- #

    def _probe_alive(self, timeout_s: float = 2.0) -> bool:
        """Device liveness from a side thread (SIGALRM is main-thread
        only): a trivial device op either completes inside the window
        (SLOW — the device answers, one request/worker is stuck) or
        does not (WEDGED). On the card the op runs on the probe's own
        stream and its event is polled: waiting on the default stream
        (``torch.cuda.synchronize``) would wait on the stuck work
        itself."""
        result = []

        def _probe():
            try:
                if self._probe_stream is None:
                    torch.zeros(2).add_(1)
                else:
                    with torch.cuda.stream(self._probe_stream):
                        self._probe_buf.add_(1)
                        done = torch.cuda.Event()
                        done.record()
                    end = time.monotonic() + timeout_s
                    while not done.query():
                        if time.monotonic() > end:
                            return
                        time.sleep(0.001)
                result.append(True)
            except Exception:  # noqa: BLE001 — a dead device IS the answer
                pass

        t = threading.Thread(target=_probe, daemon=True,
                             name="serve-probe")
        t.start()
        t.join(timeout_s)
        return bool(result)

    def _watchdog_loop(self):
        period = min(1.0, max(0.1, self.request_timeout_s / 4))
        grace = self.request_timeout_s * 1.5
        while not self._stop.is_set():
            time.sleep(period)
            now = time.perf_counter()
            with self._lock:
                overdue = [
                    r for r in self._inflight.values()
                    if r.t_start is not None
                    and now - r.t_start > grace * (1 + r.patience)
                ]
                expired = [
                    n for n, t in self._shm_ledger
                    if now - t > SHM_RESPONSE_GRACE_S
                ]
                if expired:
                    self._shm_ledger = [
                        (n, t) for n, t in self._shm_ledger
                        if now - t <= SHM_RESPONSE_GRACE_S
                    ]
            for name in expired:
                # normally ENOENT (the client mapped and unlinked);
                # a real unlink here is the crashed-client backstop
                protocol.unlink_shm(name)
            for req in overdue:
                self._handle_wedge(req)

    def _handle_wedge(self, req: _Request):
        with self._lock:
            if self._inflight.get(req.serial) is not req:
                return
        # classify BEFORE abandoning: a live device means this may be
        # a legitimately slow attempt — a first request that builds a
        # library can outlast any fixed grace — and abandoning it would
        # replace the bucket lock under a live attempt, putting a second
        # one of the same bucket in flight. One doubled grace beats
        # that; an attempt still overdue at 2x grace is treated as
        # wedged regardless of the probe.
        verdict = watchdog.classify_timeout(
            self._probe_alive(), site="serve", kernel=req.kernel,
            request=req.rid,
        )
        if verdict == "slow" and req.patience == 0:
            req.patience = 1
            print(f"# serve: {req.kernel} request {req.rid} overdue "
                  f"(> {self.request_timeout_s * 1.5:.1f}s) but the "
                  "device answers - extending grace once",
                  file=sys.stderr)
            return
        with self._lock:
            still = self._inflight.pop(req.serial, None)
        if still is None:
            return  # the attempt completed during the probe
        obs_metrics.inc("watchdog.kills")
        journal.emit(
            "watchdog_fire", mechanism="serve-abandon", site="serve",
            timeout_s=self.request_timeout_s, kernel=req.kernel,
            request=req.rid,
        )
        if req.worker_ident is not None:
            with self._lock:
                self._abandoned.add(req.worker_ident)
                # rescue batch members coalesced behind the wedge:
                # they were never started (not in _inflight) and the
                # abandoned thread will never reach its hand-back —
                # drain under the lock so a late-unwinding worker
                # cannot pop a request we are about to requeue
                pend = self._worker_pending.pop(req.worker_ident, None)
                stranded = list(pend) if pend else []
                if pend:
                    pend.clear()
            self._spawn_worker()
            for rest in stranded:
                # forced: already admitted, must not bounce off
                # backpressure on the rescue
                self._q.put_nowait(rest, force=True)
        if req.requeues < 1:
            req.requeues += 1
            req.t_start = None
            req.worker_ident = None
            # the retry's queue wait measures ITS queueing, not the
            # failed attempt it replaces (~grace worth of wedge time
            # would dominate the serve.queue_wait_s tail otherwise)
            req.t_enq = time.perf_counter()
            with self._lock:
                self._requeued += 1
            obs_metrics.inc("serve.requeued")
            journal.emit(
                "serve_request_requeued", kernel=req.kernel,
                request=req.rid, request_id=req.request_id,
                bucket=req.bucket,
                timeout_s=self.request_timeout_s,
            )
            # forced: a request the service already accepted must not
            # bounce off its own backpressure on the retry
            self._q.put_nowait(req, force=True)
        elif req.claim_done():
            # structured kind: the fleet router keys failover on it —
            # a worker that wedged twice should not be fed this
            # bucket again until it cools (docs/SERVING.md §fleet)
            self._finish(
                req, None, kind="wedged",
                error=(f"request wedged twice (> "
                       f"{self.request_timeout_s}s each attempt)"),
            )


# ------------------------------------------------------------------ #
# CLI entry (python -m tpukernels_torch.serve)                       #
# ------------------------------------------------------------------ #

def main(argv=None):
    import signal

    argv = sys.argv[1:] if argv is None else list(argv)
    socket_path = queue_max = workers = None
    batch_window_ms = request_timeout_s = None
    it = iter(argv)
    try:
        for a in it:
            if a == "--socket":
                socket_path = next(it)
            elif a == "--queue-max":
                queue_max = int(next(it))
            elif a == "--workers":
                workers = int(next(it))
            elif a == "--batch-window-ms":
                batch_window_ms = float(next(it))
            elif a == "--request-timeout-s":
                request_timeout_s = float(next(it))
            elif a in ("-h", "--help"):
                print(__doc__, file=sys.stderr)
                return 0
            else:
                print(__doc__, file=sys.stderr)
                print(f"serve: unknown argument {a!r}", file=sys.stderr)
                return 2
    except (StopIteration, ValueError):
        print(f"serve: {a} needs a value", file=sys.stderr)
        return 2

    # an unattended daemon's evidence lands in a dated journal in the
    # serve directory unless the operator chose one
    if os.environ.get("TPKT_HEALTH_JOURNAL") is None:
        os.environ["TPKT_HEALTH_JOURNAL"] = _cachedir.serve_dir()
    # sampled oracle canaries are multi-ms outliers in exactly the
    # request tail this daemon is judged on; the always-on tripwire
    # stays, and an explicit env choice wins
    os.environ.setdefault("TPKT_INTEGRITY", "tripwire")

    try:
        obs_metrics.flush_interval_s()  # a bad value refuses to start
        server = Server(socket_path, queue_max, workers,
                        batch_window_ms, request_timeout_s)
    except (ValueError, OSError) as e:
        # OSError: an unreadable TPKT_SERVE_BUCKETS file path
        print(f"serve: {e}", file=sys.stderr)
        return 2
    except RuntimeError as e:
        # no card, and TPKT_SERVE_DEVICE does not name the CPU
        print(f"serve: {e} (set TPKT_SERVE_DEVICE=cpu to serve the plain "
              "versions on the CPU)", file=sys.stderr)
        return 2
    try:
        pidfile = hold_pidfile(_cachedir.serve_pidfile_path())
    except RuntimeError as e:
        print(f"serve: {e}", file=sys.stderr)
        return 3

    from tpukernels_torch.obs import scaling as obs_scaling

    obs_scaling.emit_inventory("serve")
    obs_metrics.start_flusher()
    signal.signal(signal.SIGTERM, server.stop)
    signal.signal(signal.SIGINT, server.stop)
    print(f"# serve: listening on {server.socket_path} "
          f"(pid {os.getpid()}, {server.device}, workers "
          f"{server.workers}, queue max {server.queue_max})",
          file=sys.stderr)
    try:
        server.serve_forever()
    except OSError as e:
        print(f"serve: cannot serve on {server.socket_path}: {e}",
              file=sys.stderr)
        return 1
    finally:
        try:
            pidfile.close()
            os.unlink(_cachedir.serve_pidfile_path())
        except OSError:
            pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
