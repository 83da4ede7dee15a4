"""Front-end router of the port's serving fleet.

The port's copy of ``tpukernels/serve/router.py``. A process that accepts
the daemon's wire (``protocol.py``) on one front socket and forwards
every dispatch to one of N worker daemons, each a plain ``python -m
tpukernels_torch.serve`` on its own socket. It speaks the daemon's wire,
so every client (``ServeClient`` of either package, ``capi.run_from_c``
through ``TPKT_SERVE_SOCKET``, ``tools/loadgen.py --serve``) talks to a
fleet by pointing at the front socket, unchanged.

The routing disciplines:

- **Consistent bucket routing** — each request is hashed by its
  (kernel, bucket) key (``bucketing.bucket_id``, the key the worker's
  batching and locks use) on a deterministic md5 ring
  (:func:`ring_order`), so every request for one bucket lands on ONE
  worker, whose launch plans and pad buffers for it stay warm.
- **Spill on backpressure** — a worker's admission-control rejection
  (``retry_after_s``) is not bounced to the client: the router forwards
  the request to the bucket's fixed ring sibling (``serve_spill``,
  reason ``overloaded``). Only when the sibling also rejects does the
  client see ``retry_after_s``.
- **Failover on transport loss and wedge** — a worker that dies
  mid-request or answers ``kind: "wedged"`` (its own watchdog gave up
  twice) triggers the same spill (reasons ``transport`` / ``wedged``);
  a wedge also puts the worker on a routing cooldown
  (``TPKT_ROUTE_COOLDOWN_S``), so its buckets fail over first instead
  of feeding the wedge. Kernels are pure functions of their operands,
  which is what makes re-dispatching an accepted request safe.
- **Live drain** — the ``{"op": "drain", "worker": i}`` control op takes
  a worker out of the ring for new requests while its in-flight
  forwards finish; ``undrain`` restores it and re-reads the bucket
  table (``bucketing.reload``).
- **Self-healing** — the router process runs the fleet health manager
  (``serve/health.py``): a crashed worker is declared ``worker_dead``,
  its ``/dev/shm`` segments swept, and it is respawned on its original
  socket. An accepted request whose worker died mid-flight is re-routed
  once to the ring sibling as a replay (``serve_request_replayed``),
  so no accepted request drops. When a bucket's home and sibling are
  both out, the router sheds by priority class, batch first, with a
  ``retry_after_s`` from the respawn backoff, and journals
  ``fleet_degraded`` level changes.
- **Per-tenant fairness** — a token bucket per ``tenant`` header field
  (``TPKT_ROUTE_TENANT_RATE`` tokens/s up to ``TPKT_ROUTE_TENANT_BURST``,
  0 = quotas off); a tenant over quota is answered ``kind:
  "overloaded"`` with a refill-derived ``retry_after_s``
  (``serve_tenant_throttled``). A ``"batch"`` request is admitted only
  while the tenant keeps a reserve (1 + burst/2 tokens) for
  ``"interactive"`` traffic.
- **Deadlines and hedged dispatch** — a request whose wire
  ``budget_ms`` is already spent is refused at the front door
  (``serve_deadline_infeasible``), and a WAL entry whose budget died
  across a crash is expired at dequeue (``serve_request_expired``); a
  forward that outlives the router's own forward-wall percentile
  (``TPKT_ROUTE_HEDGE_PCTL``, default p95, 0 = off) is re-issued with
  the SAME request_id to the ring sibling as a replay; the first answer
  wins and the loser gets a best-effort ``cancel`` (``serve_hedged`` /
  ``serve_cancelled``), at most one hedge a request, the hedged share
  capped by ``TPKT_ROUTE_HEDGE_MAX_FRAC``.
- **Durable admission** — an accepted request is fsync'd into
  ``router.wal`` (``serve/wal.py``) before its forward; a router
  respawned by the guardian (``serve/guardian.py``) replays the
  unacknowledged entries before its front socket opens and stashes
  their results, so a client's same-request_id retry is answered from
  the stash: one delivery to a worker per request_id.

The router never touches the card and imports no torch (standard
library, numpy and the bucket table): it computes bucket keys from the
header's arg specs alone (``bucketing.spec_stubs``; it never reads a
payload byte) and relays inline payloads verbatim. On the shm lane it
relays only segment descriptors (``serve.bytes_copied.<kernel>`` counts
what still crosses it inline). The port has no mesh tier
(``bucketing.mesh_tier_for``), so an over-avatar request is routed on
its own shape's bucket and dispatched at that shape. Clean-path stdout
is empty (notes to stderr, evidence to the journal).

Run it: ``python -m tpukernels_torch.serve.router --socket FRONT --worker
W0.sock --worker W1.sock ...``, or let ``python -m
tpukernels_torch.serve.ctl start-fleet N`` spawn workers and router
together (``serve/fleet.py``).
"""

from __future__ import annotations

import base64
import hashlib
import os
import socket
import sys
import threading
import time

from tpukernels_torch.obs import metrics as obs_metrics
from tpukernels_torch.resilience import faults, journal
from tpukernels_torch.serve import bucketing, protocol
from tpukernels_torch.serve import wal as serve_wal
from tpukernels_torch.serve.proc import DEFAULT_REQUEST_TIMEOUT_S, float_knob

DEFAULT_TENANT_RATE = 0.0     # tokens/s; 0 = per-tenant quotas OFF
DEFAULT_TENANT_BURST = 8.0    # token-bucket capacity per tenant
DEFAULT_COOLDOWN_S = 30.0     # wedged-worker routing cooldown

# hedged dispatch: a request whose
# forward outlives the fleet's own p-th forward-wall percentile is
# re-issued to its ring sibling as an idempotent replay — the
# tail-at-scale tolerance move. 0 disables hedging entirely.
DEFAULT_HEDGE_PCTL = 95.0     # TPKT_ROUTE_HEDGE_PCTL
DEFAULT_HEDGE_MAX_FRAC = 0.1  # TPKT_ROUTE_HEDGE_MAX_FRAC: hedges/routed
HEDGE_MIN_SAMPLES = 20        # forward walls before the pctl is trusted

PRIORITIES = ("interactive", "batch")

# hint cap for throttle replies: at tiny refill rates the raw
# (need - tokens) / rate hint could tell a client to sleep for
# minutes — backpressure is a pacing signal, not a ban
MAX_RETRY_HINT_S = 5.0

# durable-admission bound: inline request
# payloads up to this many bytes ride into router.wal base64'd, so a
# respawned router can replay the request self-contained. Bigger
# requests (and shm-lane requests whose client already unlinked the
# segments) are skipped LOUDLY at replay time — the client's reconnect
# budget owns their retry.
WAL_MAX_PAYLOAD_B = 262144


def ring_order(bucket: str, n: int) -> list:
    """Deterministic worker preference order for one bucket key over
    an ``n``-worker fleet: md5 (stable across processes and runs —
    python's own ``hash`` is salted) picks the primary, then the ring
    walks forward. Index 0 is the bucket's home, index 1 its one
    deterministic spill sibling — the whole sharding contract in four
    lines, importable by tests and operators alike."""
    h = int(hashlib.md5(bucket.encode()).hexdigest(), 16)
    return [(h + k) % n for k in range(n)]


class _Upstream:
    """One worker's connection pool. Each pooled socket carries one
    outstanding request at a time (the protocol's pipelining
    contract); concurrent forwards to the same worker each take their
    own connection."""

    def __init__(self, path: str, timeout_s: float):
        self.path = path
        self.timeout_s = timeout_s
        self._idle: list = []
        self._lock = threading.Lock()

    def acquire(self):
        with self._lock:
            if self._idle:
                return self._idle.pop()
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(self.timeout_s)
        try:
            s.connect(self.path)
        except OSError:
            s.close()
            raise
        return s

    def release(self, sock, poisoned: bool):
        if poisoned:
            try:
                sock.close()
            except OSError:
                pass
            return
        with self._lock:
            self._idle.append(sock)

    def close_all(self):
        with self._lock:
            idle, self._idle = self._idle, []
        for s in idle:
            try:
                s.close()
            except OSError:
                pass


class _Conn:
    """Front-socket connection + send lock (the server.py discipline:
    frames from concurrent repliers must never interleave)."""

    __slots__ = ("sock", "send_lock")

    def __init__(self, sock):
        self.sock = sock
        self.send_lock = threading.Lock()

    def send(self, header, payloads=()) -> int:
        with self.send_lock:
            return protocol.send_frame(self.sock, header, payloads)


class _Attempt:
    """One racing upstream forward of a hedged dispatch. ``done`` is
    guarded by the shared race condition variable; ``alock`` guards
    the socket handoff so ``abort`` (the loser's fast exit) can never
    close a socket the pool already owns again."""

    __slots__ = ("idx", "resp", "payloads", "exc", "done", "cond",
                 "sock", "alock", "aborted")

    def __init__(self, idx: int, cond):
        self.idx = idx
        self.resp = None
        self.payloads = ()
        self.exc = None
        self.done = False
        self.cond = cond
        self.sock = None
        self.alock = threading.Lock()
        self.aborted = False

    def abort(self):
        """Close the attempt's live socket from outside: a loser whose
        reply the worker suppressed (in-flight cancel) would otherwise
        sit in recv until the pool timeout — the close errors it out
        NOW, and the release path poisons the connection."""
        with self.alock:
            self.aborted = True
            s = self.sock
            if s is not None:
                try:
                    s.close()
                except OSError:
                    pass


class Router:
    def __init__(self, socket_path: str, workers,
                 tenant_rate=None, tenant_burst=None, cooldown_s=None):
        if not workers:
            raise ValueError("router needs at least one --worker socket")
        self.socket_path = socket_path
        self.workers = list(workers)
        self.tenant_rate = (tenant_rate if tenant_rate is not None
                            else float_knob("TPKT_ROUTE_TENANT_RATE",
                                             DEFAULT_TENANT_RATE))
        self.tenant_burst = (tenant_burst if tenant_burst is not None
                             else float_knob("TPKT_ROUTE_TENANT_BURST",
                                              DEFAULT_TENANT_BURST,
                                              floor=1.0))
        self.cooldown_s = (cooldown_s if cooldown_s is not None
                           else float_knob("TPKT_ROUTE_COOLDOWN_S",
                                            DEFAULT_COOLDOWN_S))
        # hedged dispatch knobs (fail-loud, the _float_knob contract):
        # pctl 0 = off; max_frac caps the hedged fraction of routed
        # traffic so a fleet-wide slowdown cannot double its own load
        self.hedge_pctl = float_knob("TPKT_ROUTE_HEDGE_PCTL",
                                      DEFAULT_HEDGE_PCTL)
        self.hedge_max_frac = float_knob("TPKT_ROUTE_HEDGE_MAX_FRAC",
                                          DEFAULT_HEDGE_MAX_FRAC)
        # upstream patience: the worker's own watchdog bounds a
        # request (slow-grace + requeue-once + wedged-twice), so the
        # router waits comfortably past that before calling transport
        req_t = float_knob("TPKT_SERVE_REQUEST_TIMEOUT_S",
                            DEFAULT_REQUEST_TIMEOUT_S, floor=0.1)
        self._pools = [_Upstream(w, timeout_s=req_t * 8 + 30)
                       for w in self.workers]
        self._stop = threading.Event()
        self._listener = None
        self._lock = threading.Lock()
        self._draining: set = set()          # worker indices
        # self-healing state: workers
        # the health manager declared dead/quarantined leave the ring
        # until their respawn passes the rejoin gate; the degradation
        # level derives from the down set and is journaled on change
        self._down: set = set()              # dead / not-yet-rejoined
        self._quarantined: set = set()       # crash-looped, operator-gated
        self._health = None                  # HealthManager, if attached
        self._level = "ok"                   # ok | degraded | critical
        self._cooldown: dict = {}            # idx -> until (perf_counter)
        self._inflight = [0] * len(self.workers)
        self._routed_to = [0] * len(self.workers)
        self._routed = 0
        self._spilled = 0
        self._throttled = 0
        self._rejected = 0
        self._hedged = 0
        self._expired = 0      # deadline died at router/WAL dequeue
        self._infeasible = 0   # refused at admission: budget already 0
        # forward-wall log-bucket histogram (obs/metrics.py buckets —
        # the hedge threshold is its p-th percentile): [count, max,
        # {bucket_index: n}], guarded by self._lock
        self._fwd_walls = [0, 0.0, {}]
        self._tenants: dict = {}             # tenant -> [tokens, last]
        self._meta = {"device_kind": None, "torch": None, "cuda": None}
        self._meta_next_try = 0.0            # unresolved-meta rate limit
        # lane advertisement relayed from the workers: the router
        # itself never maps a segment — it forwards descriptors — but
        # clients negotiate against the FRONT socket, so the pong must
        # carry what the workers can do
        self._lanes_cache = None
        self._shm_min_cache = None
        self._req_trace_cache = None   # workers' request_trace pong
        self._bytes_copied = 0               # relayed inline payload B
        # durable admission: accepted
        # requests land in router.wal before the forward; a respawned
        # router replays the unacked ones and STASHES their results so
        # the client's same-request_id retry is answered from the
        # stash — one delivery to the worker per request_id
        self._wal = None                     # serve_wal.Wal, if attached
        self._wal_seq = 0
        self._stash: dict = {}  # request_id -> {resp,payloads,worker,t}
        self._stash_ttl_s = req_t * 8 + 30   # same patience as the pools
        self._t0 = time.time()
        # fail-fast on a misconfigured bucket table, like the worker:
        # the router and its workers MUST shard on the same table
        bucketing.bucket_configs()

    # -------------------------------------------------------------- #
    # lifecycle                                                      #
    # -------------------------------------------------------------- #

    def serve_forever(self):
        d = os.path.dirname(self.socket_path)
        if d:
            os.makedirs(d, exist_ok=True)
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)
        self._listener = socket.socket(socket.AF_UNIX,
                                       socket.SOCK_STREAM)
        self._listener.bind(self.socket_path)
        self._listener.listen(128)
        self._listener.settimeout(0.5)
        # the router is a start point too: reclaim segments whose
        # creator died before its peer unlinked them
        swept = protocol.sweep_stale_segments()
        journal.emit(
            "serve_start", role="router", socket=self.socket_path,
            workers=len(self.workers), worker_sockets=self.workers,
            tenant_rate=self.tenant_rate,
            tenant_burst=self.tenant_burst, shm_swept=swept,
        )
        try:
            while not self._stop.is_set():
                try:
                    conn, _addr = self._listener.accept()
                except socket.timeout:
                    continue
                except OSError:
                    break
                threading.Thread(
                    target=self._client_loop, args=(_Conn(conn),),
                    daemon=True, name="route-client",
                ).start()
        finally:
            self.shutdown()

    def stop(self, *_sig):
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
            for pool in self._pools:
                pool.close_all()
            # unclaimed replay results: free their response segments
            # now — no client is coming for them through THIS process
            with self._lock:
                stash, self._stash = self._stash, {}
            for hit in stash.values():
                self._drop_stashed(hit)
            if self._wal is not None:
                self._wal.close()
            journal.emit(
                "serve_stop", role="router", routed=self._routed,
                spilled=self._spilled, throttled=self._throttled,
                rejected=self._rejected, hedged=self._hedged,
                expired=self._expired, infeasible=self._infeasible,
                uptime_s=round(time.time() - self._t0, 3),
            )

    # -------------------------------------------------------------- #
    # self-healing hooks (serve/health.py)                           #
    # -------------------------------------------------------------- #

    def attach_health(self, hm):
        self._health = hm

    # -------------------------------------------------------------- #
    # durable admission                                            #
    # -------------------------------------------------------------- #

    def attach_wal(self, w):
        self._wal = w

    def _wal_record(self, header, payloads, kernel, bucket):
        """Persist one accepted request before its forward; returns
        the WAL key (None when no WAL is attached). Inline payloads up
        to WAL_MAX_PAYLOAD_B ride along base64'd so the replay is
        self-contained; oversize ones record their size and are
        skipped loudly at replay time."""
        if self._wal is None:
            return None
        with self._lock:
            self._wal_seq += 1
            seq = self._wal_seq
        key = f"{os.getpid()}-{seq}"
        # epoch wall time, not monotonic: replay happens in a FRESH
        # process after a crash, and epoch time is the only clock
        # that bridges incarnations on one host — it turns the
        # entry's budget_ms into a remaining budget at dequeue time
        entry = {"header": dict(header), "kernel": kernel,
                 "bucket": bucket, "t_wal": round(time.time(), 6)}
        total = sum(len(p) for p in payloads)
        if total <= WAL_MAX_PAYLOAD_B:
            entry["p64"] = [base64.b64encode(bytes(p)).decode("ascii")
                            for p in payloads]
        else:
            entry["oversize_b"] = total
        self._wal.append(key, entry)
        return key

    def replay_wal(self) -> int:
        """Drain the PREVIOUS incarnation's replay debt — called by
        ``main()`` after the pidfile is held and BEFORE the front
        socket opens, so every stashable result is stashed before any
        reconnecting client's same-request_id retry can arrive (no
        double-delivery window). Returns the entries processed."""
        if self._wal is None:
            return 0
        pending = self._wal.take_pending()
        for key, entry in pending.items():
            try:
                self._replay_one(key, entry if isinstance(entry, dict)
                                 else {})
            except Exception as e:  # one bad entry must not kill start
                print(f"# route: wal replay {key} failed: {e!r}",
                      file=sys.stderr)
                self._wal.ack(key)
        return len(pending)

    def _replay_one(self, key: str, entry: dict):
        header = dict(entry.get("header") or {})
        kernel = entry.get("kernel")
        bucket = entry.get("bucket")
        rid = header.get("id")
        req_id = header.get("request_id")
        req_id = str(req_id) if req_id is not None else None
        tenant = header.get("tenant") or "-"

        def skip(reason):
            journal.emit(
                "serve_request_replayed", via="wal", ok=False,
                reason=reason, kernel=kernel, bucket=bucket,
                request=rid, request_id=req_id, tenant=tenant,
            )
            print(f"# route: wal replay skipped "
                  f"{req_id or key}: {reason}", file=sys.stderr)
            self._wal.ack(key)

        p64 = entry.get("p64")
        if p64 is None:
            return skip("payload-not-journaled")
        if not kernel or not bucket:
            return skip("malformed-entry")
        # shm-lane operands: the client unlinks its request segments
        # the moment its round trip errors, so they are usually gone
        # by now — the client's reconnect retry owns those
        for d in (header.get("_shm") or ()):
            if isinstance(d, dict):
                name = str(d.get("name") or "")
                if not os.path.exists(
                        os.path.join(protocol.SHM_DIR, name)):
                    return skip("shm-gone")
        payloads = [base64.b64decode(s) for s in p64]
        # dequeue-time expiry: the budget
        # kept draining while this entry sat in the WAL across the
        # crash — a dead budget is skipped as doomed work, a live one
        # is re-stamped with what actually remains for the forward hop
        budget = header.get("budget_ms")
        t_wal = entry.get("t_wal")
        if (isinstance(budget, (int, float))
                and not isinstance(budget, bool)
                and isinstance(t_wal, (int, float))):
            rem_ms = float(budget) - (time.time() - float(t_wal)) * 1e3
            if rem_ms <= 0.0:
                with self._lock:
                    self._expired += 1
                obs_metrics.inc("serve.expired")
                journal.emit(
                    "serve_request_expired", site="router",
                    where="wal_replay", kernel=kernel, bucket=bucket,
                    request=rid, request_id=req_id, tenant=tenant,
                )
                return skip("expired")
            header = protocol.stamp_budget(
                header, time.monotonic() + rem_ms / 1000.0)
        order = self._order(bucket)
        if not order:
            return skip("no-live-worker")
        try:
            prior = int(header.get("replay") or 0)
        except (TypeError, ValueError):
            prior = 0
        header["replay"] = prior + 1
        idx = order[0]
        journal.emit(
            "serve_request_replayed", via="wal", kernel=kernel,
            bucket=bucket, request=rid, request_id=req_id,
            to_worker=idx, tenant=tenant,
        )
        resp, out_payloads = None, ()
        for hop in range(2):
            try:
                resp, out_payloads = self._forward(idx, header,
                                                   payloads)
            except (OSError, protocol.ProtocolError):
                if self._health is not None:
                    self._health.note_transport_loss(idx)
                sibling = next((j for j in order if j != idx), None)
                if hop == 1 or sibling is None:
                    return skip("workers-unreachable")
                idx = sibling
                continue
            break
        with self._lock:
            self._routed += 1
            self._routed_to[idx] += 1
        obs_metrics.inc("serve.routed")
        journal.emit(
            "serve_route", kernel=kernel, bucket=bucket,
            request=rid, request_id=req_id, worker=idx,
            tenant=tenant,
            priority=header.get("priority") or "interactive",
            spilled_from=None, ok=bool(resp.get("ok")),
            wal_replay=True,
        )
        if req_id is not None:
            with self._lock:
                self._stash[req_id] = {
                    "resp": resp, "payloads": out_payloads,
                    "worker": idx, "t": time.perf_counter(),
                }
        else:
            # no request_id = no retry can ever claim it: the work
            # is done (and journaled); free any response segments
            self._drop_stashed({"resp": resp})
        self._wal.ack(key)

    def _take_stash(self, req_id: str):
        """Claim (and expire) stashed replay results. Expiry mirrors
        the reply()-to-a-gone-client path: response segments no one
        will map must not wait for an aged sweep."""
        now = time.perf_counter()
        expired = []
        with self._lock:
            hit = self._stash.pop(req_id, None)
            for k in [k for k, v in self._stash.items()
                      if now - v["t"] > self._stash_ttl_s]:
                expired.append(self._stash.pop(k))
        for v in expired:
            self._drop_stashed(v)
        return hit

    def _drop_stashed(self, hit):
        resp = (hit or {}).get("resp") or {}
        for d in (resp.get("_shm") or ()):
            if isinstance(d, dict):
                protocol.unlink_shm(d.get("name"))

    def worker_draining(self, idx: int) -> bool:
        with self._lock:
            return idx in self._draining

    def set_worker_down(self, idx: int, down: bool,
                        quarantined: bool = False):
        """Health-manager hook: a worker left (or rejoined) the ring.
        The idle connection pool is flushed BOTH ways — a dead
        worker's pooled sockets are corpses, and a respawned worker
        on the same socket path must never be spoken to through a
        connection to its predecessor."""
        with self._lock:
            if down:
                self._down.add(idx)
                if quarantined:
                    self._quarantined.add(idx)
            else:
                self._down.discard(idx)
                self._quarantined.discard(idx)
                self._cooldown.pop(idx, None)
        self._pools[idx].close_all()
        self._recompute_level()

    def _recompute_level(self):
        """Degradation level from the down set, journaled on CHANGE
        (``fleet_degraded``): ``degraded`` = at least one worker out
        but every bucket still has its home or sibling; ``critical``
        = some ring-adjacent pair is fully out, i.e. some buckets'
        home AND sibling are both gone and the router is shedding
        their load by priority class."""
        n = len(self.workers)
        with self._lock:
            down = set(self._down)
            quarantined = sorted(self._quarantined)
            if not down:
                level = "ok"
            elif len(down) >= n or any(
                    (i + 1) % n in down for i in down):
                level = "critical"
            else:
                level = "degraded"
            changed, self._level = level != self._level, level
        if not changed:
            return
        hint = (self._health.retry_hint(down) if self._health
                and down else 0.0)
        journal.emit(
            "fleet_degraded", level=level, down=sorted(down),
            quarantined=quarantined, n_workers=n,
            retry_after_s=hint,
        )
        print(f"# route: fleet {level.upper()}"
              + (f" - workers {sorted(down)} out of the ring"
                 f" (retry hint {hint}s)" if down else
                 " - all workers restored"), file=sys.stderr)

    def _shed(self, conn_reply, rid, req_id, kernel, bucket, tenant,
              priority, down):
        """Degradation shedding: answer the client honestly NOW —
        ``retry_after_s`` derived from the respawn backoff — instead
        of timing it out against workers that cannot answer."""
        retry = (self._health.retry_hint(down) if self._health
                 else max(0.1, DEFAULT_COOLDOWN_S / 10))
        with self._lock:
            self._rejected += 1
        obs_metrics.inc("serve.rejected")
        journal.emit(
            "serve_rejected", kernel=kernel, request=rid,
            request_id=req_id, reason="fleet_degraded",
            bucket=bucket, tenant=tenant, priority=priority,
            down=sorted(down), retry_after_s=retry,
        )
        conn_reply({
            "v": protocol.VERSION, "id": rid, "ok": False,
            "kind": "overloaded", "degraded": True,
            "retry_after_s": retry,
            "error": (f"fleet degraded: workers {sorted(down)} down; "
                      f"{priority} {kernel} shed - retry after "
                      f"{retry}s"),
        })

    def _refuse_infeasible(self, conn_reply, rid, req_id, kernel,
                           bucket, tenant, priority):
        """Admission-time deadline triage: a request whose remaining
        budget is already zero
        cannot possibly make it — refuse it at the front door instead
        of spending a WAL fsync and a worker queue slot on doomed
        work. The hint is honest: 0.0, because a retry is welcome
        immediately — but only with a FRESH budget (the client maps
        this to ``ServeExpired``, which deliberately does not
        auto-retry the same shrinking one)."""
        with self._lock:
            self._infeasible += 1
        obs_metrics.inc("serve.deadline_infeasible")
        journal.emit(
            "serve_deadline_infeasible", kernel=kernel, bucket=bucket,
            request=rid, request_id=req_id, tenant=tenant,
            priority=priority, retry_after_s=0.0,
        )
        conn_reply({
            "v": protocol.VERSION, "id": rid, "ok": False,
            "kind": "deadline_infeasible", "retry_after_s": 0.0,
            "error": ("deadline infeasible: request budget already "
                      "spent before admission"),
        })

    def _expire_route(self, conn_reply, rid, req_id, kernel, bucket,
                      tenant, where):
        """Dequeue-time expiry: the
        budget died while the request waited inside the router —
        answer ``expired`` instead of dispatching doomed work."""
        with self._lock:
            self._expired += 1
        obs_metrics.inc("serve.expired")
        journal.emit(
            "serve_request_expired", site="router", where=where,
            kernel=kernel, bucket=bucket, request=rid,
            request_id=req_id, tenant=tenant,
        )
        conn_reply({
            "v": protocol.VERSION, "id": rid, "ok": False,
            "kind": "expired",
            "error": f"deadline expired before forward ({where})",
        })

    # -------------------------------------------------------------- #
    # front side                                                     #
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
                    conn.send(self._stats())
                elif op == "stats":
                    conn.send(self._stats_fleet())
                elif op == "dispatch":
                    self._route(conn, header, payloads)
                elif op in ("drain", "undrain"):
                    conn.send(self._control(op, header))
                else:
                    conn.send({"v": protocol.VERSION,
                               "id": header.get("id"), "ok": False,
                               "kind": "error",
                               "error": f"unknown op {op!r}"})
        except (protocol.ProtocolError, OSError):
            pass  # poisoned/hung-up FRONT connection: only it dies
        finally:
            try:
                conn.sock.close()
            except OSError:
                pass

    def _stats(self) -> dict:
        meta = self._worker_meta()
        health = self._health
        hrows = ([health.row(i) for i in range(len(self.workers))]
                 if health is not None else
                 [{} for _ in self.workers])
        now = time.perf_counter()
        with self._lock:
            rows = [
                {
                    "socket": w,
                    "draining": i in self._draining,
                    "cooling": self._cooldown.get(i, 0.0) > now,
                    "down": i in self._down,
                    "inflight": self._inflight[i],
                    "routed": self._routed_to[i],
                    # liveness / restart-count / quarantine columns
                    # (None without a
                    # health manager — a bare `--worker` router)
                    "state": hrows[i].get("state"),
                    "restarts": hrows[i].get("restarts"),
                    "quarantined": bool(hrows[i].get("quarantined")),
                }
                for i, w in enumerate(self.workers)
            ]
            level = self._level
            return {
                "op": "pong", "ok": True, "v": protocol.VERSION,
                "role": "router", "pid": os.getpid(),
                "workers": rows, "n_workers": len(self.workers),
                "level": level,
                "routed": self._routed, "spilled": self._spilled,
                "throttled": self._throttled,
                "rejected": self._rejected,
                "hedged": self._hedged, "expired": self._expired,
                "infeasible": self._infeasible,
                # lane negotiation happens against the FRONT socket:
                # relay what the workers advertised (None until one
                # answered = clients stay inline, the safe default)
                "lanes": self._lanes_cache or ["inline"],
                "shm_min_bytes": self._shm_min_cache,
                # relayed like lanes/shm_min_bytes: the fleet is
                # traced when its workers tag their journals (None
                # passes through until one answered — "unknown" must
                # not masquerade as an untraced fleet)
                "request_trace": self._req_trace_cache,
                "bytes_copied": self._bytes_copied,
                "uptime_s": round(time.time() - self._t0, 3),
                # loadgen --serve stamps its verdicts with these —
                # the fleet's device identity is its workers'
                "device_kind": meta["device_kind"],
                "torch": meta["torch"],
                "cuda": meta["cuda"],
            }

    def _stats_fleet(self) -> dict:
        """The read-only ``stats`` op, fleet view: the router's own
        pong + live metrics snapshot,
        plus one upstream ``stats`` round trip per non-down worker
        (the ``_worker_meta`` pool pattern — acquire, frame, release,
        poison on transport failure) aggregated under ``worker_stats``
        (index-aligned with ``workers``; None for a worker that is
        down or did not answer) and summed into one ``fleet`` row.
        Touches only ``self._lock`` between fan-outs — a wedged
        worker costs its own row, never the whole view."""
        base = self._stats()
        base.update(
            op="stats",
            metrics=obs_metrics.snapshot(),
            last_snapshot_age_s=obs_metrics.last_flush_age_s(),
        )
        with self._lock:
            down = set(self._down)
        wstats: list = []
        for idx in range(len(self.workers)):
            if idx in down:
                wstats.append(None)
                continue
            pool = self._pools[idx]
            sock = None
            ok = False
            row = None
            try:
                sock = pool.acquire()
                protocol.send_frame(
                    sock, {"v": protocol.VERSION, "op": "stats"}
                )
                frame = protocol.recv_frame(sock)
                if frame is not None and frame[0].get("ok"):
                    row = frame[0]
                    ok = True
            except (OSError, protocol.ProtocolError):
                row = None
            finally:
                if sock is not None:
                    pool.release(sock, poisoned=not ok)
            wstats.append(row)
        fleet = {"served": 0, "rejected": 0, "requeued": 0,
                 "depth": 0, "inflight": 0, "bytes_copied": 0,
                 "answering": 0}
        for row in wstats:
            if not isinstance(row, dict):
                continue
            fleet["answering"] += 1
            for k in ("served", "rejected", "requeued", "depth",
                      "inflight", "bytes_copied"):
                v = row.get(k)
                if isinstance(v, (int, float)):
                    fleet[k] += v
        base["worker_stats"] = wstats
        base["fleet"] = fleet
        return base

    def _worker_meta(self) -> dict:
        """device_kind / torch / CUDA versions borrowed from the first worker
        that knows them (workers resolve both lazily at their first
        dispatch). Cached once ANY field resolves — the same
        predicate the store uses — and unresolved retries are
        rate-limited to one fan-out per second: a status/drain poll
        loop pinging the front socket 5x/s must not multiply into
        N upstream pings each. Meta pings skip draining workers and
        bypass the in-flight accounting drain waits on."""
        now = time.perf_counter()
        with self._lock:
            if (self._meta["torch"] is not None
                    or self._meta["device_kind"] is not None):
                return dict(self._meta)
            if now < self._meta_next_try:
                return dict(self._meta)
            self._meta_next_try = now + 1.0
            candidates = [i for i in range(len(self.workers))
                          if i not in self._draining]
        for idx in candidates:
            pool = self._pools[idx]
            sock = None
            ok = False
            try:
                sock = pool.acquire()
                protocol.send_frame(
                    sock, {"v": protocol.VERSION, "op": "ping"}
                )
                frame = protocol.recv_frame(sock)
                ok = frame is not None
            except (OSError, protocol.ProtocolError):
                continue
            finally:
                if sock is not None:
                    pool.release(sock, poisoned=not ok)
            if not ok:
                continue
            header = frame[0]
            with self._lock:
                if self._lanes_cache is None:
                    # lanes are static per worker process — cache them
                    # off the FIRST pong, before any dispatch resolves
                    # device_kind, so a client's negotiation ping gets
                    # an answer immediately
                    lanes = header.get("lanes")
                    self._lanes_cache = (
                        [str(x) for x in lanes]
                        if isinstance(lanes, list) else ["inline"]
                    )
                    self._shm_min_cache = header.get("shm_min_bytes")
                    self._req_trace_cache = bool(
                        header.get("request_trace")
                    )
            if header.get("device_kind") or header.get("torch"):
                with self._lock:
                    self._meta = {
                        "device_kind": header.get("device_kind"),
                        "torch": header.get("torch"),
                        "cuda": header.get("cuda"),
                    }
                break
        with self._lock:
            return dict(self._meta)

    def _control(self, op: str, header: dict) -> dict:
        idx = header.get("worker")
        if not isinstance(idx, int) or isinstance(idx, bool) or \
                not 0 <= idx < len(self.workers):
            return {"v": protocol.VERSION, "ok": False, "kind": "error",
                    "error": f"bad worker index {idx!r} "
                             f"(fleet has {len(self.workers)})"}
        with self._lock:
            if op == "drain":
                self._draining.add(idx)
            else:
                self._draining.discard(idx)
                self._cooldown.pop(idx, None)
            inflight = self._inflight[idx]
        if op == "undrain":
            # undrain is the operator's "config changed" signal: a
            # promoted adaptive bucket table lands as a rewritten file
            # behind the unchanged TPKT_SERVE_BUCKETS path, and the
            # router hashes buckets itself (spec_stubs/bucket_for) —
            # re-read it NOW or keep routing on yesterday's avatars.
            # A malformed table
            # answers as a control-channel error (the __init__
            # fail-fast rule, surfaced to the operator who undrained)
            # and the old parsed table stays in effect.
            try:
                bucketing.reload()
            except (OSError, ValueError) as e:
                return {"v": protocol.VERSION, "ok": False,
                        "kind": "error",
                        "error": f"undrain refused: TPKT_SERVE_BUCKETS "
                                 f"reload failed: {e}"}
        if op == "undrain" and self._health is not None:
            # the operator restored this worker on purpose: forget its
            # crash window and quarantine — the next probe pass
            # re-verifies it (and respawns it if it is actually dead)
            self._health.reset(idx)
        # flush the worker's idle connection pool both ways: drained
        # workers get stopped (their pooled sockets go stale), and an
        # undrained worker is usually a FRESH process on the same
        # socket path — forwarding on a stale socket would read as a
        # spurious transport spill against a healthy restored worker
        self._pools[idx].close_all()
        journal.emit(
            "serve_drain", worker=idx, socket=self.workers[idx],
            phase="begin" if op == "drain" else "undrain",
            inflight=inflight,
        )
        print(f"# route: worker {idx} "
              + ("DRAINING" if op == "drain" else "restored")
              + f" ({inflight} in flight)", file=sys.stderr)
        return {"v": protocol.VERSION, "ok": True, "worker": idx,
                "draining": op == "drain", "inflight": inflight}

    # -------------------------------------------------------------- #
    # admission: per-tenant token buckets, priority reserve          #
    # -------------------------------------------------------------- #

    def _admit_tenant(self, tenant: str, priority: str):
        """(admitted, retry_after_s). Quotas off (rate <= 0) admit
        everything. A batch request must leave 1 + burst/2 tokens —
        the reserve interactive traffic draws on — so background load
        yields first when a tenant runs hot."""
        rate = self.tenant_rate
        if rate <= 0:
            return True, 0.0
        need = 1.0 if priority == "interactive" else \
            1.0 + self.tenant_burst / 2.0
        now = time.perf_counter()
        with self._lock:
            tokens, last = self._tenants.get(
                tenant, (self.tenant_burst, now)
            )
            tokens = min(self.tenant_burst,
                         tokens + (now - last) * rate)
            if tokens >= need:
                self._tenants[tenant] = [tokens - 1.0, now]
                return True, 0.0
            self._tenants[tenant] = [tokens, now]
        retry = min(MAX_RETRY_HINT_S,
                    max(0.05, (need - tokens) / rate))
        return False, round(retry, 3)

    # -------------------------------------------------------------- #
    # routing                                                        #
    # -------------------------------------------------------------- #

    def _order(self, bucket: str) -> list:
        """[primary, spill_sibling, ...] for one bucket: the md5 ring
        with DOWN (dead/quarantined, see ``serve/health.py``)
        and draining workers removed and cooling (recently wedged)
        workers deferred to last resort. Falls back to the raw
        draining/cooling members when nothing is warm — routing
        SOMEWHERE loudly beats rejecting everything silently — but
        never to a down worker: the connection cannot succeed, and
        the shed path owes the client an honest answer instead. An
        EMPTY return means every ring member is down: the caller
        sheds."""
        ring = ring_order(bucket, len(self.workers))
        now = time.perf_counter()
        with self._lock:
            draining = set(self._draining)
            down = set(self._down)
            cooling = {i for i, t in self._cooldown.items() if t > now}
        alive = [i for i in ring if i not in draining
                 and i not in down]
        warm = [i for i in alive if i not in cooling]
        ordered = warm + [i for i in alive if i in cooling]
        if ordered:
            return ordered
        return [i for i in ring if i not in down]

    def _forward(self, idx: int, header: dict, payloads):
        """One upstream round trip; raises OSError/ProtocolError on
        transport loss. In-flight accounting is what ``drain`` waits
        on."""
        with self._lock:
            self._inflight[idx] += 1
        pool = self._pools[idx]
        sock = None
        ok = False
        t0 = time.perf_counter()
        try:
            sock = pool.acquire()
            protocol.send_frame(sock, header, payloads)
            frame = protocol.recv_frame(sock)
            if frame is None:
                raise protocol.ProtocolError(
                    "worker hung up mid-request"
                )
            ok = True
            self._note_fwd_wall(time.perf_counter() - t0)
            return frame
        finally:
            if sock is not None:
                pool.release(sock, poisoned=not ok)
            with self._lock:
                self._inflight[idx] -= 1

    # -------------------------------------------------------------- #
    # hedged dispatch                                              #
    # -------------------------------------------------------------- #

    def _note_fwd_wall(self, wall: float):
        """One completed forward's wall into the hedge histogram (and
        the metrics snapshot, where operators read the same tail)."""
        obs_metrics.observe("serve.forward_wall_s", wall)
        b = obs_metrics.bucket_index(wall)
        with self._lock:
            h = self._fwd_walls
            h[0] += 1
            if wall > h[1]:
                h[1] = wall
            h[2][b] = h[2].get(b, 0) + 1

    def _hedge_threshold_s(self):
        """The elapsed time past which a forward is hedged: the
        ``TPKT_ROUTE_HEDGE_PCTL``-th percentile of this router's OWN
        completed forward walls (count-weighted over the shared
        log buckets). None = hedging off, a one-worker fleet (no
        sibling to hedge to), or not enough samples to trust a tail
        estimate yet."""
        if self.hedge_pctl <= 0 or len(self.workers) < 2:
            return None
        with self._lock:
            count, mx, buckets = self._fwd_walls
            if count < HEDGE_MIN_SAMPLES:
                return None
            buckets = dict(buckets)
        return obs_metrics.percentiles(
            count, mx, buckets,
            qs=(min(self.hedge_pctl, 100.0) / 100.0,),
        )[0]

    def _hedge_frac_ok(self) -> bool:
        """The hedge-budget cap: hedging past
        ``TPKT_ROUTE_HEDGE_MAX_FRAC`` of routed traffic would let a
        fleet-wide slowdown double its own load — exactly when extra
        load hurts most."""
        with self._lock:
            return (self._hedged + 1
                    <= self.hedge_max_frac * max(1, self._routed))

    def _start_attempt(self, idx: int, header, payloads, cond):
        att = _Attempt(idx, cond)

        def run():
            with self._lock:
                self._inflight[idx] += 1
            pool = self._pools[idx]
            sock = None
            ok = False
            t0 = time.perf_counter()
            try:
                with att.alock:
                    if att.aborted:
                        raise OSError("attempt aborted before start")
                    sock = pool.acquire()
                    att.sock = sock
                protocol.send_frame(sock, header, payloads)
                frame = protocol.recv_frame(sock)
                if frame is None:
                    raise protocol.ProtocolError(
                        "worker hung up mid-request"
                    )
                att.resp, att.payloads = frame
                ok = True
                self._note_fwd_wall(time.perf_counter() - t0)
            except (OSError, protocol.ProtocolError) as e:
                att.exc = e
            finally:
                with att.alock:
                    att.sock = None
                    if sock is not None:
                        pool.release(sock,
                                     poisoned=not ok or att.aborted)
                with self._lock:
                    self._inflight[idx] -= 1
                with cond:
                    att.done = True
                    cond.notify_all()

        threading.Thread(target=run, daemon=True,
                         name="route-attempt").start()
        return att

    def _cancel_upstream(self, idx: int, req_id, kernel=None):
        """Issue the best-effort ``cancel`` op for the hedge loser:
        a queued loser is dropped
        before it wastes a dispatch, an in-flight one has its send
        suppressed. Failure is fine — cancel is advisory, the replay
        idempotency contract already makes the duplicate safe."""
        if req_id is None:
            return
        obs_metrics.inc("serve.cancels_sent")
        journal.emit(
            "serve_cancelled", site="router", to_worker=idx,
            kernel=kernel, request_id=req_id,
        )
        pool = self._pools[idx]
        sock = None
        ok = False
        try:
            sock = pool.acquire()
            protocol.send_frame(sock, {
                "v": protocol.VERSION, "op": "cancel",
                "request_id": req_id,
            })
            ok = protocol.recv_frame(sock) is not None
        except (OSError, protocol.ProtocolError):
            pass
        finally:
            if sock is not None:
                pool.release(sock, poisoned=not ok)

    def _forward_hedged(self, idx: int, order, header, payloads,
                        deadline_at, kernel, bucket, rid, req_id,
                        tenant):
        """The primary forward with tail-tolerant hedging: if the
        primary outlives the fleet's own forward-wall percentile
        (``_hedge_threshold_s``) and budget remains, the SAME
        request_id is re-issued to the ring sibling stamped as a
        replay (the PR-14 idempotency contract — kernels are pure),
        first response wins, the loser is cancelled best-effort.
        Returns ``(resp, payloads, winner_idx, hedged)``; raises like
        ``_forward`` only when no hedge was launched."""
        hdr = protocol.stamp_budget(header, deadline_at)
        threshold = self._hedge_threshold_s()
        sibling = next((j for j in order if j != idx), None)
        if (threshold is None or sibling is None or req_id is None
                or not self._hedge_frac_ok()):
            resp, out_payloads = self._forward(idx, hdr, payloads)
            return resp, out_payloads, idx, False
        cond = threading.Condition()
        primary = self._start_attempt(idx, hdr, payloads, cond)
        with cond:
            end = time.perf_counter() + threshold
            while not primary.done:
                rem = end - time.perf_counter()
                if rem <= 0:
                    break
                cond.wait(rem)
        hedge = None
        if not primary.done and (
                deadline_at is None
                or protocol.budget_ms_remaining(deadline_at) > 0.0):
            h_hdr = dict(header)
            try:
                prior = int(h_hdr.get("replay") or 0)
            except (TypeError, ValueError):
                prior = 0
            h_hdr["replay"] = prior + 1
            h_hdr = protocol.stamp_budget(h_hdr, deadline_at)
            with self._lock:
                self._hedged += 1
            obs_metrics.inc("serve.hedges")
            journal.emit(
                "serve_hedged", kernel=kernel, bucket=bucket,
                request=rid, request_id=req_id, from_worker=idx,
                to_worker=sibling, tenant=tenant,
                threshold_s=round(threshold, 6),
            )
            hedge = self._start_attempt(sibling, h_hdr, payloads, cond)
        attempts = [primary] + ([hedge] if hedge is not None else [])

        def _settled():
            done = [a for a in attempts if a.done]
            if any(a.exc is None and (a.resp or {}).get("ok")
                   for a in done):
                # first OK response wins outright; an early honest
                # error waits for the race mate — it might still win
                return True
            return len(done) == len(attempts)

        with cond:
            while not _settled():
                cond.wait(1.0)
            done = [a for a in attempts if a.done]
        winner = next((a for a in done
                       if a.exc is None and (a.resp or {}).get("ok")),
                      None)
        if winner is None:
            winner = next((a for a in done if a.exc is None), done[0])
        for a in attempts:
            if a is winner:
                continue
            if not a.done:
                # cancel FIRST (a queued loser is dropped before it
                # wastes a dispatch), then abort the blocked recv so
                # its suppressed reply cannot hold the thread until
                # the pool timeout
                self._cancel_upstream(a.idx, req_id, kernel=kernel)
                a.abort()
            elif a.exc is None:
                # the loser finished anyway: its response segments
                # will never be mapped by anyone — free them now
                self._drop_stashed({"resp": a.resp})
        if winner.exc is not None:
            if hedge is None:
                raise winner.exc
            resp = {"v": protocol.VERSION, "id": rid, "ok": False,
                    "kind": "error",
                    "error": (f"workers {idx},{sibling} unreachable "
                              f"after hedge: {winner.exc!r}")}
            return resp, (), winner.idx, True
        return winner.resp, winner.payloads, winner.idx, \
            hedge is not None

    def _count_copied(self, kernel: str, nbytes: int):
        """Relayed inline payload bytes — the router's share of the
        ``serve.bytes_copied`` story. Shm-lane requests relay only
        descriptors, so the fleet front-end stops being O(tensor)."""
        if not nbytes:
            return
        obs_metrics.inc(f"serve.bytes_copied.{kernel}", nbytes)
        with self._lock:
            self._bytes_copied += nbytes

    def _route(self, conn: _Conn, header: dict, payloads):
        rid = header.get("id")
        # the client-minted causal id rides the relayed header
        # untouched; the router only TAGS its own routing evidence
        # with it so cross-process timelines join
        req_id = header.get("request_id")
        req_id = str(req_id) if req_id is not None else None

        def reply(h, p=()):
            try:
                conn.send(h, p)
            except (OSError, protocol.ProtocolError):
                # client gone; the decision is journaled anyway — but
                # a worker's response segments no one will ever map
                # must not wait for its aged sweep
                for d in (h.get("_shm") or ()):
                    if isinstance(d, dict):
                        protocol.unlink_shm(d.get("name"))

        tenant = header.get("tenant") or "-"
        priority = header.get("priority") or "interactive"
        try:
            if priority not in PRIORITIES:
                raise ValueError(
                    f"unknown priority {priority!r}; known: "
                    f"{PRIORITIES}"
                )
            kernel = header["kernel"]
            statics = dict(header.get("statics") or {})
            # layout-only stubs: routing needs shapes and dtypes, not
            # data — the router never reads (with the shm lane, never
            # even receives) a payload byte. Byte-count validation is
            # the worker's unpack, one hop later.
            arrays = bucketing.spec_stubs(header.get("args") or [])
            # structural _shm validation at the front door: a
            # malformed descriptor must be a bad request HERE, not a
            # worker-side ProtocolError the spill logic would misread
            # as transport loss against two healthy workers
            protocol.check_shm_descs(header, len(payloads))
            spec, _how = bucketing.bucket_for(kernel, arrays, statics)
            bucket = bucketing.bucket_id(kernel, spec, statics, arrays)
        except (KeyError, ValueError, TypeError, AttributeError,
                protocol.ProtocolError) as e:
            # malformed dispatches die HERE, at the front door — a
            # worker never sees a request the router could not hash
            reply({"v": protocol.VERSION, "id": rid, "ok": False,
                   "kind": "error", "error": f"bad request: {e}"})
            return
        # deadline triage at admission:
        # the wire budget becomes a router-local monotonic instant; a
        # request that already cannot make it is refused NOW — before
        # it burns tenant tokens, a WAL fsync, or a worker queue slot
        deadline_at = protocol.deadline_from_header(header)
        if (deadline_at is not None
                and protocol.budget_ms_remaining(deadline_at) <= 0.0):
            self._refuse_infeasible(reply, rid, req_id, kernel,
                                    bucket, tenant, priority)
            return
        if req_id is not None and self._stash:
            # a reconnecting client retrying a request the WAL replay
            # already executed: answer from the stash — the worker saw
            # this request_id exactly once
            hit = self._take_stash(req_id)
            if hit is not None:
                resp = dict(hit["resp"])
                resp["id"] = rid
                out_payloads = hit["payloads"]
                with self._lock:
                    self._routed += 1
                    self._routed_to[hit["worker"]] += 1
                obs_metrics.inc("serve.routed")
                self._count_copied(
                    kernel, sum(len(p) for p in out_payloads)
                )
                journal.emit(
                    "serve_route", kernel=kernel, bucket=bucket,
                    request=rid, request_id=req_id,
                    worker=hit["worker"], tenant=tenant,
                    priority=priority, spilled_from=None,
                    ok=bool(resp.get("ok")), wal_stash=True,
                )
                reply(resp, out_payloads)
                return
        admitted, retry = self._admit_tenant(tenant, priority)
        if not admitted:
            with self._lock:
                self._throttled += 1
            obs_metrics.inc("serve.throttled")
            journal.emit(
                "serve_tenant_throttled", tenant=tenant,
                priority=priority, kernel=kernel, request=rid,
                request_id=req_id,
                retry_after_s=retry,
            )
            reply({"v": protocol.VERSION, "id": rid, "ok": False,
                   "kind": "overloaded", "throttled": True,
                   "tenant": tenant, "retry_after_s": retry,
                   "error": (f"tenant {tenant!r} over quota "
                             f"({priority}); retry after {retry}s")})
            return
        # durable admission: the accepted request becomes crash-proof
        # HERE — fsync'd into router.wal before any forward — and the
        # kill_router chaos injection point sits exactly between the
        # append and the forward, so a fired kill proves the replay
        wal_key = self._wal_record(header, payloads, kernel, bucket)
        faults.router_fault()
        try:
            order = self._order(bucket)
            with self._lock:
                down = set(self._down)
            # graceful degradation: with
            # the bucket's home AND sibling both out, batch load sheds
            # FIRST (an honest retry_after_s derived from the respawn
            # backoff) while interactive traffic keeps riding whatever
            # ring members remain; nothing alive at all sheds everything
            # — a client told when to come back beats a client timing out
            home_pair = set(ring_order(bucket, len(self.workers))[:2])
            if not order or (priority == "batch" and down
                             and home_pair <= down):
                self._shed(reply, rid, req_id, kernel, bucket, tenant,
                           priority, down or home_pair)
                return
            idx = order[0]
            spilled_from = None
            reason = None
            dead = False
            hedged = False
            for hop in range(2):
                dead = False
                if (deadline_at is not None
                        and protocol.budget_ms_remaining(
                            deadline_at) <= 0.0):
                    # dequeue-time expiry: the budget died while this
                    # request waited (spill pacing, a slow first hop)
                    # — expire it instead of dispatching doomed work
                    self._expire_route(reply, rid, req_id, kernel,
                                       bucket, tenant, where="route")
                    return
                try:
                    if hop == 0:
                        resp, out_payloads, idx, hedged = \
                            self._forward_hedged(
                                idx, order, header, payloads,
                                deadline_at, kernel=kernel,
                                bucket=bucket, rid=rid,
                                req_id=req_id, tenant=tenant)
                    else:
                        resp, out_payloads = self._forward(
                            idx,
                            protocol.stamp_budget(header,
                                                  deadline_at),
                            payloads)
                except (OSError, protocol.ProtocolError) as e:
                    resp, out_payloads = None, ()
                    reason = "transport"
                    err = e
                    # dead-vs-transient discrimination at the moment of
                    # failure: a free pidfile flock is a death
                    # certificate, and declaring it NOW (sweep, respawn
                    # scheduling, ring removal) is what turns in-flight
                    # loss into a replay instead of a client error
                    dead = (self._health.note_transport_loss(idx)
                            if self._health is not None else False)
                else:
                    if resp.get("ok"):
                        reason = None
                    elif resp.get("kind") == "overloaded":
                        reason = "overloaded"
                    elif resp.get("kind") == "wedged":
                        reason = "wedged"
                        with self._lock:
                            self._cooldown[idx] = (time.perf_counter()
                                                   + self.cooldown_s)
                        print(f"# route: worker {idx} WEDGED on "
                              f"{kernel} - cooling "
                              f"{self.cooldown_s:.0f}s", file=sys.stderr)
                    else:
                        reason = None  # an honest dispatch error: relay it
                    if hedged:
                        # the hedge already delivered this request_id
                        # to the ring sibling — first-response-wins IS
                        # the failover; never dispatch a third copy
                        reason = None
                if reason is None:
                    break
                sibling = next((j for j in order if j != idx), None)
                if hop == 1 or sibling is None:
                    if resp is None:
                        if dead:
                            # the last candidate DIED under this request:
                            # answer like the shed path — the worker is
                            # being respawned, and "come back in Ns" is
                            # the honest reply, not a hard error
                            self._shed(reply, rid, req_id, kernel, bucket,
                                       tenant, priority, {idx})
                            return
                        # no (further) sibling: surface the failure honestly
                        resp = {"v": protocol.VERSION, "id": rid,
                                "ok": False, "kind": "error",
                                "error": (f"worker {idx} unreachable: "
                                          f"{err!r}")}
                        with self._lock:
                            self._rejected += 1
                    break
                with self._lock:
                    self._spilled += 1
                obs_metrics.inc("serve.spills")
                journal.emit(
                    "serve_spill", kernel=kernel, bucket=bucket,
                    request=rid, request_id=req_id,
                    from_worker=idx, to_worker=sibling,
                    reason=reason, tenant=tenant,
                )
                if dead:
                    # in-flight recovery:
                    # the home worker DIED holding this accepted request —
                    # re-route it ONCE to the ring sibling, stamped as a
                    # replay. The `replay` header is the idempotency
                    # contract (protocol.py): the dead worker may already
                    # have executed it, kernels are pure, the request_id
                    # stays the same, so every consumer counts it once.
                    journal.emit(
                        "serve_request_replayed", kernel=kernel,
                        bucket=bucket, request=rid, request_id=req_id,
                        from_worker=idx, to_worker=sibling, tenant=tenant,
                    )
                    header = dict(header)
                    try:
                        prior = int(header.get("replay") or 0)
                    except (TypeError, ValueError):
                        prior = 0
                    header["replay"] = prior + 1
                spilled_from, idx = idx, sibling
            with self._lock:
                self._routed += 1
                self._routed_to[idx] += 1
            obs_metrics.inc("serve.routed")
            # inline payload bytes this request made the router relay
            # (request upstream + response downstream); an shm-lane
            # request contributes 0 — only names crossed this process
            self._count_copied(
                kernel,
                sum(len(p) for p in payloads)
                + sum(len(p) for p in out_payloads),
            )
            journal.emit(
                "serve_route", kernel=kernel, bucket=bucket, request=rid,
                request_id=req_id,
                worker=idx, tenant=tenant, priority=priority,
                spilled_from=spilled_from,
                ok=bool(resp.get("ok")),
            )
            reply(resp, out_payloads)
        finally:
            # ANY terminal outcome (reply sent, shed, relayed error)
            # settles the entry; only a crash leaves it for replay
            if wal_key is not None and self._wal is not None:
                self._wal.ack(wal_key)


# ------------------------------------------------------------------ #
# CLI entry (python -m tpukernels_torch.serve.router)                #
# ------------------------------------------------------------------ #

def main(argv=None):
    import signal

    from tpukernels_torch import _cachedir
    from tpukernels_torch.serve import fleet as serve_fleet
    from tpukernels_torch.serve import health as serve_health
    from tpukernels_torch.serve import proc

    argv = sys.argv[1:] if argv is None else list(argv)
    socket_path = None
    workers: list = []
    it = iter(argv)
    try:
        for a in it:
            if a == "--socket":
                socket_path = next(it)
            elif a == "--worker":
                workers.append(next(it))
            elif a in ("-h", "--help"):
                print(__doc__, file=sys.stderr)
                return 0
            else:
                print(__doc__, file=sys.stderr)
                print(f"route: unknown argument {a!r}", file=sys.stderr)
                return 2
    except StopIteration:
        print(f"route: {a} needs a value", file=sys.stderr)
        return 2
    if socket_path is None:
        socket_path = serve_fleet.front_socket_path()
    if not workers:
        print("route: at least one --worker SOCKET is required",
              file=sys.stderr)
        return 2

    # an unattended router's evidence lands in a dated journal in the
    # serve directory unless the operator chose one (the daemon's rule)
    if os.environ.get("TPKT_HEALTH_JOURNAL") is None:
        os.environ["TPKT_HEALTH_JOURNAL"] = _cachedir.serve_dir()
    try:
        router = Router(socket_path, workers)
    except (ValueError, OSError) as e:
        print(f"route: {e}", file=sys.stderr)
        return 2
    try:
        pidfile = proc.hold_pidfile(serve_fleet.router_pidfile_path())
    except RuntimeError as e:
        print(f"route: {e}", file=sys.stderr)
        return 3

    from tpukernels_torch.obs import scaling as obs_scaling

    # an env-derived stamp only: the router imports no torch and never
    # touches the card (the workers stamp their own)
    obs_scaling.emit_inventory("serve_router")
    # the self-healing loop rides in this process: worker pidfiles live
    # beside their sockets, and respawns reuse the exact dir/socket the
    # ring already points at. TPKT_FLEET_PROBE_S=0 disables detection
    # and respawn.
    try:
        hm = serve_health.HealthManager(workers, repo=os.getcwd(),
                                        router=router)
    except ValueError as e:
        print(f"route: {e}", file=sys.stderr)
        return 2
    router.attach_health(hm)
    hm.start()
    # durable admission: open (recover) the WAL now the pidfile is
    # held, and drain the previous incarnation's replay debt BEFORE
    # the front socket opens — every
    # stashable result is stashed before any reconnecting client's
    # same-request_id retry can arrive
    router.attach_wal(serve_wal.Wal(serve_fleet.wal_path()))
    replayed = router.replay_wal()
    if replayed:
        print(f"# route: replayed {replayed} unacknowledged request(s)"
              f" from {serve_fleet.wal_path()}", file=sys.stderr)
    signal.signal(signal.SIGTERM, router.stop)
    signal.signal(signal.SIGINT, router.stop)
    print(f"# route: listening on {socket_path} "
          f"(pid {os.getpid()}, {len(workers)} worker(s), health "
          f"probe {hm.probe_s}s)", file=sys.stderr)
    try:
        router.serve_forever()
    except OSError as e:
        print(f"route: cannot serve on {socket_path}: {e}",
              file=sys.stderr)
        return 1
    finally:
        hm.stop()
        try:
            pidfile.close()
            os.unlink(serve_fleet.router_pidfile_path())
        except OSError:
            pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
