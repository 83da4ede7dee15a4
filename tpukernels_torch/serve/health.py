"""Fleet health manager of the port: crash detection, supervised
respawn, graceful degradation.

The port's copy of ``tpukernels/serve/health.py``. It runs as a thread
inside the router process (``router.main`` attaches it) and, read-only,
under ``ctl health``:

- **Liveness detection** — every ``TPKT_FLEET_PROBE_S`` (default 5 s)
  each ring member is probed twice over: its flocked pidfile (a dead
  process releases the flock, so a free lock is a death certificate,
  where a hung ping is merely ambiguous) and a protocol ping. Flock
  held + ping dead = SLOW (the process lives; its own watchdog owns
  wedged requests, journaled through ``watchdog.classify_timeout`` on
  the transition); flock free = DEAD (``worker_dead``). The router also
  reports every mid-forward transport loss here
  (:meth:`HealthManager.note_transport_loss`), so a crash under traffic
  is declared the moment its first request fails.
- **Supervised respawn** — a dead worker is respawned on its ORIGINAL
  socket and worker id (``fleet.spawn_worker``), with per-worker
  exponential backoff (``TPKT_FLEET_RESTART_BACKOFF_S`` doubling per
  consecutive crash) and a crash-loop quarantine:
  ``TPKT_FLEET_RESTART_MAX`` crashes without an intervening stable
  period give ``worker_quarantined``, and the worker is left out of the
  ring loudly; ``ctl undrain I`` resets it.
- **Rejoin gate** — a respawned worker takes traffic only after a clean
  ping AND a smoke: one small correctness-checked ``scan`` dispatch
  straight at the worker socket. On the card that is the respawned
  worker's first dispatch, which creates its CUDA context's state,
  loads the scan library (built before, never rebuilt) and makes its
  plan; ``SMOKE_TIMEOUT_S`` is its ceiling. Death during the smoke
  counts as a crash.
- **Immediate shm sweep** — a dead worker's ``tpkserve-<pid>-*``
  segments are unlinked the moment it is declared dead
  (``protocol.sweep_segments_for_pid``; the byte count rides the
  ``worker_dead`` event).

Evidence: ``worker_dead`` / ``worker_respawned`` / ``worker_quarantined``
journal kinds, the ``fleet.restarts`` counter and the
``fleet.live_workers`` gauge. The in-flight replay
(``serve_request_replayed``) and the degradation levels
(``fleet_degraded``) live in ``router.py``: the router owns the
requests, this module the processes.

Standard library and numpy; no torch (it never touches the card).
"""

from __future__ import annotations

import os
import sys
import threading
import time

from tpukernels_torch.obs import metrics as obs_metrics
from tpukernels_torch.resilience import journal, watchdog
from tpukernels_torch.serve import fleet, protocol
from tpukernels_torch.serve.proc import float_knob, int_knob, pidfile_state

DEFAULT_PROBE_S = 5.0
DEFAULT_RESTART_MAX = 3
DEFAULT_BACKOFF_S = 1.0

# consecutive healthy probes after which a worker's crash counter
# resets — the "window" of the crash-loop contract: crashes only
# accumulate toward quarantine while the worker never stays up this
# long
STABLE_PROBES = 10

# a worker that has NEVER been seen holding its pidfile flock gets
# this much startup grace (floored — a loaded CI host can take
# seconds just to import the daemon) before a free flock can read as
# death: start-fleet's workers bind/flock asynchronously. Respawned
# workers don't need it — the manager owns their Popen and polls it.
START_GRACE_PROBES = 6
START_GRACE_FLOOR_S = 20.0

# the rejoin smoke's client timeout: it rides out the respawned
# worker's first dispatch (on the card: its context's first use, the
# scan library's load and its plan)
SMOKE_TIMEOUT_S = 120.0

# shed-hint ceiling: an honest "the worker is respawning" hint, not a
# ban (the router's MAX_RETRY_HINT_S is for pacing; degradation waits
# are longer but still bounded)
MAX_DEGRADED_HINT_S = 30.0


def worker_pidfile(socket_path: str) -> str:
    """A fleet worker daemon's pidfile lives beside its socket (its
    ``TPKT_SERVE_DIR`` is the socket's directory — ``fleet.py``)."""
    return os.path.join(os.path.dirname(socket_path), "serve.pid")


def probe_worker(socket_path: str, timeout_s: float = 2.0):
    """One standalone liveness probe of one worker: ``(state, pid)``
    with state ``up`` (ping answers) / ``slow`` (flock held, ping
    dead) / ``dead`` (flock free). The read-only half of the manager
    loop, shared with ``ctl health``."""
    held, pid = pidfile_state(worker_pidfile(socket_path))
    answered = _ping_ok(socket_path, timeout_s)
    if answered:
        return "up", pid
    return ("slow" if held else "dead"), pid


def _ping_ok(socket_path: str, timeout_s: float) -> bool:
    import socket as socket_mod

    s = socket_mod.socket(socket_mod.AF_UNIX, socket_mod.SOCK_STREAM)
    s.settimeout(timeout_s)
    try:
        s.connect(socket_path)
        protocol.send_frame(s, {"v": protocol.VERSION, "op": "ping"})
        frame = protocol.recv_frame(s)
        return frame is not None and bool(frame[0].get("ok"))
    except (OSError, protocol.ProtocolError):
        return False
    finally:
        try:
            s.close()
        except OSError:
            pass


class _Worker:
    """One ring member's health state (guarded by the manager lock)."""

    __slots__ = ("idx", "socket", "state", "pid", "crashes",
                 "restarts", "next_attempt", "up_streak",
                 "seen_alive", "born", "died_at", "proc",
                 "smoke_fails")

    def __init__(self, idx: int, socket_path: str):
        self.idx = idx
        self.socket = socket_path
        self.state = "up"       # up | slow | down | joining | quarantined
        self.pid = None
        self.crashes = 0        # confirmed crashes this window
        self.restarts = 0       # respawns attempted, lifetime
        self.next_attempt = 0.0
        self.up_streak = 0
        self.seen_alive = False
        self.born = time.perf_counter()
        self.died_at = None
        self.proc = None        # last respawn Popen (reaped lazily)
        self.smoke_fails = 0    # consecutive failed rejoin smokes


class HealthManager:
    """The fleet's self-healing loop. ``router`` is duck-typed: it
    needs ``set_worker_down(idx, down, quarantined=False)`` and
    ``worker_draining(idx) -> bool``; ``None`` runs the manager
    standalone (probe + respawn, no routing integration)."""

    def __init__(self, workers, repo: str, router=None,
                 probe_s=None, restart_max=None, backoff_s=None):
        self.workers = [_Worker(i, w) for i, w in enumerate(workers)]
        self.repo = repo
        self.router = router
        self.probe_s = (probe_s if probe_s is not None
                        else float_knob("TPKT_FLEET_PROBE_S",
                                        DEFAULT_PROBE_S))
        self.restart_max = (restart_max if restart_max is not None
                            else int_knob("TPKT_FLEET_RESTART_MAX",
                                          DEFAULT_RESTART_MAX))
        self.backoff_s = (backoff_s if backoff_s is not None
                          else float_knob("TPKT_FLEET_RESTART_BACKOFF_S",
                                          DEFAULT_BACKOFF_S,
                                          floor=0.05))
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None
        self._smoke_seq = 0

    # -------------------------------------------------------------- #
    # lifecycle                                                      #
    # -------------------------------------------------------------- #

    def start(self):
        if self.probe_s <= 0:
            return  # TPKT_FLEET_PROBE_S=0: detection/respawn disabled
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="fleet-health",
        )
        self._thread.start()

    def stop(self):
        self._stop.set()

    def _loop(self):
        while not self._stop.wait(self.probe_s):
            try:
                self.probe_pass()
            except Exception as e:  # noqa: BLE001 — the loop must survive
                print(f"# fleet-health: probe pass errored: {e!r}",
                      file=sys.stderr)

    # -------------------------------------------------------------- #
    # queries (router / ctl surfaces)                                #
    # -------------------------------------------------------------- #

    def row(self, idx: int) -> dict:
        """The worker's health columns for ping/status payloads."""
        w = self.workers[idx]
        with self._lock:
            return {
                "state": w.state,
                "restarts": w.restarts,
                "crashes": w.crashes,
                "quarantined": w.state == "quarantined",
            }

    def live_count(self) -> int:
        with self._lock:
            return sum(1 for w in self.workers
                       if w.state in ("up", "slow"))

    def retry_hint(self, indices=None) -> float:
        """Honest ``retry_after_s`` for a shed request: the soonest
        moment any of the named down workers could be back (next
        respawn attempt + a probe/smoke margin), capped. Quarantined
        workers contribute the cap — they are not coming back without
        an operator."""
        now = time.perf_counter()
        hints = []
        with self._lock:
            for w in self.workers:
                if indices is not None and w.idx not in indices:
                    continue
                if w.state == "down":
                    hints.append(max(0.0, w.next_attempt - now)
                                 + self.probe_s)
                elif w.state == "joining":
                    hints.append(self.probe_s)
                elif w.state == "quarantined":
                    hints.append(MAX_DEGRADED_HINT_S)
        if not hints:
            return max(0.1, self.probe_s)
        return round(min(MAX_DEGRADED_HINT_S, max(0.1, min(hints))), 3)

    def reset(self, idx: int):
        """Operator override (``ctl undrain``): forget the
        crash window and quarantine — but PROBE before re-ringing.
        The raw undrain control op can arrive without ctl's
        restart-first discipline, and trusting it blindly would put
        a corpse back in the ring behind a fresh startup grace. A
        flock-holding worker rejoins immediately; a dead one is
        scheduled for an IMMEDIATE supervised respawn instead."""
        w = self.workers[idx]
        with self._lock:
            w.crashes = 0
            w.smoke_fails = 0
            w.up_streak = 0
            w.next_attempt = 0.0
        held, pid = pidfile_state(worker_pidfile(w.socket))
        if held or self.probe_s <= 0:
            # alive (liveness IS the flock) — or the manager is
            # disabled and cannot revive anything: restore the
            # pre-self-healing contract of trusting the operator
            with self._lock:
                w.state = "up"
                w.pid = pid if held else w.pid
                w.seen_alive = held
                w.born = time.perf_counter()
            if self.router is not None:
                self.router.set_worker_down(idx, False)
            return
        with self._lock:
            w.state = "down"
            if w.died_at is None:
                w.died_at = time.perf_counter()
        print(f"# fleet-health: undrained worker {idx} is still "
              "DEAD - respawning it now instead of ringing a corpse",
              file=sys.stderr)
        if self.router is not None:
            self.router.set_worker_down(idx, True)

    # -------------------------------------------------------------- #
    # detection                                                      #
    # -------------------------------------------------------------- #

    def _draining(self, idx: int) -> bool:
        if self.router is None:
            return False
        return self.router.worker_draining(idx)

    def note_transport_loss(self, idx: int) -> bool:
        """Router hook on a failed forward: is this worker DEAD (vs a
        drain window / a transient hiccup)? A free pidfile flock is
        the definitive answer; a confirmed death runs the full
        declaration (sweep, respawn scheduling, ring removal) NOW —
        in-flight recovery must not wait out a probe interval."""
        if self.probe_s <= 0:
            # TPKT_FLEET_PROBE_S=0 disables detection AND respawn:
            # declaring a death here with no loop to revive it would
            # remove the worker from the ring permanently — the
            # pre-self-healing spill behavior is the honest fallback
            return False
        if self._draining(idx):
            return False
        w = self.workers[idx]
        with self._lock:
            if w.state in ("down", "joining", "quarantined"):
                return True  # already declared; the respawn loop owns it
        # SIGKILL teardown closes the worker's fds one at a time: the
        # forward's socket can error a few ms BEFORE the pidfile
        # flock releases, and reading that window as "alive" would
        # demote the replay to a plain spill. Give death two short
        # rechecks; a genuinely live (wedged) worker costs this rare
        # path ~150 ms, a dying one is caught at the price of none.
        held, pid = pidfile_state(worker_pidfile(w.socket))
        for wait in (0.05, 0.1):
            if not held:
                break
            time.sleep(wait)
            held, pid = pidfile_state(worker_pidfile(w.socket))
        if held:
            return False
        with self._lock:
            if w.state in ("down", "joining", "quarantined"):
                # the probe thread declared it during our recheck
                # window: it IS dead — the answer this request needs
                # for its replay
                return True
            if not w.seen_alive and (
                    time.perf_counter() - w.born
                    < self._start_grace_s()):
                return False  # still starting up, not dead
        self._declare_dead(w, pid, via="transport")
        return True

    def _start_grace_s(self) -> float:
        return max(START_GRACE_FLOOR_S,
                   START_GRACE_PROBES * max(self.probe_s, 0.1))

    def probe_pass(self):
        """One sweep over every ring member; drives the per-worker
        state machine. Called from the manager thread (and directly
        by tests)."""
        now = time.perf_counter()
        for w in self.workers:
            if self._draining(w.idx):
                continue
            with self._lock:
                state = w.state
            if state == "quarantined":
                continue
            if state in ("up", "slow"):
                self._probe_live(w)
            elif state == "down":
                with self._lock:
                    due = now >= w.next_attempt
                if due:
                    self._respawn(w)
            elif state == "joining":
                self._try_rejoin(w)
        obs_metrics.gauge("fleet.live_workers", self.live_count())

    def _probe_live(self, w: _Worker):
        held, pid = pidfile_state(worker_pidfile(w.socket))
        if held:
            with self._lock:
                w.seen_alive = True
                w.pid = pid
            if _ping_ok(w.socket, max(0.5, min(2.0, self.probe_s))):
                with self._lock:
                    was = w.state
                    w.state = "up"
                    w.up_streak += 1
                    if w.up_streak >= STABLE_PROBES and w.crashes:
                        # stable window survived: the crash-loop
                        # counter starts over
                        w.crashes = 0
                if was == "slow" and self.router is not None:
                    self.router.set_worker_down(w.idx, False)
                return
            with self._lock:
                transition = w.state == "up" and w.seen_alive
                w.state = "slow"
                w.up_streak = 0
            if transition:
                # dead-vs-slow discrimination, journaled: the flock
                # answers (process alive) so this is SLOW — a wedged
                # request is the daemon watchdog's job, not a death
                watchdog.classify_timeout(
                    True, site="fleet_health", worker=w.idx,
                    socket=w.socket,
                )
            return
        # flock free: either a worker that never came up (startup
        # grace) or a confirmed death
        with self._lock:
            starting = not w.seen_alive and (
                time.perf_counter() - w.born < self._start_grace_s()
            )
        if starting:
            return
        if self._draining(w.idx):
            return  # the drain stopped it on purpose (late re-check)
        self._declare_dead(w, pid, via="probe")

    def _declare_dead(self, w: _Worker, pid, via: str):
        with self._lock:
            if w.state in ("down", "quarantined"):
                return  # already declared (probe/transport race)
            w.state = "down"
            w.up_streak = 0
            # seen_alive stays True: it means "alive at some point
            # since its last (re)start", the predicate the startup
            # grace keys on — resetting it HERE would let a death
            # masquerade as a slow start (_respawn resets it)
            w.died_at = time.perf_counter()
            w.crashes += 1
            crashes = w.crashes
            pid = pid if pid is not None else w.pid
            w.pid = None
            # exponential per-consecutive-crash backoff before the
            # respawn; the first crash respawns after one base wait
            backoff = self.backoff_s * (2 ** (crashes - 1))
            w.next_attempt = time.perf_counter() + backoff
        # the dead worker's shm segments must not wait for the next
        # daemon start's sweep (satellite: fix the leak-on-crash
        # window) — reclaim them NOW, and put the byte count on the
        # event so the leak is observable
        swept_n, swept_b = (0, 0)
        if pid is not None:
            swept_n, swept_b = protocol.sweep_segments_for_pid(pid)
        # worker_pid, not pid: the journal's common `pid` stamp names
        # the EMITTING process (this router) and must not be shadowed
        journal.emit(
            "worker_dead", worker=w.idx, socket=w.socket,
            worker_pid=pid,
            via=via, crashes=crashes, backoff_s=round(backoff, 3),
            swept_segments=swept_n, swept_bytes=swept_b,
        )
        print(f"# fleet-health: worker {w.idx} DEAD ({via}, crash "
              f"{crashes}) - respawn in {backoff:.1f}s", file=sys.stderr)
        if self.router is not None:
            self.router.set_worker_down(w.idx, True)
        if crashes >= self.restart_max:
            self._quarantine(w)

    def _quarantine(self, w: _Worker, reason: str = "crash-loop"):
        with self._lock:
            w.state = "quarantined"
            crashes = w.crashes
            smoke_fails = w.smoke_fails
        journal.emit(
            "worker_quarantined", worker=w.idx, socket=w.socket,
            reason=reason, crashes=crashes, smoke_fails=smoke_fails,
            threshold=self.restart_max,
            stable_probes=STABLE_PROBES,
        )
        print(f"# fleet-health: worker {w.idx} QUARANTINED "
              f"({reason}: {crashes} crash(es), {smoke_fails} failed "
              f"smoke(s); threshold {self.restart_max}) - "
              "left out of the ring; `ctl undrain "
              f"{w.idx}` resets", file=sys.stderr)
        if self.router is not None:
            self.router.set_worker_down(w.idx, True, quarantined=True)

    # -------------------------------------------------------------- #
    # recovery                                                       #
    # -------------------------------------------------------------- #

    def _respawn(self, w: _Worker):
        if w.proc is not None:
            w.proc.poll()  # reap the previous incarnation's zombie
        try:
            proc, _sock = fleet.spawn_worker(
                w.idx, self.repo, d=os.path.dirname(w.socket)
            )
        except OSError as e:
            with self._lock:
                w.next_attempt = (time.perf_counter()
                                  + self.backoff_s * (2 ** w.crashes))
            print(f"# fleet-health: respawn of worker {w.idx} failed "
                  f"({e}) - retrying", file=sys.stderr)
            return
        with self._lock:
            w.proc = proc
            w.restarts += 1
            w.state = "joining"
            w.seen_alive = False   # the NEW process: not yet observed
            w.born = time.perf_counter()
        obs_metrics.inc("fleet.restarts")
        print(f"# fleet-health: worker {w.idx} respawned "
              f"(pid {proc.pid}, attempt {w.restarts}) - awaiting "
              "ping + smoke before rejoin", file=sys.stderr)

    def _try_rejoin(self, w: _Worker):
        held, pid = pidfile_state(worker_pidfile(w.socket))
        if not held:
            # we OWN the respawned Popen: a live child that has not
            # flocked yet is still INITIALIZING (imports, bind) — an
            # exited one died before (or during) its join window,
            # which is a confirmed crash (the crash-loop path)
            if w.proc is not None and w.proc.poll() is None:
                return
            self._declare_dead(w, pid, via="join")
            return
        with self._lock:
            w.seen_alive = True
            w.pid = pid
        if not _ping_ok(w.socket, max(0.5, min(2.0, self.probe_s))):
            return  # daemon still initializing; next pass retries
        if not self._smoke(w):
            # the smoke failing is EITHER death-mid-smoke (the next
            # pass's flock check catches that as a crash) or a
            # HALF-UP worker: pings, dispatches, answers WRONG — the
            # exact suspect the gate exists for. Retrying forever
            # would keep the fleet degraded invisibly, so repeated
            # live-but-failing smokes escalate to the same loud
            # quarantine as a crash loop.
            with self._lock:
                alive = w.proc is None or w.proc.poll() is None
                if alive:
                    w.smoke_fails += 1
                fails = w.smoke_fails
            if alive and fails >= self.restart_max:
                self._quarantine(w, reason="smoke")
            return
        with self._lock:
            w.state = "up"
            w.up_streak = 1
            w.smoke_fails = 0
            down_s = (round(time.perf_counter() - w.died_at, 3)
                      if w.died_at is not None else None)
        journal.emit(
            "worker_respawned", worker=w.idx, socket=w.socket,
            worker_pid=pid, restarts=w.restarts, crashes=w.crashes,
            down_s=down_s,
        )
        print(f"# fleet-health: worker {w.idx} REJOINED the ring "
              f"(pid {pid}, down {down_s}s)", file=sys.stderr)
        if self.router is not None:
            self.router.set_worker_down(w.idx, False)

    def _smoke(self, w: _Worker) -> bool:
        """The rejoin gate's prewarm smoke: one small,
        correctness-checked ``scan`` dispatch straight at the worker
        socket — the worker's first dispatch, through the full serve
        path, so a worker that pings but cannot dispatch never takes
        traffic."""
        import numpy as np

        from tpukernels_torch.serve import client as serve_client

        x = (np.arange(64) % 7).astype(np.int32)
        want = np.cumsum(x, dtype=np.int64).astype(np.int32)
        self._smoke_seq += 1
        try:
            with serve_client.ServeClient(
                w.socket, timeout_s=SMOKE_TIMEOUT_S,
            ) as cli:
                cli.next_request_id = (
                    f"fleet-smoke-{w.idx}-{self._smoke_seq}"
                )
                out = cli.dispatch("scan", x)
        except (OSError, serve_client.ServeError,
                protocol.ProtocolError) as e:
            print(f"# fleet-health: worker {w.idx} rejoin smoke "
                  f"failed ({e!r}) - holding it out of the ring",
                  file=sys.stderr)
            return False
        if not np.array_equal(out, want):
            # a WRONG answer is louder than a dead socket: the worker
            # dispatches but cannot be trusted with traffic
            print(f"# fleet-health: worker {w.idx} rejoin smoke "
                  "returned a WRONG result - holding it out of the "
                  "ring", file=sys.stderr)
            return False
        return True
