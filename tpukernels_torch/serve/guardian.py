"""Router guardian of the port's serving fleet.

The port's copy of ``tpukernels/serve/guardian.py``. The health manager
rides inside the router process, so a ``kill -9``'d router takes the
self-healing loop down with it: workers keep their sockets, but the
front socket is gone and nobody respawns anything. The guardian is the
router's supervisor, a separate process (``ctl guardian`` /
``fleet.spawn_guardian``) holding the same pidfile-flock liveness
contract over the router that the router holds over its workers:

- **Detection** — every ``TPKT_FLEET_PROBE_S`` the router's flocked
  pidfile is tested; a free flock is a death certificate. Declared as
  ``router_dead``, with the dead pid's ``/dev/shm`` segments swept at
  once (``protocol.sweep_segments_for_pid``).
- **Supervised respawn** — the router is respawned on the ORIGINAL front
  socket from the config of record (``fleet.load_config``), with
  exponential backoff (``TPKT_ROUTER_RESTART_BACKOFF_S`` doubling per
  consecutive crash) and a crash-loop quarantine at
  ``TPKT_ROUTER_RESTART_MAX`` crashes without an intervening stable
  window (``router_quarantined``; the guardian stays up, inert, until
  ``ctl start-fleet``). The respawned router's own health manager
  finds the live workers by their pidfiles and sockets; healthy
  workers are not restarted.
- **Rejoin gate** — the respawn counts (``router_respawned``) only after
  the new router holds its flock, answers a ping AND routes a small
  correctness-checked ``scan`` through the front socket.

The accepted requests in flight inside the dead router are the WAL's
(``serve/wal.py``): the respawned router replays them before its front
socket opens, and clients ride out the refused-connection window
(``client.dispatch_with_backpressure``'s ``TPKT_CLIENT_RECONNECT_S``
budget).

Evidence: ``router_dead`` / ``router_respawned`` / ``router_quarantined``
journal kinds. The clean path prints nothing to stdout. Standard library
and numpy; no torch.
"""

from __future__ import annotations

import os
import sys
import threading
import time

from tpukernels_torch.resilience import journal
from tpukernels_torch.serve import fleet, health, protocol
from tpukernels_torch.serve.proc import float_knob, int_knob, pidfile_state

DEFAULT_RESTART_MAX = 3
DEFAULT_BACKOFF_S = 1.0


class Guardian:
    """The router's supervisor loop. State machine mirrors one
    ``health._Worker``: up | down | joining | quarantined, with
    startup grace keyed on "never seen holding the flock"."""

    def __init__(self, repo: str, probe_s=None, restart_max=None,
                 backoff_s=None):
        self.repo = repo
        self.probe_s = (probe_s if probe_s is not None
                        else float_knob("TPKT_FLEET_PROBE_S",
                                               health.DEFAULT_PROBE_S))
        self.restart_max = (
            restart_max if restart_max is not None
            else int_knob("TPKT_ROUTER_RESTART_MAX",
                                 DEFAULT_RESTART_MAX))
        self.backoff_s = (
            backoff_s if backoff_s is not None
            else float_knob("TPKT_ROUTER_RESTART_BACKOFF_S",
                                   DEFAULT_BACKOFF_S, floor=0.05))
        self.state = "up"
        self.pid = None
        self.crashes = 0
        self.restarts = 0
        self.up_streak = 0
        self.seen_alive = False
        self.born = time.perf_counter()
        self.died_at = None
        self.next_attempt = 0.0
        self.proc = None
        self._smoke_seq = 0
        self._stop = threading.Event()

    # ------------------------------------------------------------ #
    # lifecycle                                                    #
    # ------------------------------------------------------------ #

    def run(self):
        while not self._stop.is_set():
            self.probe_pass()
            self._stop.wait(self.probe_s)

    def stop(self, *_):
        self._stop.set()

    # ------------------------------------------------------------ #
    # the state machine                                            #
    # ------------------------------------------------------------ #

    def _start_grace_s(self) -> float:
        return max(health.START_GRACE_FLOOR_S,
                   health.START_GRACE_PROBES * max(self.probe_s, 0.1))

    def probe_pass(self):
        if self.state == "quarantined":
            return
        if self.state == "down":
            if time.perf_counter() >= self.next_attempt:
                self._respawn()
            return
        if self.state == "joining":
            self._try_rejoin()
            return
        held, pid = pidfile_state(fleet.router_pidfile_path())
        if held:
            self.seen_alive = True
            self.pid = pid
            self.up_streak += 1
            if self.up_streak >= health.STABLE_PROBES and self.crashes:
                # stable window survived: crash-loop counter restarts
                self.crashes = 0
            return
        if not self.seen_alive and (
                time.perf_counter() - self.born < self._start_grace_s()):
            return  # start-fleet's router binds/flocks asynchronously
        self._declare_dead(pid, via="probe")

    def _declare_dead(self, pid, via: str):
        self.state = "down"
        self.up_streak = 0
        self.died_at = time.perf_counter()
        self.crashes += 1
        pid = pid if pid is not None else self.pid
        self.pid = None
        backoff = self.backoff_s * (2 ** (self.crashes - 1))
        self.next_attempt = time.perf_counter() + backoff
        # the dead router never relayed shm payloads of its own, but a
        # crash mid-reply can leave response segments it re-homed —
        # sweep anything its pid created NOW, like a worker death
        swept_n, swept_b = (0, 0)
        if pid is not None:
            swept_n, swept_b = protocol.sweep_segments_for_pid(pid)
        journal.emit(
            "router_dead", router_pid=pid, via=via,
            crashes=self.crashes, backoff_s=round(backoff, 3),
            swept_segments=swept_n, swept_bytes=swept_b,
        )
        print(f"# guardian: router DEAD ({via}, crash {self.crashes})"
              f" - respawn in {backoff:.1f}s", file=sys.stderr)
        if self.crashes >= self.restart_max:
            self._quarantine()

    def _quarantine(self):
        self.state = "quarantined"
        journal.emit(
            "router_quarantined", crashes=self.crashes,
            threshold=self.restart_max,
            stable_probes=health.STABLE_PROBES,
        )
        print(f"# guardian: router QUARANTINED ({self.crashes} "
              f"crash(es); threshold {self.restart_max}) - not "
              "respawning; `ctl start-fleet` resets",
              file=sys.stderr)

    def _respawn(self):
        cfg = fleet.load_config()
        if cfg is None:
            # no config of record (torn, or the fleet was stopped out
            # from under us): nothing to respawn FROM — retry later,
            # loudly, rather than invent a topology
            self.next_attempt = (time.perf_counter()
                                 + self.backoff_s * (2 ** self.crashes))
            print("# guardian: no readable fleet.json - cannot "
                  "respawn the router yet", file=sys.stderr)
            return
        if self.proc is not None:
            self.proc.poll()  # reap the previous incarnation's zombie
        try:
            self.proc = fleet.spawn_router(
                cfg["front"], cfg["workers"], self.repo
            )
        except OSError as e:
            self.next_attempt = (time.perf_counter()
                                 + self.backoff_s * (2 ** self.crashes))
            print(f"# guardian: router respawn failed ({e}) - "
                  "retrying", file=sys.stderr)
            return
        self.state = "joining"
        self.seen_alive = False   # the NEW process: not yet observed
        self.born = time.perf_counter()
        self.restarts += 1
        print(f"# guardian: router respawned (pid {self.proc.pid}, "
              f"attempt {self.restarts}) - awaiting flock + ping + "
              "smoke", file=sys.stderr)

    def _try_rejoin(self):
        held, pid = pidfile_state(fleet.router_pidfile_path())
        if not held:
            # we OWN the respawned Popen: a live child that has not
            # flocked yet is still initializing (imports, bind, WAL
            # replay); an exited one is a confirmed crash
            if self.proc is not None and self.proc.poll() is None:
                return
            self._declare_dead(pid, via="join")
            return
        self.seen_alive = True
        self.pid = pid
        cfg = fleet.load_config()
        front = (cfg or {}).get("front") or fleet.front_socket_path()
        if not health._ping_ok(front,
                               max(0.5, min(2.0, self.probe_s))):
            return  # router still initializing; next pass retries
        if not self._smoke(front):
            return  # death-mid-smoke is caught by the next flock pass
        self.state = "up"
        self.up_streak = 1
        down_s = (round(time.perf_counter() - self.died_at, 3)
                  if self.died_at is not None else None)
        journal.emit(
            "router_respawned", router_pid=pid,
            restarts=self.restarts, crashes=self.crashes,
            down_s=down_s,
        )
        print(f"# guardian: router RECOVERED (pid {pid}, down "
              f"{down_s}s)", file=sys.stderr)

    def _smoke(self, front: str) -> bool:
        """The rejoin gate's dispatch smoke: one small
        correctness-checked ``scan`` THROUGH the front socket — it
        proves the respawned router can actually route to a live
        worker, not merely bind."""
        import numpy as np

        from tpukernels_torch.serve import client as serve_client

        x = (np.arange(64) % 7).astype(np.int32)
        want = np.cumsum(x, dtype=np.int64).astype(np.int32)
        self._smoke_seq += 1
        try:
            with serve_client.ServeClient(
                front, timeout_s=health.SMOKE_TIMEOUT_S,
            ) as cli:
                cli.next_request_id = f"router-smoke-{self._smoke_seq}"
                out = cli.dispatch("scan", x)
        except (OSError, serve_client.ServeError,
                protocol.ProtocolError) as e:
            print(f"# guardian: router rejoin smoke failed ({e!r})",
                  file=sys.stderr)
            return False
        if not np.array_equal(out, want):
            print("# guardian: router rejoin smoke returned a WRONG "
                  "result - holding", file=sys.stderr)
            return False
        return True


# ------------------------------------------------------------------ #
# CLI entry (python -m tpukernels_torch.serve.guardian)              #
# ------------------------------------------------------------------ #


def main(argv=None):
    import signal

    from tpukernels_torch import _cachedir
    from tpukernels_torch.serve import proc

    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] in ("-h", "--help"):
        print(__doc__, file=sys.stderr)
        return 0
    if argv:
        print(f"guardian: unknown argument {argv[0]!r}",
              file=sys.stderr)
        return 2
    if fleet.load_config() is None:
        print("guardian: no fleet here (fleet.json missing or "
              "unreadable) - start one first", file=sys.stderr)
        return 2
    try:
        g = Guardian(repo=os.getcwd())
    except ValueError as e:
        print(f"guardian: {e}", file=sys.stderr)
        return 2
    try:
        pidfile = proc.hold_pidfile(fleet.guardian_pidfile_path())
    except RuntimeError as e:
        print(f"guardian: {e}", file=sys.stderr)
        return 3
    if os.environ.get("TPKT_HEALTH_JOURNAL") is None:
        os.environ["TPKT_HEALTH_JOURNAL"] = _cachedir.serve_dir()
    signal.signal(signal.SIGTERM, g.stop)
    signal.signal(signal.SIGINT, g.stop)
    print(f"# guardian: watching {fleet.router_pidfile_path()} "
          f"(pid {os.getpid()}, probe {g.probe_s}s)", file=sys.stderr)
    try:
        g.run()
    finally:
        try:
            pidfile.close()
            os.unlink(fleet.guardian_pidfile_path())
        except OSError:
            pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
