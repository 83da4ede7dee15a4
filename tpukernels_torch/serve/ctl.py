"""Operator control of the port's serving daemon and fleet.

The port's copy of the verbs of ``tools/serve_ctl.py``, driving
``python -m tpukernels_torch.serve`` (the daemon), ``python -m
tpukernels_torch.serve.router`` and ``python -m
tpukernels_torch.serve.guardian``.

Usage:
    python -m tpukernels_torch.serve.ctl start [--wait S] [--socket PATH]
    python -m tpukernels_torch.serve.ctl stop [--wait S]
    python -m tpukernels_torch.serve.ctl status
    python -m tpukernels_torch.serve.ctl start-fleet N [--wait S]
    python -m tpukernels_torch.serve.ctl stop-fleet [--wait S]
    python -m tpukernels_torch.serve.ctl drain I [--wait S]
    python -m tpukernels_torch.serve.ctl undrain I [--wait S]
    python -m tpukernels_torch.serve.ctl health [--wait S]
    python -m tpukernels_torch.serve.ctl guardian [--wait S]
    python -m tpukernels_torch.serve.ctl fsck
    python -m tpukernels_torch.serve.ctl top [--once] [--interval S]
                                             [--socket PATH]

Single daemon: ``start`` spawns the daemon detached and waits for a
protocol ping; ``stop`` SIGTERMs the pid the flocked pidfile records and
waits for the flock to release; ``status`` tests the flock (a dead
daemon's stale pid never reads as running) and prints the ping payload.

Fleet (``serve/fleet.py``): ``start-fleet N`` spawns N worker daemons
(each on its own socket, pidfile and log under the fleet dir, tagged
``TPKT_SERVE_WORKER_ID``) and the router on ``front.sock``, records the
layout in ``fleet.json`` and waits for every member to answer a ping;
point clients (``TPKT_SERVE_SOCKET``, ``loadgen --serve``) at the front
socket. ``drain I`` tells the router to route worker I's buckets to
their ring siblings, waits for its in-flight forwards to empty, then
stops the worker: no accepted request drops. ``undrain I`` restarts the
worker if needed and restores it to the ring. ``stop-fleet`` stops the
guardian first (stopped later, it would read the router's stop as a
crash), then the router, then the workers. ``status`` detects a fleet
(live router pidfile) and prints the router's totals and one line per
worker, with its liveness state, restart count and quarantine flag.

``health`` polls the fleet (router rows when the router answers, direct
pidfile-flock + ping probes per worker otherwise) until every ring
member is live or ``--wait`` expires. ``guardian`` spawns the router's
supervisor (``serve/guardian.py``) and waits for its pidfile flock.
``fsck`` reaps crash residue: pidfiles whose flock nothing holds,
``tpkserve-*`` shm segments whose creator is dead, and a fleet.json
that does not parse; journaled as ``fleet_fsck``, always exit 0.
``top`` is the live dashboard over the read-only ``stats`` op
(``serve/top.py``): one row a worker, ``--once`` for one frame (rc 1
when nothing answers).

Exit codes: 0 — done (``status``: up; ``health``: all workers live);
1 — failed (``status``: down; ``health``: a worker is dead or
quarantined past the wait); 2 — usage error; 3 —
``start``/``start-fleet``/``guardian`` refused because a live
daemon/router/guardian already holds the pidfile.

Standard library and numpy; no torch (only the daemons it spawns touch
the card).
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time

from tpukernels_torch import _cachedir
from tpukernels_torch.serve import client as serve_client
from tpukernels_torch.serve import fleet as serve_fleet
from tpukernels_torch.serve import health as serve_health
from tpukernels_torch.serve import protocol as serve_protocol

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _pidfile_state(path=None):
    """(held, pid_or_None) of a pidfile (default: the daemon's)."""
    return serve_health.pidfile_state(
        path or _cachedir.serve_pidfile_path()
    )


def _ping(socket_path):
    # ProtocolError too: a daemon mid-shutdown hangs up before
    # answering, which must read as "not (yet) up", not a traceback
    try:
        with serve_client.ServeClient(socket_path, timeout_s=5) as cli:
            return cli.ping()
    except (OSError, serve_protocol.ProtocolError):
        return None


def _control(socket_path, op, worker):
    """One router control round trip ({"op": drain|undrain,
    "worker": i}); returns the reply header or None on transport
    trouble."""
    import socket as socket_mod

    s = socket_mod.socket(socket_mod.AF_UNIX, socket_mod.SOCK_STREAM)
    s.settimeout(10)
    try:
        s.connect(socket_path)
        serve_protocol.send_frame(
            s, {"v": serve_protocol.VERSION, "op": op, "worker": worker}
        )
        frame = serve_protocol.recv_frame(s)
    except (OSError, serve_protocol.ProtocolError):
        return None
    finally:
        try:
            s.close()
        except OSError:
            pass
    return frame[0] if frame else None


def _stats_line(stats) -> str:
    buckets = stats.get("buckets") or []
    # copied/window: the zero-copy + continuous-batching evidence a
    # fleet operator reads here instead of the journal — copied stays
    # 0 while the shm warm path is engaged, window collapses to 0ms
    # when the daemon idles
    # snap_age: the metrics flusher's last_snapshot_age_s — "off" when
    # TPKT_METRICS_FLUSH_S is unset; a value growing past the flush
    # interval means the flusher thread died and this worker's
    # journal telemetry is silently going stale
    age = stats.get("last_snapshot_age_s")
    return (f"served={stats.get('served')} "
            f"rejected={stats.get('rejected')} "
            f"requeued={stats.get('requeued')} "
            f"depth={stats.get('depth')}/{stats.get('queue_max')} "
            f"inflight={stats.get('inflight')} "
            f"copied={stats.get('bytes_copied')}B "
            f"window={stats.get('batch_window_ms')}ms "
            f"lanes={','.join(stats.get('lanes') or ['inline'])} "
            f"snap_age={'off' if age is None else f'{age:.1f}s'} "
            f"buckets={len(buckets)}"
            + (f" [{', '.join(buckets)}]" if buckets else ""))


def start(wait_s: float, socket_path) -> int:
    socket_path = socket_path or _cachedir.serve_socket_path()
    held, pid = _pidfile_state()
    if held:
        print(f"ctl: daemon already running (pid {pid}) - "
              "leave it, or stop it first")
        return 3
    d = _cachedir.serve_dir()
    os.makedirs(d, exist_ok=True)
    log_path = os.path.join(d, "serve_daemon.log")
    log = open(log_path, "a")
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpukernels_torch.serve",
         "--socket", socket_path],
        cwd=_REPO, start_new_session=True,
        stdout=subprocess.DEVNULL, stderr=log,
    )
    log.close()
    deadline = time.monotonic() + wait_s
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            print(f"ctl: daemon exited rc={proc.returncode} "
                  f"before answering - see {log_path}",
                  file=sys.stderr)
            return 1
        stats = _ping(socket_path)
        if stats:
            print(f"ctl: daemon up (pid {stats.get('pid')}, "
                  f"{stats.get('workers')} worker(s)) on {socket_path}")
            return 0
        time.sleep(0.2)
    print(f"ctl: daemon did not answer within {wait_s}s - "
          f"killing it; see {log_path}", file=sys.stderr)
    proc.terminate()
    return 1


def _stop_pidfile(pidfile, what, wait_s: float) -> int:
    held, pid = _pidfile_state(pidfile)
    if not held:
        print(f"ctl: no {what} running"
              + (f" (stale pid {pid} in pidfile)" if pid else ""))
        return 0
    if pid is None:
        print(f"ctl: {what} pidfile flocked but records no pid "
              "- inspect by hand (fuser on the socket)",
              file=sys.stderr)
        return 1
    try:
        os.kill(pid, signal.SIGTERM)
    except OSError as e:
        print(f"ctl: cannot signal pid {pid}: {e}",
              file=sys.stderr)
        return 1
    deadline = time.monotonic() + wait_s
    while time.monotonic() < deadline:
        held, _pid = _pidfile_state(pidfile)
        if not held:
            print(f"ctl: {what} (pid {pid}) stopped")
            return 0
        time.sleep(0.2)
    print(f"ctl: {what} (pid {pid}) still holds the pidfile "
          f"after {wait_s}s - escalate by hand if it is truly wedged",
          file=sys.stderr)
    return 1


def stop(wait_s: float) -> int:
    return _stop_pidfile(_cachedir.serve_pidfile_path(), "daemon",
                         wait_s)


# ------------------------------------------------------------------ #
# fleet verbs                                                        #
# ------------------------------------------------------------------ #

def start_fleet(n: int, wait_s: float) -> int:
    held, pid = _pidfile_state(serve_fleet.router_pidfile_path())
    if held:
        print(f"ctl: fleet router already running (pid {pid}) "
              "- stop-fleet first")
        return 3
    front = serve_fleet.front_socket_path()
    procs, socks = [], []
    try:
        for i in range(n):
            proc, sock = serve_fleet.spawn_worker(i, _REPO)
            procs.append((f"worker{i}", proc))
            socks.append(sock)
        router = serve_fleet.spawn_router(front, socks, _REPO)
        procs.append(("router", router))
        serve_fleet.write_config(front, socks)
    except OSError as e:
        # a mid-loop spawn failure (full disk, unwritable fleet dir)
        # must not leak the members already running detached
        print(f"ctl: cannot spawn the fleet: {e}",
              file=sys.stderr)
        _abort_fleet(procs)
        return 1
    deadline = time.monotonic() + wait_s
    pending = [("router", front)] + [
        (f"worker{i}", s) for i, s in enumerate(socks)
    ]
    while pending and time.monotonic() < deadline:
        for name, proc in procs:
            if proc.poll() is not None:
                print(f"ctl: {name} exited "
                      f"rc={proc.returncode} before answering - see "
                      f"its log under {serve_fleet.fleet_dir()}",
                      file=sys.stderr)
                _abort_fleet(procs)
                return 1
        pending = [(name, s) for name, s in pending
                   if _ping(s) is None]
        if pending:
            time.sleep(0.2)
    if pending:
        print(f"ctl: {', '.join(n for n, _s in pending)} did "
              f"not answer within {wait_s}s - stopping the fleet",
              file=sys.stderr)
        _abort_fleet(procs)
        return 1
    print(f"ctl: fleet up - router on {front}, "
          f"{n} worker(s)")
    return 0


def _reap(procs):
    for _name, proc in procs:
        if proc.poll() is None:
            proc.terminate()
    for _name, proc in procs:
        try:
            proc.wait(10)
        except subprocess.TimeoutExpired:
            proc.kill()


def _abort_fleet(procs):
    """Failed start: kill what came up AND drop fleet.json — a stale
    config of record would make a later drain/undrain respawn orphan
    workers for a fleet whose router never answered."""
    _reap(procs)
    try:
        os.unlink(serve_fleet.config_path())
    except OSError:
        pass


def stop_fleet(wait_s: float) -> int:
    cfg = serve_fleet.load_config()
    # the guardian FIRST: stopped any
    # later it would read the intentional router stop as a crash and
    # respawn the router mid-teardown
    rc = 0
    gpidfile = serve_fleet.guardian_pidfile_path()
    if os.path.exists(gpidfile):
        rc = _stop_pidfile(gpidfile, "guardian", wait_s)
    rrc = _stop_pidfile(serve_fleet.router_pidfile_path(), "router",
                        wait_s)
    rc = rc or rrc
    workers = (cfg or {}).get("workers") or []
    for i, _sock in enumerate(workers):
        wrc = _stop_pidfile(
            os.path.join(serve_fleet.worker_dir(i), "serve.pid"),
            f"worker{i}", wait_s,
        )
        rc = rc or wrc
    if rc == 0:
        # the config of record outlives a FAILED stop on purpose: a
        # wedged member that survived --wait must stay addressable by
        # a retry ('stop-fleet' / 'drain I'), not become an orphan
        # the ctl can no longer name
        try:
            os.unlink(serve_fleet.config_path())
        except OSError:
            pass
    return rc


def drain(idx: int, wait_s: float) -> int:
    cfg = serve_fleet.load_config()
    if not cfg:
        print("ctl: no fleet.json - is a fleet running?",
              file=sys.stderr)
        return 1
    front = cfg["front"]
    reply = _control(front, "drain", idx)
    if not reply or not reply.get("ok"):
        print(f"ctl: drain refused: "
              f"{(reply or {}).get('error') or 'router unreachable'}",
              file=sys.stderr)
        return 1
    # wait for the router's in-flight forwards to that worker to
    # empty, then stop it; a forward still stuck past the wait (a
    # wedge) is rescued by the router's transport failover when the
    # worker dies — zero accepted requests drop either way
    deadline = time.monotonic() + wait_s
    while time.monotonic() < deadline:
        stats = _ping(front)
        rows = (stats or {}).get("workers") or []
        if idx < len(rows) and rows[idx].get("inflight") == 0:
            break
        time.sleep(0.2)
    rc = _stop_pidfile(
        os.path.join(serve_fleet.worker_dir(idx), "serve.pid"),
        f"worker{idx}", wait_s,
    )
    print(f"ctl: worker {idx} drained - its buckets now route "
          "to their ring siblings")
    return rc


def undrain(idx: int, wait_s: float) -> int:
    cfg = serve_fleet.load_config()
    if not cfg:
        print("ctl: no fleet.json - is a fleet running?",
              file=sys.stderr)
        return 1
    front = cfg["front"]
    if not 0 <= idx < len(cfg["workers"]):
        # validate BEFORE spawning: a daemon for an index outside the
        # fleet would be an orphan stop-fleet can never reach
        print(f"ctl: worker index {idx} out of range "
              f"(fleet has {len(cfg['workers'])})", file=sys.stderr)
        return 2
    pidfile = os.path.join(serve_fleet.worker_dir(idx), "serve.pid")
    held, _pid = _pidfile_state(pidfile)
    if not held:
        proc, sock = serve_fleet.spawn_worker(idx, _REPO)
        deadline = time.monotonic() + wait_s
        while _ping(sock) is None:
            if proc.poll() is not None:
                print(f"ctl: worker{idx} exited "
                      f"rc={proc.returncode} before answering",
                      file=sys.stderr)
                return 1
            if time.monotonic() > deadline:
                print(f"ctl: worker{idx} did not answer within "
                      f"{wait_s}s", file=sys.stderr)
                proc.terminate()
                return 1
            time.sleep(0.2)
    reply = _control(front, "undrain", idx)
    if not reply or not reply.get("ok"):
        print(f"ctl: undrain refused: "
              f"{(reply or {}).get('error') or 'router unreachable'}",
              file=sys.stderr)
        return 1
    print(f"ctl: worker {idx} restored to the ring")
    return 0


def status(socket_path=None) -> int:
    held, pid = _pidfile_state(serve_fleet.router_pidfile_path())
    if held:
        return _fleet_status()
    held, pid = _pidfile_state()
    if not held:
        print("ctl: daemon DOWN"
              + (f" (stale pid {pid} in pidfile)" if pid else ""))
        return 1
    stats = _ping(socket_path or _cachedir.serve_socket_path())
    if stats is None:
        print(f"ctl: pid {pid} holds the pidfile but the "
              "socket does not answer - starting up, or wedged")
        return 1
    print(f"ctl: daemon UP (pid {stats.get('pid')}) - "
          + _stats_line(stats)
          + f" device={stats.get('device_kind')}"
          f" uptime={stats.get('uptime_s')}s")
    return 0


def _fleet_status() -> int:
    cfg = serve_fleet.load_config() or {}
    front = cfg.get("front") or serve_fleet.front_socket_path()
    stats = _ping(front)
    if stats is None:
        print("ctl: router holds its pidfile but the front "
              "socket does not answer - starting up, or wedged")
        return 1
    print(f"ctl: fleet UP - router pid {stats.get('pid')}, "
          f"routed={stats.get('routed')} spilled={stats.get('spilled')}"
          f" throttled={stats.get('throttled')} "
          f"relayed={stats.get('bytes_copied')}B "
          f"lanes={','.join(stats.get('lanes') or ['inline'])} "
          f"device={stats.get('device_kind')} "
          f"uptime={stats.get('uptime_s')}s")
    level = stats.get("level")
    if level and level != "ok":
        print(f"ctl: fleet {str(level).upper()} - shedding "
              "rules active")
    rows = stats.get("workers") or []
    rc = 0
    for i, row in enumerate(rows):
        wstats = _ping(row.get("socket"))
        state = ("DRAINING" if row.get("draining")
                 else "QUARANTINED" if row.get("quarantined")
                 else "cooling" if row.get("cooling")
                 else row.get("state") or "up")
        # the self-healing columns: liveness state / restart count /
        # quarantine, straight from the router's health manager
        heal = ""
        if row.get("restarts"):
            heal = f" restarts={row.get('restarts')}"
        if wstats is None:
            print(f"  worker{i}: DOWN ({state}; "
                  f"routed={row.get('routed')}{heal})")
            if not row.get("draining"):
                rc = 1
            continue
        print(f"  worker{i}: {state} pid {wstats.get('pid')} "
              f"routed={row.get('routed')} "
              f"inflight_router={row.get('inflight')}{heal} - "
              + _stats_line(wstats))
    return rc


def health(wait_s: float) -> int:
    """Standalone fleet-health face: poll until every ring member is
    live (router rows preferred; direct pidfile+ping probes when the
    router itself is down) or the wait expires. The convergence gate
    chaos probes wait on after a kill."""
    cfg = serve_fleet.load_config()
    if not cfg:
        print("ctl: no fleet.json - is a fleet running?",
              file=sys.stderr)
        return 1
    front = cfg["front"]
    deadline = time.monotonic() + wait_s
    rows = None
    while True:
        stats = _ping(front)
        rows = (stats or {}).get("workers")
        if rows is None:
            # router down: probe the workers directly (the read-only
            # half of the health manager, shared helper)
            rows = [
                {"socket": s,
                 "state": serve_health.probe_worker(s)[0]}
                for s in cfg.get("workers") or []
            ]
        live = [r for r in rows
                if (r.get("state") or "up") == "up"
                or r.get("draining")]
        if len(live) == len(rows) and rows:
            break
        if time.monotonic() >= deadline:
            break
        time.sleep(0.3)
    rc = 0
    for i, row in enumerate(rows or []):
        state = row.get("state") or "up"
        if row.get("draining"):
            state = "draining"
        if row.get("quarantined"):
            state = "quarantined"
        line = f"  worker{i}: {state}"
        if row.get("restarts"):
            line += f" restarts={row.get('restarts')}"
        print(line)
        if state not in ("up", "draining"):
            rc = 1
    if not rows:
        print("ctl: fleet has no workers to probe",
              file=sys.stderr)
        rc = 1
    print("ctl: fleet " + ("CONVERGED - all workers live"
                                 if rc == 0 else
                                 "NOT converged within the wait"))
    return rc


def guardian(wait_s: float) -> int:
    """Spawn the router's guardian detached and wait for its pidfile
    flock."""
    if not serve_fleet.load_config():
        print("ctl: no fleet.json - start a fleet first",
              file=sys.stderr)
        return 1
    gpidfile = serve_fleet.guardian_pidfile_path()
    held, pid = _pidfile_state(gpidfile)
    if held:
        print(f"ctl: guardian already running (pid {pid})")
        return 3
    proc = serve_fleet.spawn_guardian(_REPO)
    deadline = time.monotonic() + wait_s
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            print(f"ctl: guardian exited rc={proc.returncode} "
                  f"before flocking - see guardian.log under "
                  f"{serve_fleet.fleet_dir()}", file=sys.stderr)
            return 1
        held, _pid = _pidfile_state(gpidfile)
        if held:
            print(f"ctl: guardian up (pid {proc.pid}) watching "
                  f"{serve_fleet.router_pidfile_path()}")
            return 0
        time.sleep(0.2)
    print(f"ctl: guardian did not flock within {wait_s}s - "
          "killing it", file=sys.stderr)
    proc.terminate()
    return 1


def fsck() -> int:
    """Reap crash residue: stale
    pidfiles, orphaned shm segments, a torn fleet.json. Journaled as
    ``fleet_fsck``; always 0 — a janitor, not a health check."""
    from tpukernels_torch.resilience import journal

    stale_pidfiles = 0
    pidfiles = [serve_fleet.guardian_pidfile_path(),
                serve_fleet.router_pidfile_path(),
                _cachedir.serve_pidfile_path()]
    fleet_d = serve_fleet.fleet_dir()
    try:
        for entry in sorted(os.listdir(fleet_d)):
            if entry.startswith("worker"):
                pidfiles.append(os.path.join(fleet_d, entry,
                                             "serve.pid"))
    except OSError:
        pass
    for p in pidfiles:
        if not os.path.exists(p):
            continue
        held, pid = _pidfile_state(p)
        if held:
            continue
        try:
            os.unlink(p)
        except OSError:
            continue
        stale_pidfiles += 1
        print(f"ctl: fsck reaped stale pidfile {p}"
              + (f" (dead pid {pid})" if pid else ""))
    swept_segments = serve_protocol.sweep_stale_segments()
    if swept_segments:
        print(f"ctl: fsck swept {swept_segments} orphaned shm "
              "segment(s)")
    torn_configs = 0
    cfg_path = serve_fleet.config_path()
    if os.path.exists(cfg_path) and serve_fleet.load_config() is None:
        # present but unreadable/invalid: a mid-write crash on a
        # pre-atomic writer tore it — reap it so start-fleet starts
        # clean instead of every reader re-rejecting it
        try:
            os.unlink(cfg_path)
            torn_configs += 1
            print(f"ctl: fsck reaped torn {cfg_path}")
        except OSError:
            pass
    journal.emit(
        "fleet_fsck", stale_pidfiles=stale_pidfiles,
        swept_segments=swept_segments, torn_configs=torn_configs,
    )
    print(f"ctl: fsck done - {stale_pidfiles} stale "
          f"pidfile(s), {swept_segments} orphaned segment(s), "
          f"{torn_configs} torn config(s)")
    return 0


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    verbs = ("start", "stop", "status", "start-fleet", "stop-fleet",
             "drain", "undrain", "health", "guardian", "fsck", "top")
    if not argv or argv[0] not in verbs:
        print(__doc__, file=sys.stderr)
        return 2
    cmd = argv[0]
    rest = argv[1:]
    count = None
    if cmd in ("start-fleet", "drain", "undrain"):
        if not rest or not rest[0].isdigit():
            print(__doc__, file=sys.stderr)
            print(f"ctl: {cmd} needs a count/index",
                  file=sys.stderr)
            return 2
        count = int(rest[0])
        rest = rest[1:]
    wait_s, socket_path = 30.0, None
    once, interval_s = False, 2.0
    it = iter(rest)
    try:
        for a in it:
            if a == "--wait":
                wait_s = float(next(it))
            elif a == "--socket":
                socket_path = next(it)
            elif a == "--once" and cmd == "top":
                once = True
            elif a == "--interval" and cmd == "top":
                interval_s = float(next(it))
            else:
                print(__doc__, file=sys.stderr)
                print(f"ctl: unknown argument {a!r}",
                      file=sys.stderr)
                return 2
    except (StopIteration, ValueError):
        print(f"ctl: {a} needs a value", file=sys.stderr)
        return 2
    if cmd == "start":
        return start(wait_s, socket_path)
    if cmd == "stop":
        return stop(wait_s)
    if cmd == "start-fleet":
        if count < 1:
            print("ctl: start-fleet needs N >= 1",
                  file=sys.stderr)
            return 2
        return start_fleet(count, wait_s)
    if cmd == "stop-fleet":
        return stop_fleet(wait_s)
    if cmd == "drain":
        return drain(count, wait_s)
    if cmd == "undrain":
        return undrain(count, wait_s)
    if cmd == "health":
        return health(wait_s)
    if cmd == "guardian":
        return guardian(wait_s)
    if cmd == "fsck":
        return fsck()
    if cmd == "top":
        from tpukernels_torch.serve import top

        return top.run(once=once, interval_s=interval_s,
                       socket_path=socket_path)
    return status(socket_path)


if __name__ == "__main__":
    sys.exit(main())
