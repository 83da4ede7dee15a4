"""Seeded chaos campaign against the port's serving fleet.

    python -m tpukernels_torch.serve.chaos [--seed N] [--events K]
                                           [--workers N]

The port's copy of ``tools/chaos.py``. One seeded campaign drives a live
fleet (``ctl start-fleet N`` plus the ``guardian``) under continuous
client load through K faults drawn from the vocabulary, and checks the
survival invariants after every event:

- **convergence** — ``ctl health`` sees every member live within
  :data:`RECOVER_WAIT_S`;
- **artifacts readable** — every persisted JSON file the fleet and its
  readers keep parses or is absent;
- **no unmarked duplicate dispatch** — a request_id on more than one
  ``serve_request`` carries the ``replayed`` marker (a replay off the
  router's WAL, which the port's daemon answers from its memo, or a
  hedge); two unmarked records are the same work run twice;
- **goodput** — every completed load request met its 90 s deadline;
- **no client drop** — every request came back, and right.

Each event leaves one ``chaos_event`` marker in the journal, with the
seconds from the fault to convergence (``recover_s``); before teardown a
``chaos_fleet_stats`` event records each worker's requests served and
kernel launches (the ``stats`` op: on the card, the scan kernel the load
ran). After teardown
(``ctl stop-fleet``) nothing may be left: no process the campaign saw in
a pidfile, no ``tpkserve-*`` segment one of them (or this process)
created, no flocked pidfile. Last, ``python -m
tpukernels_torch.obs.report --check`` judges the campaign's own journal
(``--journal``) and state directories; the reference's campaign runs its
report with no journal, which reads the newest ``docs/logs/`` file
instead of the campaign's.

Vocabulary (:data:`EVENTS`, drawn a slot at a time from
``random.Random(seed)``): ``kill_router`` (SIGKILL the router from its
pidfile: the guardian respawns it, the WAL replays), ``kill_worker``
(SIGKILL a seeded worker: the health manager respawns it),
``torn_write`` (half of a valid JSON payload written in place over one
of the port's artifacts, in turn the tuning cache, ``slo.json``,
``adapt.json`` and today's rollup: its reader in a fresh process must
reject it loudly, ``artifact_rejected``; then it is removed, as a reaper
would). Two more are armed through ``TPKT_FAULT_PLAN`` before the fleet
starts, each at most once a campaign (:func:`schedule`'s splice):
``wedge_dispatch`` (worker 0 wedges one scan dispatch, ``once_file``:
the watchdog abandons and requeues it) and ``delay_response`` (worker 0
holds one finished scan response 2 s). Same seed, same schedule, same
request ids. Before a member is killed again, the campaign waits until it
has been up :func:`stable_window_s` since its respawn (``settled_s`` in
the event's marker): the guardian and the health manager quarantine a
member that crashes ``TPKT_ROUTER_RESTART_MAX`` / ``TPKT_FLEET_RESTART_MAX``
times inside that window, by design, and a campaign's kills are
independent faults, not a crash loop. The reference's campaign kills
again at once, so a schedule with three router kills in a row (seed 1,
five events) quarantines its router.

The load: three seeded client threads send int32 scans of 64/128/256
elements through ``client.dispatch_with_backpressure``, each checked
against ``numpy.cumsum``. ``TPKT_SERVE_REQUEST_TIMEOUT_S=10``,
``TPKT_CLIENT_RECONNECT_S=60``, the journal
(``<fleet dir>/chaos_journal.jsonl``) and every state directory (under
``<fleet dir>/state``) are set by ``setdefault``: what the caller set
wins. The workers run on the card; under ``TPKT_SERVE_DEVICE=cpu`` on
the CPU with the plain versions.

Exit codes: 0 every invariant held after every event; 1 a violation
(printed); 2 usage. This process imports no torch.
"""

from __future__ import annotations

import datetime
import json
import os
import random
import signal
import subprocess
import sys
import threading
import time

from tpukernels_torch import _cachedir
from tpukernels_torch.obs import rollup
from tpukernels_torch.resilience import journal
from tpukernels_torch.serve import client as serve_client
from tpukernels_torch.serve import fleet as serve_fleet
from tpukernels_torch.serve import protocol as serve_protocol
from tpukernels_torch.serve.proc import pidfile_state

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# wedge_dispatch and delay_response are armed at fleet start (a fault
# plan loads at import); every other event is an action this process
# takes
EVENTS = ("kill_router", "kill_worker", "torn_write")

RECOVER_WAIT_S = 120.0


class CampaignFailure(Exception):
    pass


def _draw(rng, n_events: int, once_file: str):
    """The schedule and its fault plan from ``rng``: n draws from
    :data:`EVENTS`, then the first slot that is not a router kill becomes
    ``wedge_dispatch`` and the second ``delay_response``."""
    events = [EVENTS[rng.randrange(len(EVENTS))] for _ in range(n_events)]
    wedge_slot = delay_slot = None
    for i, ev in enumerate(events):
        if ev == "kill_router":
            continue
        if wedge_slot is None:
            wedge_slot = i
        elif delay_slot is None:
            delay_slot = i
            break
    plan: dict = {}
    if wedge_slot is not None:
        events[wedge_slot] = "wedge_dispatch"
        plan["wedge_dispatch"] = {
            "kernel": "scan", "times": 1, "once_file": once_file,
            "env": {"TPKT_SERVE_WORKER_ID": "0"}}
    if delay_slot is not None:
        events[delay_slot] = "delay_response"
        plan["delay_response"] = {
            "kernel": "scan", "delay_s": 2.0, "times": 1,
            "env": {"TPKT_SERVE_WORKER_ID": "0"}}
    return events, plan


def schedule(seed: int, n_events: int, once_file: str = "wedge.once"):
    """``(events, plan)`` of a campaign: the reference's schedule and
    fault plan for the same seed and count, with the port's worker id
    knob in the plan's ``env`` clauses."""
    return _draw(random.Random(seed), n_events, once_file)


def _ctl(*args):
    return subprocess.run(
        [sys.executable, "-m", "tpukernels_torch.serve.ctl", *args],
        cwd=_REPO, capture_output=True, text=True)


def _journal_events():
    events, _bad = journal.load_events([journal.path()])
    return events


def _count(kind, **match):
    return sum(1 for e in _journal_events() if e.get("kind") == kind
               and all(e.get(k) == v for k, v in match.items()))


def _wait_for(pred, timeout_s, what):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.25)
    raise CampaignFailure(f"timed out waiting for {what}")


class Load:
    """Continuous seeded client load (threads of this process): checked
    scans through the whole backpressure and reconnect policy.
    ``failures`` is the no-drop invariant, ``met`` against ``ok`` the
    goodput one."""

    def __init__(self, front: str, seed: int, clients: int = 3):
        self.front = front
        self.seed = seed
        self.clients = clients
        self.ok = 0
        # a deadline generous enough to ride out a router respawn (a
        # reconnect budget of 60 s)
        self.deadline_ms = 90_000.0
        self.met = 0
        self.failures: list = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads: list = []

    def start(self):
        for i in range(self.clients):
            t = threading.Thread(target=self._run, args=(i,), daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=180)

    def counts(self):
        with self._lock:
            return self.ok, self.met, list(self.failures)

    def _run(self, tid: int):
        import numpy as np

        rng = random.Random(self.seed * 1000 + tid)
        seq = 0
        with serve_client.ServeClient(self.front, timeout_s=120,
                                      tenant=f"chaos{tid}") as cli:
            while not self._stop.is_set():
                seq += 1
                n = rng.choice((64, 128, 256))
                x = (np.arange(n) % 7).astype(np.int32)
                want = np.cumsum(x, dtype=np.int64).astype(np.int32)
                rid = f"chaos-{self.seed}-{tid}-{seq}"
                cli.next_request_id = rid
                cli.next_deadline_ms = self.deadline_ms
                d0 = time.perf_counter()
                try:
                    out = serve_client.dispatch_with_backpressure(
                        cli, "scan", (x,), {}, jitter=rng)
                except Exception as e:  # noqa: BLE001 - a drop, recorded
                    with self._lock:
                        self.failures.append((rid, repr(e)))
                    return  # one drop already fails the campaign
                if not np.array_equal(out, want):
                    with self._lock:
                        self.failures.append((rid, "WRONG RESULT"))
                    return
                wall = time.perf_counter() - d0
                with self._lock:
                    self.ok += 1
                    if wall * 1000.0 <= self.deadline_ms:
                        self.met += 1
                time.sleep(0.05 + rng.random() * 0.1)


# ------------------------------------------------------------------ #
# events                                                             #
# ------------------------------------------------------------------ #

def _kill_from_pidfile(pidfile: str, what: str) -> int:
    held, pid = pidfile_state(pidfile)
    if not held or pid is None:
        raise CampaignFailure(
            f"cannot kill {what}: pidfile {pidfile} not live-flocked")
    os.kill(pid, signal.SIGKILL)
    return pid


def stable_window_s() -> float:
    """How long a respawned member must stay up before the guardian and
    the health manager forget its crash: ``health.STABLE_PROBES`` probes
    of ``TPKT_FLEET_PROBE_S``, and two probes of slack."""
    from tpukernels_torch.serve import health
    from tpukernels_torch.serve.proc import float_knob

    probe_s = float_knob("TPKT_FLEET_PROBE_S", health.DEFAULT_PROBE_S)
    return (health.STABLE_PROBES + 2) * probe_s


def _let_settle(member, counts) -> float:
    """Wait until ``member`` (``router`` or a worker index) has been up a
    stable window since the campaign saw it respawn, so the kill about
    to land is one crash, not a crash loop, as the supervisors count
    them (``TPKT_ROUTER_RESTART_MAX`` / ``TPKT_FLEET_RESTART_MAX``
    crashes inside one window quarantine a member by design). Returns
    the seconds waited."""
    up_at = counts.get(("up_at", member))
    if up_at is None:
        return 0.0
    wait = max(0.0, up_at + stable_window_s() - time.monotonic())
    time.sleep(wait)
    return round(wait, 3)


def _do_kill_router(rng, counts):
    waited = _let_settle("router", counts)
    before = _count("router_respawned")
    pid = _kill_from_pidfile(serve_fleet.router_pidfile_path(), "router")
    _wait_for(lambda: _count("router_respawned") > before,
              RECOVER_WAIT_S, "router_respawned after kill_router")
    counts[("up_at", "router")] = time.monotonic()
    return {"killed_pid": pid, "settled_s": waited}


def _do_kill_worker(rng, counts):
    cfg = serve_fleet.load_config() or {}
    idx = rng.randrange(len(cfg.get("workers") or [1]))
    waited = _let_settle(idx, counts)
    before = _count("worker_respawned", worker=idx)
    pid = _kill_from_pidfile(
        os.path.join(serve_fleet.worker_dir(idx), "serve.pid"),
        f"worker{idx}")
    _wait_for(lambda: _count("worker_respawned", worker=idx) > before,
              RECOVER_WAIT_S, f"worker_respawned({idx}) after kill_worker")
    counts[("up_at", idx)] = time.monotonic()
    return {"worker": idx, "killed_pid": pid, "settled_s": waited}


def _today() -> str:
    return datetime.date.today().isoformat()


# the artifacts torn_write tears in turn: (name, path, the torch-free
# reader a fresh process runs over it)
def torn_targets():
    day = _today()
    return (
        ("tuning", _cachedir.tuning_cache_path(),
         "from tpukernels_torch.tuning import cache; "
         "print(sorted(cache._load(cache.path())))"),
        ("slo", _cachedir.slo_path(),
         "from tpukernels_torch.obs import slo; "
         "print(sorted(slo.load_entries()))"),
        ("adapt", _cachedir.adapt_path(),
         "from tpukernels_torch.serve import adapt; print(adapt.load())"),
        ("rollup", rollup.rollup_path(day),
         "from tpukernels_torch.obs import rollup; "
         f"print(rollup.load_day({day!r}))"),
    )


def _do_torn_write(rng, counts):
    """Tear one artifact in place (half a valid JSON payload, the crash
    shape of a writer that is not atomic) and check that its reader
    rejects it loudly, then remove it."""
    targets = torn_targets()
    name, path, probe_code = targets[(counts.get("torn_write", 1) - 1)
                                     % len(targets)]
    payload = json.dumps({"torn-probe": {"best": {"knob": 1}}}, indent=1)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(payload[: len(payload) // 2])
    before = _count("artifact_rejected")
    probe = subprocess.run([sys.executable, "-c", probe_code], cwd=_REPO,
                           capture_output=True, text=True)
    if probe.returncode != 0:
        raise CampaignFailure(f"torn {name} reader crashed: {probe.stderr}")
    if "torn artifact rejected" not in probe.stderr:
        raise CampaignFailure(f"torn {name} read silently (no stderr "
                              "rejection)")
    _wait_for(lambda: _count("artifact_rejected") > before, 10.0,
              f"artifact_rejected after torn_write of {name}")
    os.unlink(path)  # rebuildable: a clean slate, as a reaper leaves
    return {"artifact": name, "path": path}


def _delay_response_armed(rng, counts):
    """Armed at fleet start: the event is seeing it fire; the goodput
    and duplicate invariants then show the fleet absorbed it."""
    _wait_for(lambda: _count("fault_injected", site="response") > 0,
              RECOVER_WAIT_S, "armed delay_response to fire")
    return {}


def _wedge_armed(once_file: str):
    """Armed at fleet start: the event is seeing it fire (its
    ``once_file``) and the watchdog requeue the request."""
    def check(rng, counts):
        _wait_for(lambda: os.path.exists(once_file), RECOVER_WAIT_S,
                  "armed wedge_dispatch to fire")
        _wait_for(lambda: _count("serve_request_requeued") > 0,
                  RECOVER_WAIT_S, "serve_request_requeued after wedge")
        return {"once_file": once_file}
    return check


# ------------------------------------------------------------------ #
# invariants                                                         #
# ------------------------------------------------------------------ #

def assert_converged():
    r = _ctl("health", "--wait", str(int(RECOVER_WAIT_S)))
    if r.returncode != 0:
        raise CampaignFailure(f"fleet did not converge: {r.stdout}{r.stderr}")


def artifact_paths() -> list:
    return ([serve_fleet.config_path(), _cachedir.tuning_cache_path(),
             _cachedir.aot_manifest_path(), _cachedir.slo_path(),
             _cachedir.adapt_path(), _cachedir.integrity_manifest_path(),
             _cachedir.integrity_quarantine_path()]
            + [rollup.rollup_path(d) for d in rollup.rollup_dates()])


def assert_artifacts_readable(paths=None):
    """Every persisted artifact parses or is absent: a torn file that
    survives an event is a fault of an atomic writer."""
    for p in artifact_paths() if paths is None else paths:
        if not os.path.exists(p):
            continue
        with open(p) as f:
            try:
                json.load(f)
            except ValueError as e:
                raise CampaignFailure(
                    f"artifact {p} is torn after recovery: {e}") from None


def assert_no_duplicate_dispatch(events):
    """A request_id on more than one ``serve_request`` is honest only
    with the ``replayed`` marker (a WAL replay or a hedge); two unmarked
    records are the same work run twice."""
    by_id: dict = {}
    for e in events:
        if e.get("kind") != "serve_request" or not e.get("request_id"):
            continue
        by_id.setdefault(e["request_id"], []).append(e)
    for rid, evs in sorted(by_id.items()):
        plain = [e for e in evs if not e.get("replayed")]
        if len(plain) > 1:
            raise CampaignFailure(
                f"request {rid} dispatched {len(plain)} time(s) with "
                "no replay/hedge marker (silent duplicate dispatch)")


def assert_goodput(ok: int, met: int, deadline_ms: float):
    if met < ok:
        raise CampaignFailure(
            f"goodput violated: only {met}/{ok} completed request(s) "
            f"met the {deadline_ms:.0f}ms deadline")


def assert_no_leaks(n_workers: int, pids, wait_s: float = 60.0):
    """After teardown: none of ``pids`` runs, no ``tpkserve-*`` segment
    created by one of them or by this process is left, and no pidfile
    of the fleet is flocked."""
    mine = set(pids) | {os.getpid()}
    deadline = time.monotonic() + wait_s
    # a member releases its pidfile's flock, then exits: wait for the pid
    while time.monotonic() < deadline and [p for p in pids if _alive(p)]:
        time.sleep(0.1)
    alive = sorted(p for p in pids if _alive(p))
    if alive:
        raise CampaignFailure(f"leaked process(es): {alive}")
    leaked = []
    for f in os.listdir(serve_protocol.SHM_DIR):
        m = serve_protocol._SHM_NAME_RE.match(f)
        if m and int(m.group(1)) in mine:
            leaked.append(f)
    if leaked:
        raise CampaignFailure(f"leaked shm segments: {sorted(leaked)}")
    for p in fleet_pidfiles(n_workers):
        held, pid = pidfile_state(p)
        if held:
            raise CampaignFailure(f"leaked process: pid {pid} still "
                                  f"flocks {p}")


def fleet_pidfiles(n_workers: int) -> list:
    return [serve_fleet.guardian_pidfile_path(),
            serve_fleet.router_pidfile_path()] + [
        os.path.join(serve_fleet.worker_dir(i), "serve.pid")
        for i in range(n_workers)]


def _alive(pid: int) -> bool:
    """Whether ``pid`` runs (a zombie does not)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except (OSError, IndexError):
        return False


def _fleet_pids(n_workers: int) -> set:
    out = set()
    for p in fleet_pidfiles(n_workers):
        held, pid = pidfile_state(p)
        if held and pid:
            out.add(pid)
    return out


# ------------------------------------------------------------------ #
# the campaign                                                       #
# ------------------------------------------------------------------ #

def _isolate():
    """The knobs and state directories a campaign needs, by setdefault:
    the worker watchdog compressed (a wedge is abandoned at about three
    times it), a reconnect budget that outlasts a router respawn, the
    journal in the fleet dir (the campaign's evidence: with it off every
    wait below would starve) and every state directory under
    ``<fleet dir>/state``."""
    d = serve_fleet.fleet_dir()
    os.makedirs(d, exist_ok=True)
    os.environ.setdefault("TPKT_SERVE_REQUEST_TIMEOUT_S", "10")
    os.environ.setdefault("TPKT_CLIENT_RECONNECT_S", "60")
    os.environ.setdefault("TPKT_HEALTH_JOURNAL",
                          os.path.join(d, "chaos_journal.jsonl"))
    for var, path in _cachedir.state_dirs_under(
            os.path.join(d, "state")).items():
        os.environ.setdefault(var, path)


def fleet_stats(front) -> list:
    """Each worker's requests served and kernel launches (the ``stats``
    op), None for a worker that did not answer; [] without a router."""
    from tpukernels_torch.serve import top

    reply = top.fetch(front) if front else None
    return [None if w is None else {"served": w.get("served"),
                                    "launches": w.get("launches") or {}}
            for w in (reply or {}).get("worker_stats") or []]


def _report_check() -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-m", "tpukernels_torch.obs.report", "--check",
         "--journal", journal.path()],
        cwd=_REPO, capture_output=True, text=True)


def run_campaign(seed: int, n_events: int, n_workers: int) -> int:
    rng = random.Random(seed)
    once_file = os.path.join(serve_fleet.fleet_dir(), "wedge.once")
    events, plan = _draw(rng, n_events, once_file)
    if plan:
        os.makedirs(serve_fleet.fleet_dir(), exist_ok=True)
        os.environ["TPKT_FAULT_PLAN"] = json.dumps(plan)
    print(f"# chaos: seed {seed}, schedule: {', '.join(events)}",
          file=sys.stderr, flush=True)
    _isolate()
    if journal.path() is None:
        print("chaos: TPKT_HEALTH_JOURNAL is off - the campaign's "
              "evidence is its journal", file=sys.stderr)
        return 2
    r = _ctl("start-fleet", str(n_workers), "--wait", "120")
    if r.returncode != 0:
        print(f"chaos: start-fleet failed: {r.stdout}{r.stderr}",
              file=sys.stderr)
        return 1
    pids = _fleet_pids(n_workers)
    r = _ctl("guardian", "--wait", "30")
    if r.returncode != 0:
        print(f"chaos: guardian failed: {r.stdout}{r.stderr}",
              file=sys.stderr)
        _ctl("stop-fleet", "--wait", "60")
        return 1
    pids |= _fleet_pids(n_workers)

    load = Load((serve_fleet.load_config() or {}).get("front"), seed)
    handlers = {"kill_router": _do_kill_router,
                "kill_worker": _do_kill_worker,
                "torn_write": _do_torn_write,
                "wedge_dispatch": _wedge_armed(once_file),
                "delay_response": _delay_response_armed}
    rc = 0
    try:
        load.start()
        time.sleep(1.0)  # traffic flowing before the first fault
        counts: dict = {}
        for i, ev in enumerate(events):
            print(f"# chaos: event {i + 1}/{len(events)}: {ev}",
                  file=sys.stderr, flush=True)
            counts[ev] = counts.get(ev, 0) + 1
            t0 = time.monotonic()
            detail = handlers[ev](rng, counts)
            assert_converged()
            # from the fault to convergence: a settle wait is not recovery
            recover_s = round(time.monotonic() - t0
                              - detail.get("settled_s", 0.0), 3)
            pids |= _fleet_pids(n_workers)
            assert_artifacts_readable()
            assert_no_duplicate_dispatch(_journal_events())
            ok, met, failures = load.counts()
            assert_goodput(ok, met, load.deadline_ms)
            if failures:
                raise CampaignFailure(f"client drops after {ev}: {failures}")
            journal.emit("chaos_event", event=ev, seq=i + 1, of=len(events),
                         seed=seed, recover_s=recover_s, **detail)
            print(f"# chaos: event {i + 1} {ev}: converged in {recover_s} s, "
                  f"{ok} request(s) ok so far", file=sys.stderr, flush=True)
            time.sleep(0.5 + rng.random())  # settle, seeded
    except CampaignFailure as e:
        print(f"chaos: INVARIANT VIOLATED: {e}", file=sys.stderr)
        rc = 1
    finally:
        load.stop()
        pids |= _fleet_pids(n_workers)
        journal.emit("chaos_fleet_stats", seed=seed,
                     workers=fleet_stats(load.front))
        stop = _ctl("stop-fleet", "--wait", "60")
        if stop.returncode != 0 and rc == 0:
            print(f"chaos: teardown failed: {stop.stdout}{stop.stderr}",
                  file=sys.stderr)
            rc = 1

    ok, met, failures = load.counts()
    if failures and rc == 0:
        print(f"chaos: client drops: {failures}", file=sys.stderr)
        rc = 1
    try:
        assert_no_leaks(n_workers, pids)
    except CampaignFailure as e:
        print(f"chaos: {e}", file=sys.stderr)
        rc = 1
    check = _report_check()
    print(check.stdout, end="", file=sys.stderr)
    if check.returncode != 0:
        print(f"chaos: obs.report --check failed (rc {check.returncode}):"
              f"\n{check.stderr}", file=sys.stderr)
        rc = 1
    verdict = "SURVIVED" if rc == 0 else "FAILED"
    print(f"chaos: campaign {verdict} - seed {seed}, {len(events)} "
          f"event(s), {ok} request(s) ok ({met} within deadline), "
          f"{len(failures)} dropped")
    return rc


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    seed, n_events, n_workers = 0, 6, 2
    it = iter(argv)
    try:
        for a in it:
            if a == "--seed":
                seed = int(next(it))
            elif a == "--events":
                n_events = int(next(it))
            elif a == "--workers":
                n_workers = int(next(it))
            elif a in ("-h", "--help"):
                print(__doc__, file=sys.stderr)
                return 0
            else:
                print(__doc__, file=sys.stderr)
                print(f"chaos: unknown argument {a!r}", file=sys.stderr)
                return 2
    except (StopIteration, ValueError):
        print(f"chaos: {a} needs an integer value", file=sys.stderr)
        return 2
    if n_events < 1 or n_workers < 2:
        print("chaos: need --events >= 1 and --workers >= 2 (ring "
              "failover requires a sibling)", file=sys.stderr)
        return 2
    return run_campaign(seed, n_events, n_workers)


if __name__ == "__main__":
    sys.exit(main())
