"""Checkpointed revalidation supervisor of the port.

The port's copy of ``tpukernels/resilience/supervisor.py``: the queue
of steps ``python -m tpukernels_torch.revalidate`` runs to re-check the
port on the card in every healthy window. Three behaviours are the core:

1. **Crash-safe resume** — every decision (a step's start and outcome,
   a quarantine) is appended to a JSONL *checkpoint*, flushed and
   fsynced, before and after each step, so a ``kill -9`` at any instant
   loses at most the step in flight: a re-run replays the checkpoint
   and reaches the same green queue without running green steps again.
   The same decisions go to the best-effort health journal.
2. **Step quarantine** — a step that WEDGES ``quarantine_after`` times
   (default 2) in one day is demoted to non-gating and skipped with a
   loud ``step_quarantined`` event, so the next healthy window goes to
   the next step.
3. **Flap-aware scheduling** — recent ``probe``/wedge events in the
   journal estimate the healthy window; steps that need the card are
   admitted only when their device-minute cost fits it, highest value a
   device-minute first. When nothing fits, the best-density step is
   forced (estimates are estimates; admitting nothing forever is
   worse) and the decision journaled.

Each step is a ``bash -c`` child under ``watchdog.kill_after``; a
timeout is classified slow or wedged by :func:`probe_alive`, a torch
child that runs one op on the card (a host without a card is dead, never
alive). Waiting for the card (:func:`watch`) backs off exponentially
with deterministic jitter, each decision journaled as
``probe_scheduled``.

State lives under ``_cachedir.supervisor_dir()`` (``TPKT_SUPERVISOR_DIR``,
default ``.tpkt_cache/supervisor``): the checkpoint
``supervisor_<date>.jsonl`` (``TPKT_SUPERVISOR_CHECKPOINT``) and the
stamps ``.revalidate_stamps/<name>_<date>.done``
(``TPKT_REVALIDATE_STAMP_DIR``), in the reference's file formats, never
under ``docs/logs/``. A green step's stamp holds the HEAD sha and goes
stale once a later commit touches the step's inputs (default
``tpukernels_torch``, ``c`` and ``chip_smoke.py``).

Standard library only: the supervisor never imports torch and never
opens a CUDA context. Only step children and probe children touch the
card, so a wedged card cannot hang the queue itself.
"""

from __future__ import annotations

import datetime
import hashlib
import json
import os
import re
import subprocess
import sys
import time

from tpukernels_torch import _cachedir
from tpukernels_torch.obs import metrics, trace
from tpukernels_torch.resilience import faults, journal, watchdog

_REPO = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

# outcome vocabulary for step_done checkpoint/journal records
GREEN = "green"          # exit 0
FAILED = "failed"        # loud nonzero exit (never a wedge)
WEDGED = "wedged"        # watchdog kill + dead re-probe
SLOW = "slow"            # watchdog kill + live re-probe (not a wedge)

# the exit-code contract of ``python -m tpukernels_torch.revalidate`` and
# the watch loop, the reference's: 0 green; 2 incomplete-but-nothing-regressed (deferred steps /
# partial coverage — retryable next window); 124 wedge or step timeout
# (retryable); any other nonzero = a gating step failed loudly.
RC_GREEN = 0
RC_INCOMPLETE = 2
RC_WEDGE = 124

# no flap history: assume the top of the reference's observed 2-25 min
# band, so that with no evidence of short windows the scheduler does not
# invert the value ordering by deferring the expensive high-value steps;
# only observed flaps constrain admission
_DEFAULT_WINDOW_MIN = 25.0
_WINDOW_CLAMP = (1.0, 60.0)


class StepSpec:
    """One declarative revalidation step.

    ``shell`` is the step body (run via ``bash -c``, its own killable
    subprocess). ``gating`` steps abort the queue on loud failure;
    non-gating ones warn. ``cost_min``/``value`` drive the
    value-per-device-minute admission ordering; ``needs_chip=False``
    steps (the sanitizers, the journal readers) ignore the window
    estimate.
    ``stamp`` policy: ``daily`` (stamp on success, skip while fresh),
    ``attempt`` (stamp BEFORE running — a wedge here must not re-eat
    every window; the prewarm contract), ``never`` (always runs).
    ``inputs`` are the repo paths whose commits invalidate a same-day
    stamp (git-aware staleness; :data:`DEFAULT_INPUTS` when empty).
    ``after`` lists steps that must have been attempted (any outcome)
    earlier in the queue: dependency edges.
    ``cost_from="prewarm"`` makes ``cost_min`` a live estimate: each
    queue run re-derives it from the newest per-key ``prewarm_kernel``
    walls in the health journal (see
    :func:`observed_prewarm_cost_min`) so flap-window admission uses
    measured compile cost, not a hand-guessed constant.
    """

    __slots__ = ("name", "shell", "gating", "timeout_s", "cost_min",
                 "value", "max_attempts_per_day", "quarantine_after",
                 "stamp", "needs_chip", "inputs", "after", "cost_from")

    def __init__(self, name, shell, *, gating=True, timeout_s=1200.0,
                 cost_min=5.0, value=1.0, max_attempts_per_day=6,
                 quarantine_after=2, stamp="daily", needs_chip=True,
                 inputs=(), after=(), cost_from=None):
        if stamp not in ("daily", "attempt", "never"):
            raise ValueError(f"step {name!r}: bad stamp policy {stamp!r}")
        if cost_from not in (None, "prewarm"):
            raise ValueError(
                f"step {name!r}: bad cost_from {cost_from!r} "
                "(known: prewarm)")
        self.name = name
        self.shell = shell
        self.gating = bool(gating)
        self.timeout_s = float(timeout_s)
        self.cost_min = float(cost_min)
        self.value = float(value)
        self.max_attempts_per_day = int(max_attempts_per_day)
        self.quarantine_after = int(quarantine_after)
        self.stamp = stamp
        self.needs_chip = bool(needs_chip)
        self.inputs = tuple(inputs)
        self.after = tuple(after)
        self.cost_from = cost_from

    @property
    def density(self) -> float:
        """Value per device-minute — the admission preference key."""
        return self.value / max(self.cost_min, 0.01)

    @classmethod
    def from_dict(cls, d: dict) -> "StepSpec":
        d = dict(d)
        name = d.pop("name")
        shell = d.pop("shell")
        return cls(name, shell, **d)


def load_queue_file(path: str) -> list:
    """Parse a JSON queue definition (a list of StepSpec dicts) — how
    the CPU chaos tests drive the real supervisor against stub steps,
    and how an operator can run a cut-down queue."""
    with open(path) as f:
        raw = json.load(f)
    if not isinstance(raw, list):
        raise ValueError(f"{path}: queue file must be a JSON list")
    specs = [StepSpec.from_dict(d) for d in raw]
    names = [s.name for s in specs]
    if len(set(names)) != len(names):
        raise ValueError(f"{path}: duplicate step names")
    known = set(names)
    for s in specs:
        missing = [a for a in s.after if a not in known]
        if missing:
            raise ValueError(
                f"{path}: step {s.name!r} depends on unknown {missing}"
            )
    # a dependency cycle must fail HERE as a config error: at run time
    # it would surface as rc 2 ("incomplete, retryable") and the watch
    # loop would re-run an unrunnable queue until its deadline
    after = {s.name: set(s.after) for s in specs}
    progress = True
    while progress and after:
        progress = False
        for n in [n for n, deps in after.items() if not deps]:
            del after[n]
            for deps in after.values():
                deps.discard(n)
            progress = True
    if after:
        raise ValueError(
            f"{path}: dependency cycle among {sorted(after)}")
    return specs


# ------------------------------------------------------------------ #
# git-aware stamps (the reference's on-disk format)                   #
# ------------------------------------------------------------------ #

# the paths whose commits make a stamp stale when a step names none: the
# port, the C drivers it runs, and the script that drives it on the card
DEFAULT_INPUTS = ("tpukernels_torch", "c", "chip_smoke.py")


def stamp_dir() -> str:
    """``TPKT_REVALIDATE_STAMP_DIR``, else ``.revalidate_stamps`` under
    :func:`_cachedir.supervisor_dir`."""
    return os.environ.get("TPKT_REVALIDATE_STAMP_DIR") or os.path.join(
        _cachedir.supervisor_dir(), ".revalidate_stamps")


def _stamp_path(name: str) -> str:
    day = datetime.date.today().isoformat()
    return os.path.join(stamp_dir(), f"{name}_{day}.done")


def write_stamp(name: str, repo=_REPO):
    """The reference's format: the stamp file holds ``repo``'s HEAD sha
    (empty outside git), scoped to today by its name. Written atomically
    (``resilience/atomic.py``): a stamp torn mid-write would read as a
    sha-less stamp and skip the step on the wall clock alone."""
    from tpukernels_torch.resilience import atomic

    p = _stamp_path(name)
    os.makedirs(os.path.dirname(p), exist_ok=True)
    sha = journal.git_head(repo) or ""
    atomic.write_text(p, sha + "\n" if sha else "")


def _commits_touching(since_sha: str, head: str, inputs, repo=_REPO):
    """True if a commit in (since_sha, head] touched any of `inputs`;
    None when git can't answer (unknown sha after a rewrite) — the
    caller must treat that as stale, re-running is the safe side."""
    try:
        r = subprocess.run(
            ["git", "-C", repo, "log", "--format=%H",
             f"{since_sha}..{head}", "--", *inputs],
            capture_output=True, text=True, timeout=30,
        )
    except Exception:
        return None
    if r.returncode != 0:
        return None
    return bool(r.stdout.strip())


def stamp_fresh(spec: StepSpec, repo=_REPO) -> bool:
    """Is the step's same-day stamp still valid? ``TPKT_REVALIDATE_FORCE=1``
    always re-runs; a sha-less stamp (or no git) is honoured on the wall
    clock alone; a sha stamp goes stale as soon as a later commit of
    ``repo`` touches the step's inputs."""
    if os.environ.get("TPKT_REVALIDATE_FORCE") == "1":
        return False
    p = _stamp_path(spec.name)
    try:
        with open(p) as f:
            sha = f.readline().strip()
    except OSError:
        return False
    if not sha:
        return True           # legacy / no-git stamp: wall-clock only
    head = journal.git_head(repo)
    if head is None or head == sha:
        return True
    inputs = spec.inputs or DEFAULT_INPUTS
    touched = _commits_touching(sha, head, inputs, repo)
    if touched is None:
        return False          # git can't judge: re-run, the safe side
    return not touched


# ------------------------------------------------------------------ #
# checkpoint: append-only JSONL, the supervisor's authoritative state #
# ------------------------------------------------------------------ #

def checkpoint_path() -> str:
    """``TPKT_SUPERVISOR_CHECKPOINT``: a file, or a directory (the dated
    file inside); unset, ``supervisor_<date>.jsonl`` under
    :func:`_cachedir.supervisor_dir`."""
    raw = os.environ.get("TPKT_SUPERVISOR_CHECKPOINT")
    day = datetime.date.today().isoformat()
    if raw and os.path.isdir(raw):
        return os.path.join(raw, f"supervisor_{day}.jsonl")
    if raw:
        return raw
    return os.path.join(_cachedir.supervisor_dir(), f"supervisor_{day}.jsonl")


class Checkpoint:
    """Append-only JSONL state log. Unlike the health journal (best
    effort by contract), checkpoint appends are flushed AND fsynced —
    resume correctness rides on them — and an unwritable checkpoint
    fails the supervisor loudly rather than silently forgetting
    state. Every append is mirrored to journal.emit for the
    observability stream."""

    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)

    def append(self, kind: str, **fields):
        now = time.time()
        rec = {
            "ts": datetime.datetime.fromtimestamp(now).isoformat(
                timespec="seconds"),
            "t": round(now, 3),
            "pid": os.getpid(),
            "git_head": journal.git_head(),
            "kind": kind,
        }
        rec.update(fields)
        with open(self.path, "a") as f:
            f.write(json.dumps(rec, default=repr) + "\n")
            f.flush()
            os.fsync(f.fileno())
        return rec

    def replay(self) -> dict:
        """Reconstruct per-step state for TODAY from the checkpoint:
        {"steps": {name: {"attempts", "wedges", "green",
        "quarantined", "interrupted"}}, "events": N}. A step_start
        with no matching step_done is an INTERRUPTED attempt (the
        kill -9 case): it counts as an attempt — the step re-runs —
        but never toward the wedge quarantine (the supervisor died,
        not necessarily the step)."""
        events, _bad = journal.load_events([self.path])
        today = datetime.date.today().isoformat()
        steps: dict = {}
        open_start: dict = {}

        def st(name):
            return steps.setdefault(name, {
                "attempts": 0, "wedges": 0, "green": False,
                "quarantined": False, "interrupted": 0,
            })

        n = 0
        for ev in events:
            if not str(ev.get("ts", "")).startswith(today):
                continue
            n += 1
            kind, name = ev.get("kind"), ev.get("step")
            if kind == "step_start":
                s = st(name)
                s["attempts"] += 1
                open_start[name] = open_start.get(name, 0) + 1
            elif kind == "step_done":
                s = st(name)
                if open_start.get(name):
                    open_start[name] -= 1
                if ev.get("outcome") == GREEN:
                    s["green"] = True
                elif ev.get("outcome") == WEDGED:
                    s["wedges"] += 1
            elif kind == "step_quarantined":
                st(name)["quarantined"] = True
        for name, cnt in open_start.items():
            if cnt > 0:
                steps[name]["interrupted"] += cnt
        return {"steps": steps, "events": n}


# ------------------------------------------------------------------ #
# flap-aware window estimation                                        #
# ------------------------------------------------------------------ #

def estimate_window_minutes(events, now=None) -> dict:
    """Estimate the current healthy-window length from recent health
    events: each (alive probe -> later wedge) pair inside the last
    24 h is one observed window; the estimate is their median, clamped
    to ``_WINDOW_CLAMP``. ``TPKT_SUPERVISOR_WINDOW_MIN`` pins it
    (operator override). Returns {"minutes", "basis", "windows"}."""
    pinned = os.environ.get("TPKT_SUPERVISOR_WINDOW_MIN")
    if pinned:
        try:
            return {"minutes": float(pinned), "basis": "env",
                    "windows": 0}
        except ValueError:
            print(f"# supervisor: bad TPKT_SUPERVISOR_WINDOW_MIN "
                  f"{pinned!r} ignored", file=sys.stderr)
    now = time.time() if now is None else now
    horizon = now - 24 * 3600
    alive_t = None
    windows = []
    for ev in sorted(events, key=lambda e: e.get("t", 0.0)):
        t = ev.get("t")
        if not isinstance(t, (int, float)) or t < horizon:
            continue
        kind = ev.get("kind")
        if kind == "probe" and ev.get("outcome") == "alive":
            if alive_t is None:
                alive_t = t
        elif (kind == "wedge_classification"
              and ev.get("verdict") == "wedged") or (
                kind == "step_done" and ev.get("outcome") == WEDGED):
            if alive_t is not None and t > alive_t:
                windows.append((t - alive_t) / 60.0)
            alive_t = None
    if not windows:
        return {"minutes": _DEFAULT_WINDOW_MIN, "basis": "default",
                "windows": 0}
    windows.sort()
    mid = windows[len(windows) // 2]
    lo, hi = _WINDOW_CLAMP
    return {"minutes": min(max(mid, lo), hi), "basis": "observed",
            "windows": len(windows)}


def observed_prewarm_cost_min(events, now=None):
    """Device-minute cost estimate for the prewarm step from measured
    evidence: the newest successful ``prewarm_kernel`` wall per key
    inside the last 24 h (``python -m tpukernels_torch.prewarm`` journals
    one a key), summed and clamped to the flap band. None when
    the journal holds no prewarm evidence yet — the spec's shipped
    ``cost_min`` then stands. A warm cache shrinks the estimate toward
    zero, which is exactly the point: a prewarmed suite should be
    admitted into windows the cold-compile guess would have deferred
    it out of."""
    now = time.time() if now is None else now
    horizon = now - 24 * 3600
    newest: dict = {}
    for ev in events:
        if ev.get("kind") != "prewarm_kernel":
            continue
        t = ev.get("t")
        if not isinstance(t, (int, float)) or t < horizon:
            continue
        if ev.get("status") not in (None, "ok"):
            continue
        kernel, wall = ev.get("kernel"), ev.get("wall_s")
        if kernel is None or not isinstance(wall, (int, float)):
            continue
        if kernel not in newest or t >= newest[kernel][0]:
            newest[kernel] = (t, wall)
    if not newest:
        return None
    total_min = sum(w for _t, w in newest.values()) / 60.0
    lo, hi = 0.5, _WINDOW_CLAMP[1]
    return round(min(max(total_min, lo), hi), 2)


# ------------------------------------------------------------------ #
# probe + backoff schedule                                            #
# ------------------------------------------------------------------ #

# the reference's question on the port: a host without a card fails the
# assert (dead, never alive), a wedged card hangs the synchronize, which
# kill_after's hard timeout ends
_PROBE_SNIPPET = (
    "import torch; assert torch.cuda.is_available(), 'no CUDA device'; "
    "x = torch.ones((8, 8), device='cuda'); (x @ x).sum().item(); "
    "torch.cuda.synchronize()"
)


def probe_alive(attempt: int = 0, timeout_s: float = 90.0) -> bool:
    """One liveness probe in a killable subprocess that does not inherit
    the lock fd; the fault plan's ``probe`` script ("ok"/"hang"/"dead")
    stands in for it, so a chaos run can flap the card deterministically."""
    # any consumed script entry is honored: "ok" is alive, everything
    # else ("hang"/"dead"/"error"/...) is not-alive — the supervisor
    # has no per-call retry concept, and falling through to a REAL
    # probe after journaling fault_injected would make a chaos run
    # claim an injection that never took effect
    injected = faults.probe_outcome()
    if injected is not None:
        alive = injected == "ok"
        journal.emit("probe", site="supervisor", attempt=attempt,
                     outcome="alive" if alive else injected,
                     injected=True)
        return alive
    proc, status = watchdog.kill_after(
        [sys.executable, "-c", _PROBE_SNIPPET], timeout_s,
        site="supervisor_probe", capture_output=True,
    )
    alive = status == "ok" and proc.returncode == 0
    journal.emit("probe", site="supervisor", attempt=attempt,
                 outcome="alive" if alive else
                 ("hang" if status == "timeout" else "error"))
    return alive


def probe_delay_s(attempt: int, base_s=None, cap_s=None) -> float:
    """Deterministic exponential backoff with jitter while the card is
    dead: ``min(cap, base*2^n)`` minus up to 25 % md5-derived jitter,
    the same for the same attempt (a resumed watcher reproduces the
    reference's schedule: the md5 salt is the reference's), but spread
    across attempts."""
    if base_s is None:
        base_s = float(os.environ.get("TPKT_SUPERVISOR_PROBE_BASE_S",
                                      30.0))
    if cap_s is None:
        cap_s = float(os.environ.get("TPKT_SUPERVISOR_PROBE_CAP_S",
                                     600.0))
    raw = min(cap_s, base_s * (2.0 ** min(attempt, 32)))
    digest = hashlib.md5(f"tpk-probe-{attempt}".encode()).digest()
    frac = int.from_bytes(digest[:4], "big") / 2 ** 32
    return round(raw * (1.0 - 0.25 * frac), 3)


# ------------------------------------------------------------------ #
# the supervisor                                                      #
# ------------------------------------------------------------------ #

LOCK_FD = 9


def lock_path() -> str | None:
    """The machine-wide queue lock: ``TPKT_REVALIDATE_LOCK``, else
    ``$HOME/.tpkt_gpu_wait.lock`` (None with neither: no world-writable
    fallback a local user could pre-hold)."""
    raw = os.environ.get("TPKT_REVALIDATE_LOCK")
    if raw:
        return raw
    home = os.environ.get("HOME")
    return os.path.join(home, ".tpkt_gpu_wait.lock") if home else None


def _inherited_lock_fds() -> tuple:
    """``python -m tpukernels_torch.revalidate`` holds the queue lock on
    fd 9. STEP children inherit that fd: if the supervisor dies mid-step,
    the orphaned card work still holds the lock and a new queue cannot
    interleave its runs with it (the orphan's hold is bounded by the
    step's timeout). PROBE children never do: a killable probe must not
    end up owning the lock. Returns ``(9,)`` only when fd 9 refers to
    the lock file."""
    path = lock_path()
    if not path:
        return ()
    try:
        st9 = os.fstat(LOCK_FD)
        stl = os.stat(path)
    except OSError:
        return ()
    if (st9.st_dev, st9.st_ino) == (stl.st_dev, stl.st_ino):
        return (LOCK_FD,)
    return ()


class Supervisor:
    def __init__(self, specs, repo=_REPO, checkpoint=None,
                 announce=True):
        """`announce=False` (the --plan preview) replays state without
        appending the supervisor_resume record — a read-only mode must
        not write the checkpoint it is reporting on."""
        self.specs = list(specs)
        self.repo = repo
        self.checkpoint = checkpoint or Checkpoint(checkpoint_path())
        self.state = self.checkpoint.replay()
        # this-run bookkeeping. _settled = "this run will not touch
        # this step again"; _attempted = "attempted or deliberately
        # skipped" and is what satisfies `after` edges — a DEFERRED
        # step settles without attempting, so its dependents stay
        # blocked and defer with it (c_scan_timing must not record a
        # number in a window where c_gate never ran)
        self._settled: set = set()
        self._attempted: set = set()
        self._deferred: list = []
        self._cost_override: dict = {}  # name -> measured cost_min
        self._last_rc: int | None = None
        self._last_wall_s: float = 0.0
        if self.state["events"] and announce:
            resumed = {
                n: s for n, s in self.state["steps"].items()
                if s["attempts"] or s["quarantined"]
            }
            interrupted = [n for n, s in resumed.items()
                           if s["interrupted"]]
            self.checkpoint.append(
                "supervisor_resume",
                green=[n for n, s in resumed.items() if s["green"]],
                quarantined=[n for n, s in resumed.items()
                             if s["quarantined"]],
                interrupted=interrupted,
            )
            journal.emit(
                "supervisor_resume", events=self.state["events"],
                green=[n for n, s in resumed.items() if s["green"]],
                quarantined=[n for n, s in resumed.items()
                             if s["quarantined"]],
                interrupted=interrupted,
            )
            if interrupted:
                print(f"# supervisor: resuming after interruption "
                      f"mid-{','.join(interrupted)}", file=sys.stderr)

    # -- state helpers ------------------------------------------------
    def _st(self, name):
        return self.state["steps"].setdefault(name, {
            "attempts": 0, "wedges": 0, "green": False,
            "quarantined": False, "interrupted": 0,
        })

    def _quarantined(self, spec) -> bool:
        s = self._st(spec.name)
        return s["quarantined"] or s["wedges"] >= spec.quarantine_after

    def _green(self, spec) -> bool:
        # stamp="never" means never skippable, not even by a same-day
        # green in the checkpoint: such a step (the SLO probe) runs on
        # every attempt
        if spec.stamp == "never":
            return False
        s = self._st(spec.name)
        if s["green"]:
            return True
        # honour a valid stamp even when this checkpoint never saw the
        # step (attempt-stamped steps are "done for today" by stamping,
        # green or not)
        return stamp_fresh(spec, self.repo)

    def _skip(self, spec, reason):
        self._settled.add(spec.name)
        self._attempted.add(spec.name)
        self.checkpoint.append("step_skipped", step=spec.name,
                               reason=reason)
        journal.emit("step_skipped", step=spec.name, reason=reason)
        print(f"supervisor: step '{spec.name}' skipped ({reason})")

    def _history_paths(self):
        """Journal files feeding the flap-window estimate. The journal
        rotates per day, so a run just after midnight must also read
        YESTERDAY's file or the estimator's documented 24 h horizon
        silently collapses to since-midnight and reverts to the
        optimistic default against an evening of observed flaps."""
        p = journal.path()
        if not p:
            return []
        paths = [p]
        m = re.match(r"health_(\d{4}-\d{2}-\d{2})\.jsonl$",
                     os.path.basename(p))
        if m:
            yday = (datetime.date.today()
                    - datetime.timedelta(days=1)).isoformat()
            paths.insert(0, os.path.join(os.path.dirname(p),
                                         f"health_{yday}.jsonl"))
        return paths   # load_events tolerates the missing-file case

    # -- scheduling ---------------------------------------------------
    def _schedulable(self, pending):
        return [s for s in pending
                if all(a in self._attempted for a in s.after)]

    def _cost_min(self, spec) -> float:
        """Effective device-minute cost for admission: this run's
        measured refinement when one exists, else the shipped
        estimate. Kept OFF the spec object: PRODUCTION_QUEUE specs are
        module-level and shared by every Supervisor a watch process
        builds — mutating them would make later runs' "prior" the last
        estimate instead of the shipped cost."""
        return self._cost_override.get(spec.name, spec.cost_min)

    def _density(self, spec) -> float:
        return spec.value / max(self._cost_min(spec), 0.01)

    def plan(self, remaining_min: float, may_force: bool):
        """Pick the next step for the remaining window budget: highest
        value-per-device-minute among schedulable steps whose cost fits
        (CPU-only steps always fit). When nothing fits and the window
        is still untouched (`may_force`), the best-density chip step
        is forced — estimates are estimates, and admitting nothing
        forever is the one unacceptable schedule. Returns
        (spec, forced) or (None, False) when nothing is schedulable."""
        pending = [s for s in self.specs
                   if s.name not in self._settled]
        sched = self._schedulable(pending)
        if not sched:
            return None, False
        sched.sort(key=lambda s: -self._density(s))
        fits = [s for s in sched
                if not s.needs_chip
                or self._cost_min(s) <= remaining_min]
        if fits:
            return fits[0], False
        if may_force:
            return sched[0], True
        return None, False

    # -- execution ----------------------------------------------------
    def _run_step(self, spec: StepSpec, forced: bool) -> str:
        st = self._st(spec.name)
        st["attempts"] += 1
        self.checkpoint.append("step_start", step=spec.name,
                               attempt=st["attempts"],
                               gating=spec.gating, forced=forced,
                               timeout_s=spec.timeout_s,
                               cost_min=self._cost_min(spec))
        journal.emit("step_start", step=spec.name,
                     attempt=st["attempts"], gating=spec.gating,
                     forced=forced)
        # chaos injection point: the SIGKILL-mid-step proof fires HERE
        # — after step_start is durably checkpointed, before any
        # outcome can be — the worst instant for resume correctness
        faults.supervisor_fault(spec.name)
        if spec.stamp == "attempt":
            write_stamp(spec.name, self.repo)  # attempted = done today
        t0 = time.time()
        with trace.span(f"step/{spec.name}", gating=spec.gating,
                        cost_min=spec.cost_min):
            proc, status = watchdog.kill_after(
                ["bash", "-c", spec.shell], spec.timeout_s,
                site=f"step/{spec.name}", cwd=self.repo,
                pass_fds=_inherited_lock_fds(),
            )
        wall = round(time.time() - t0, 3)
        if status == "timeout":
            alive = probe_alive()
            verdict = watchdog.classify_timeout(alive, step=spec.name)
            outcome = WEDGED if verdict == "wedged" else SLOW
            rc = None
        else:
            rc = proc.returncode
            outcome = GREEN if rc == 0 else FAILED
        if outcome == WEDGED:
            st["wedges"] += 1
        if outcome == GREEN:
            st["green"] = True
            if spec.stamp == "daily":
                write_stamp(spec.name, self.repo)
        metrics.inc(f"supervisor.steps_{outcome}")
        self.checkpoint.append("step_done", step=spec.name,
                               outcome=outcome, rc=rc, wall_s=wall,
                               wedges_today=st["wedges"])
        journal.emit("step_done", step=spec.name, outcome=outcome,
                     rc=rc, wall_s=wall, wedges_today=st["wedges"])
        # no wall time on stdout: the same queue prints the same bytes
        # with the journal on or off; wall time lives in the checkpoint,
        # the journal and the reports
        print(f"supervisor: step '{spec.name}' {outcome}"
              + (f" (rc={rc})" if rc not in (0, None) else ""))
        if (outcome == WEDGED
                and st["wedges"] >= spec.quarantine_after
                and not st["quarantined"]):
            self._quarantine(spec, st)
        self._settled.add(spec.name)
        self._attempted.add(spec.name)
        self._last_rc = rc
        self._last_wall_s = wall
        return outcome

    def _quarantine(self, spec, st):
        st["quarantined"] = True
        metrics.inc("supervisor.steps_quarantined")
        self.checkpoint.append("step_quarantined", step=spec.name,
                               wedges=st["wedges"],
                               threshold=spec.quarantine_after)
        journal.emit("step_quarantined", step=spec.name,
                     wedges=st["wedges"],
                     threshold=spec.quarantine_after)
        print(f"supervisor: step '{spec.name}' QUARANTINED after "
              f"{st['wedges']} wedge(s) today - demoted to non-gating,"
              " next window goes to the next step", file=sys.stderr)

    def run_queue(self) -> int:
        """One queue attempt (one healthy window). Returns the
        exit-code contract value (RC_* above)."""
        # the env-derived hardware stamp: the supervisor never opens a
        # CUDA context (a wedged card would hang the whole queue), so
        # the probe stays off; the step children that touch the card
        # stamp their own probed inventories
        from tpukernels_torch.obs import scaling as _scaling

        _scaling.emit_inventory("supervisor")
        events, _bad = journal.load_events(self._history_paths())
        est = estimate_window_minutes(events)
        # measured-cost refinement: steps that opted in (cost_from)
        # re-derive their device-minute estimate from journal evidence
        # BEFORE admission, so the value-density ordering and the
        # window fit both see real compile walls. Journal-only (not
        # checkpointed): an estimate is scheduling input, not state.
        for spec in self.specs:
            if spec.cost_from == "prewarm":
                obs = observed_prewarm_cost_min(events)
                if obs is not None and obs != spec.cost_min:
                    journal.emit("step_cost_estimated", step=spec.name,
                                 cost_min=obs,
                                 prior_cost_min=spec.cost_min,
                                 basis="prewarm_kernel")
                    self._cost_override[spec.name] = obs
        journal.emit("window_estimate", minutes=est["minutes"],
                     basis=est["basis"], windows=est["windows"])
        print(f"supervisor: healthy-window estimate "
              f"{est['minutes']:.1f} min ({est['basis']}, "
              f"{est['windows']} observed)")
        remaining = est["minutes"]
        chip_spent = 0.0
        with trace.span("queue/run", window_min=remaining):
            while True:
                # pre-pass: settle green/quarantined/exhausted steps so
                # dependency edges and the planner see only real work
                for spec in self.specs:
                    if spec.name in self._settled:
                        continue
                    if self._green(spec):
                        self._skip(spec, "green-today")
                    elif self._quarantined(spec):
                        st = self._st(spec.name)
                        if not st["quarantined"]:
                            self._quarantine(spec, st)
                        self._skip(spec, "quarantined")
                    elif (self._st(spec.name)["attempts"]
                          >= spec.max_attempts_per_day):
                        self._skip(spec, "attempts-exhausted")
                spec, forced = self.plan(
                    remaining, may_force=chip_spent == 0.0)
                if spec is None:
                    # nothing fits the remaining window: defer the
                    # rest of the chip work to the next healthy window
                    # (rc 2 — incomplete, retryable). Steps blocked on a deferred
                    # dependency defer WITH it — an `after` edge means
                    # "ran first", and deferral is not an attempt.
                    rest = self._schedulable(
                        [s for s in self.specs
                         if s.name not in self._settled])
                    if not rest:
                        for s in self.specs:
                            if s.name not in self._settled:
                                self._defer(s, "dependency-deferred")
                        break
                    for s in rest:
                        self._defer(s)
                    continue
                outcome = self._run_step(spec, forced)
                if spec.needs_chip:
                    chip_spent += max(self._last_wall_s / 60.0, 0.0)
                    remaining -= max(self._last_wall_s / 60.0, 0.0)
                if outcome == WEDGED:
                    # the window is gone: defer every remaining chip
                    # step and go back to probing (rc 124, retryable)
                    for rest in self.specs:
                        if (rest.name not in self._settled
                                and rest.needs_chip):
                            self._defer(rest)
                    print("supervisor: card WEDGED - returning to "
                          "probe duty", file=sys.stderr)
                    return RC_WEDGE
                if outcome == SLOW and spec.gating:
                    # timed out but the card answers: loud, gating,
                    # retryable by contract (the `timeout` rc)
                    print(f"supervisor: gating step '{spec.name}' "
                          "timed out (card alive)", file=sys.stderr)
                    return RC_WEDGE
                if outcome == FAILED and spec.gating:
                    rc = self._last_rc or 1
                    print(f"supervisor: gating step '{spec.name}' "
                          f"FAILED rc={rc} - aborting queue",
                          file=sys.stderr)
                    return rc if rc != RC_GREEN else 1
        return self._final_rc()

    def _defer(self, spec, reason="deferred-window"):
        self._deferred.append(spec.name)
        self._settled.add(spec.name)   # NOT _attempted: deps stay blocked
        self.checkpoint.append("step_skipped", step=spec.name,
                               reason=reason)
        journal.emit("step_skipped", step=spec.name,
                     reason=reason, cost_min=spec.cost_min)
        print(f"supervisor: step '{spec.name}' deferred ({reason})")

    def _final_rc(self) -> int:
        deferred_gating = [
            n for n in self._deferred
            if any(s.name == n and s.gating for s in self.specs)
        ]
        quarantined = [s.name for s in self.specs
                       if self._st(s.name)["quarantined"]]
        not_green = [
            s.name for s in self.specs
            if s.gating and not self._st(s.name)["green"]
            and s.name not in quarantined
            and not (s.stamp in ("daily", "attempt")
                     and stamp_fresh(s, self.repo))
        ]
        if quarantined:
            print("supervisor: QUARANTINED steps (wedged repeatedly, "
                  f"demoted to non-gating): {','.join(quarantined)}",
                  file=sys.stderr)
        if deferred_gating or not_green:
            print(f"supervisor: queue INCOMPLETE (deferred="
                  f"{','.join(deferred_gating) or '-'} "
                  f"pending={','.join(not_green) or '-'}) - "
                  "retryable next window")
            return RC_INCOMPLETE
        print("supervisor: queue GREEN")
        return RC_GREEN


# ------------------------------------------------------------------ #
# watch loop                                                          #
# ------------------------------------------------------------------ #

def watch(make_supervisor, max_hours: float, harvest=None,
          sleep=time.sleep) -> int:
    """Probe the card and run the queue on every healthy probe until the
    first fully green queue or the deadline, backing off exponentially
    with deterministic jitter between probes; every scheduling decision
    is journaled (``probe_scheduled``). ``make_supervisor`` builds a
    FRESH Supervisor an attempt (each attempt replays the latest
    checkpoint); ``harvest`` (optional) runs once after the first green
    queue, never gating.

    Exit codes (the reference's): 0 green; 1 deadline; a gating step's
    rc when it failed with the card still healthy (a deterministic
    failure: retrying cannot fix it); never exits on rc 124/2 (a wedge
    and incomplete coverage are what the watch exists to ride out)."""
    deadline = time.time() + max_hours * 3600
    dead_streak = 0
    while time.time() < deadline:
        if probe_alive(attempt=dead_streak):
            dead_streak = 0
            now = datetime.datetime.now().isoformat(timespec="seconds")
            print(f"supervisor: card ALIVE at {now}; running queue")
            rc = make_supervisor().run_queue()
            if rc == RC_GREEN:
                print(f"supervisor: revalidation PASSED at "
                      f"{datetime.datetime.now().isoformat(timespec='seconds')}")
                if harvest is not None:
                    harvest()
                return RC_GREEN
            # wedge (124) and incomplete coverage (2) are ALWAYS
            # retryable; any other failure with the card still
            # answering is deterministic: surface it, do not re-run the
            # expensive queue against it for hours
            if (rc not in (RC_WEDGE, RC_INCOMPLETE)
                    and probe_alive(attempt=0)):
                print(f"supervisor: queue FAILED (rc={rc}) with the "
                      "card still healthy - deterministic failure; "
                      "exiting", file=sys.stderr)
                return rc
            print(f"supervisor: queue attempt rc={rc} (wedge or "
                  "incomplete coverage); back on probe duty")
        else:
            dead_streak += 1
        delay = probe_delay_s(dead_streak)
        journal.emit("probe_scheduled", attempt=dead_streak,
                     delay_s=delay,
                     reason="card-dead" if dead_streak else
                     "post-attempt")
        print(f"supervisor: next probe in {delay:.0f}s "
              f"(attempt {dead_streak})")
        sleep(delay)
    print(f"supervisor: gave up after {max_hours}h")
    return 1
