"""The port's revalidation supervisor against the reference's, on the CPU.

``tpukernels_torch/resilience/supervisor.py`` behind ``python -m
tpukernels_torch.revalidate`` must take the decisions
``tpukernels/resilience/supervisor.py`` behind ``tools/revalidate.py``
takes. The same stub queue goes through both CLIs, each in its own
temporary state, for the cases of ``tests/test_supervisor.py``: a
SIGKILL mid-step and the resume, two wedges and the quarantine, a
``stamp="never"`` step, a gating and a non-gating failure, window
deferral and density, a dependent of a deferred step, a forced step when
nothing fits, dependency edges under density. Each side gives the same
exit codes, the same ``step_done`` outcomes, the same executed steps and
the same ``Checkpoint.replay()`` state. The planner, the window and cost
estimates, the probe backoff and the git-aware stamps are held against
the reference's on equal inputs in this process, every reference call
under ``mock.patch.dict(os.environ)`` with its state in ``tmp_path``.
The supervisors themselves run only in subprocesses, and nothing new
appears under ``docs/logs/``.
"""

import json
import os
import random
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import pytest

from tpukernels.resilience import faults as ref_faults
from tpukernels.resilience import supervisor as ref
from tpukernels_torch.resilience import faults
from tpukernels_torch.resilience import supervisor as port

ROOT = Path(__file__).resolve().parent.parent
REF_CLI = ROOT / "tools" / "revalidate.py"
DOCS_LOGS = ROOT / "docs" / "logs"

# every knob either side reads, cleared from the children's env
_KNOBS = ("FAULT_PLAN", "REVALIDATE_FORCE", "SUPERVISOR_WINDOW_MIN", "TRACE",
          "SUPERVISOR_CHECKPOINT", "REVALIDATE_STAMP_DIR", "HEALTH_JOURNAL",
          "SUPERVISOR_QUEUE", "SUPERVISOR_PROBE_BASE_S",
          "SUPERVISOR_PROBE_CAP_S")


@pytest.fixture(autouse=True)
def docs_logs_untouched():
    before = sorted(os.listdir(DOCS_LOGS)) if DOCS_LOGS.exists() else []
    yield
    after = sorted(os.listdir(DOCS_LOGS)) if DOCS_LOGS.exists() else []
    assert after == before


def _env(side, d, plan=None, window=None):
    env = {k: v for k, v in os.environ.items()
           if not any(k in (f"TPK_{n}", f"TPKT_{n}") for n in _KNOBS)}
    if side == "ref":
        env.update(TPK_SUPERVISOR_CHECKPOINT=str(d / "checkpoint.jsonl"),
                   TPK_REVALIDATE_STAMP_DIR=str(d / "stamps"),
                   TPK_HEALTH_JOURNAL=str(d / "health.jsonl"))
        pre = "TPK_"
    else:
        env.update(TPKT_SUPERVISOR_DIR=str(d / "state"),
                   TPKT_SUPERVISOR_CHECKPOINT=str(d / "checkpoint.jsonl"),
                   TPKT_HEALTH_JOURNAL=str(d / "health.jsonl"),
                   TPKT_REVALIDATE_LOCK=str(d / "gpu_wait.lock"))
        pre = "TPKT_"
    if plan is not None:
        env[pre + "FAULT_PLAN"] = json.dumps(plan)
    if window is not None:
        env[pre + "SUPERVISOR_WINDOW_MIN"] = str(window)
    return env


def _cli(side, queue, env, args=()):
    cmd = ([sys.executable, str(REF_CLI)] if side == "ref"
           else [sys.executable, "-m", "tpukernels_torch.revalidate"])
    return subprocess.run([*cmd, "--queue", str(queue), *args], env=env,
                          capture_output=True, text=True, timeout=120,
                          cwd=ROOT)


def _events(path, kind):
    if not os.path.exists(path):
        return []
    return [r for r in map(json.loads, open(path).read().splitlines())
            if r.get("kind") == kind]


def _log_step(d, name):
    return {"shell": f"echo {name} >> {d / 'runlog'}"}


# each case: its steps (a "log" step appends its name to a runlog) and
# its runs, (fault plan, window minutes) each
CASES = {
    "sigkill_resume": (
        [dict(name="a", log=True, cost_min=1, value=10, needs_chip=False),
         dict(name="b", log=True, cost_min=1, value=5, needs_chip=False),
         dict(name="c", log=True, cost_min=1, value=1, needs_chip=False)],
        [({"kill_supervisor": {"step": "b"}}, None), (None, None),
         (None, None)]),
    "wedged_twice_quarantined": (
        [dict(name="w", shell="sleep 60", timeout_s=1, cost_min=1,
              value=10, quarantine_after=2),
         dict(name="x", log=True, cost_min=1, value=5, needs_chip=False)],
        [({"probe": ["dead"]}, 30), ({"probe": ["dead"]}, 30), (None, 30)]),
    "stamp_never": (
        [dict(name="canary", log=True, stamp="never", cost_min=1, value=10,
              needs_chip=False),
         dict(name="daily", log=True, cost_min=1, value=5,
              needs_chip=False)],
        [(None, None), (None, None)]),
    "gating_vs_nongating": (
        [dict(name="soft", shell="exit 9", gating=False, cost_min=1,
              value=10, needs_chip=False),
         dict(name="hard", shell="exit 7", cost_min=1, value=5,
              needs_chip=False),
         dict(name="after", log=True, cost_min=1, value=1,
              needs_chip=False)],
        [(None, None)]),
    "window_deferral_density": (
        [dict(name="big", log=True, cost_min=20, value=100),
         dict(name="small", log=True, cost_min=3, value=10)],
        [({"probe": ["ok"]}, 5), (None, 30)]),
    "dependent_of_deferred": (
        [dict(name="small", log=True, cost_min=3, value=1),
         dict(name="gate", log=True, cost_min=18, value=60),
         dict(name="timing", log=True, cost_min=1, value=25,
              after=["gate"])],
        [(None, 12)]),
    "nothing_fits_forced": (
        [dict(name="only", log=True, cost_min=20, value=10)],
        [(None, 2)]),
    "dependency_under_density": (
        [dict(name="pre", log=True, cost_min=10, value=1),
         dict(name="main", log=True, cost_min=1, value=100,
              after=["pre"])],
        [(None, 30)]),
}


def _drive(side, d, steps, runs):
    d.mkdir()
    (d / "runlog").write_text("")
    q = []
    for st in steps:
        st = dict(st)
        if st.pop("log", False):
            st.update(_log_step(d, st["name"]))
        q.append(st)
    qf = d / "queue.json"
    qf.write_text(json.dumps(q))
    rcs = []
    for plan, window in runs:
        p = _cli(side, qf, _env(side, d, plan, window))
        rcs.append(p.returncode)
    cp = d / "checkpoint.jsonl"
    dones = [(e["step"], e["outcome"], e["rc"])
             for e in _events(cp, "step_done")]
    skips = [(e["step"], e["reason"]) for e in _events(cp, "step_skipped")]
    starts = [(e["step"], e["attempt"], e["forced"])
              for e in _events(cp, "step_start")]
    return {"rcs": rcs, "dones": dones, "skips": skips, "starts": starts,
            "ran": (d / "runlog").read_text().split()}, cp


@pytest.mark.parametrize("case", sorted(CASES))
def test_stub_queue_decisions_equal_the_references(tmp_path, case):
    steps, runs = CASES[case]
    got, port_cp = _drive("port", tmp_path / "port", steps, runs)
    want, ref_cp = _drive("ref", tmp_path / "ref", steps, runs)
    assert got == want
    assert got["dones"] or got["skips"]
    # each side's replay of its own checkpoint, and the reference's
    # checkpoint replayed by the port's Checkpoint
    assert port.Checkpoint(str(port_cp)).replay() == \
        ref.Checkpoint(str(ref_cp)).replay()
    assert port.Checkpoint(str(ref_cp)).replay() == \
        ref.Checkpoint(str(ref_cp)).replay()


def test_the_kill_and_resume_ran_as_the_reference_says(tmp_path):
    """The sigkill case's particulars on the port: rc -9, the step that
    was killed re-ran and the green one did not, the resume names them."""
    steps, runs = CASES["sigkill_resume"]
    got, cp = _drive("port", tmp_path / "port", steps, runs)
    assert got["rcs"] == [-9, 0, 0]
    assert got["ran"] == ["a", "b", "c"]
    resume = _events(cp, "supervisor_resume")
    assert resume[0]["interrupted"] == ["b"] and resume[0]["green"] == ["a"]
    # the fault journaled, as the reference's does
    (fault,) = _events(tmp_path / "port" / "health.jsonl", "fault_injected")
    assert (fault["site"], fault["step"]) == ("supervisor", "b")


def test_quarantine_on_the_port(tmp_path):
    steps, runs = CASES["wedged_twice_quarantined"]
    got, cp = _drive("port", tmp_path / "port", steps, runs)
    assert got["rcs"] == [124, 124, 0]
    assert [o for _s, o, _r in got["dones"]] == ["wedged", "wedged", "green"]
    (q,) = _events(cp, "step_quarantined")
    assert (q["step"], q["wedges"], q["threshold"]) == ("w", 2, 2)
    h = tmp_path / "port" / "health.jsonl"
    verdicts = [e["verdict"] for e in _events(h, "wedge_classification")]
    assert verdicts == ["wedged", "wedged"]


# ------------------------------------------------- in-process parity


def _ref_call(tmp_path, fn, *args, env=None, **kw):
    """A reference call under its own state in tmp_path; both packages'
    fault plans reloaded once the env is restored, so nothing leaks into
    later tests."""
    try:
        with mock.patch.dict(os.environ):
            for n in _KNOBS:
                os.environ.pop(f"TPK_{n}", None)
            os.environ.update({
                "TPK_SUPERVISOR_CHECKPOINT": str(tmp_path / "ref_cp.jsonl"),
                "TPK_REVALIDATE_STAMP_DIR": str(tmp_path / "ref_stamps"),
                "TPK_HEALTH_JOURNAL": str(tmp_path / "ref_health.jsonl"),
                **(env or {})})
            return fn(*args, **kw)
    finally:
        _no_plan_left()


def _port_call(tmp_path, fn, *args, env=None, **kw):
    try:
        with mock.patch.dict(os.environ):
            for n in _KNOBS:
                os.environ.pop(f"TPKT_{n}", None)
            os.environ.update({
                "TPKT_SUPERVISOR_DIR": str(tmp_path / "port_state"),
                "TPKT_HEALTH_JOURNAL": str(tmp_path / "port_health.jsonl"),
                **(env or {})})
            return fn(*args, **kw)
    finally:
        _no_plan_left()


def _no_plan_left():
    """Reload both fault plans from the restored env: neither package may
    keep a test's plan active."""
    ref_faults.reload_plan()
    faults.reload_plan()
    assert not ref_faults.active()
    assert not faults.active()


PLAN_SPECS = [
    dict(name="pre", shell="true", cost_min=12, value=50),
    dict(name="probe1", shell="true", cost_min=2, value=12, after=["pre"]),
    dict(name="probe2", shell="true", cost_min=2, value=10, after=["pre"]),
    dict(name="sweep", shell="true", cost_min=3, value=11, after=["pre"]),
    dict(name="gate", shell="true", cost_min=18, value=60),
    dict(name="timing", shell="true", cost_min=10, value=25,
         after=["gate"]),
    dict(name="cpu_a", shell="true", cost_min=1, value=5, needs_chip=False,
         after=["probe1", "probe2"]),
    dict(name="cpu_b", shell="true", cost_min=25, value=3, needs_chip=False),
    dict(name="big", shell="true", cost_min=40, value=100),
]


@pytest.mark.parametrize("remaining", [0.5, 2.0, 5.0, 12.0, 25.0, 60.0])
@pytest.mark.parametrize("may_force", [False, True])
def test_plan_order_equals_the_references(tmp_path, remaining, may_force):
    def order(mod, cp):
        sup = mod.Supervisor([mod.StepSpec.from_dict(d) for d in PLAN_SPECS],
                             checkpoint=mod.Checkpoint(str(cp)),
                             announce=False)
        out = []
        while True:
            spec, forced = sup.plan(remaining, may_force=may_force)
            if spec is None:
                return out
            out.append((spec.name, forced))
            sup._settled.add(spec.name)
            sup._attempted.add(spec.name)

    want = _ref_call(tmp_path, order, ref, tmp_path / "r.jsonl")
    got = _port_call(tmp_path, order, port, tmp_path / "p.jsonl")
    assert got == want


def _flap_events(seed):
    rng = random.Random(seed)
    t0 = 1.79e9
    events, t = [], t0
    for _ in range(rng.randint(0, 12)):
        t += rng.uniform(10, 3000)
        kind = rng.choice(["probe", "probe", "wedge_classification",
                           "step_done", "prewarm_kernel", "span"])
        e = {"kind": kind, "t": t}
        if kind == "probe":
            e["outcome"] = rng.choice(["alive", "alive", "hang", "error"])
        elif kind == "wedge_classification":
            e["verdict"] = rng.choice(["wedged", "slow"])
        elif kind == "step_done":
            e["outcome"] = rng.choice(["wedged", "green", "failed"])
        elif kind == "prewarm_kernel":
            e.update(kernel=rng.choice(["sgemm", "scan", "nbody"]),
                     wall_s=rng.uniform(0.1, 900),
                     status=rng.choice([None, "ok", "error"]))
        events.append(e)
    return events, t + rng.uniform(0, 40000)


@pytest.mark.parametrize("seed", range(12))
def test_window_and_cost_estimates_equal_the_references(tmp_path, seed):
    events, now = _flap_events(seed)
    for fn in ("estimate_window_minutes", "observed_prewarm_cost_min"):
        want = _ref_call(tmp_path, getattr(ref, fn), events, now=now)
        got = _port_call(tmp_path, getattr(port, fn), events, now=now)
        assert got == want, fn


def test_pinned_window_equals_the_references(tmp_path):
    for raw in ("7", "0.5", "junk"):
        want = _ref_call(tmp_path, ref.estimate_window_minutes, [],
                         now=1.0, env={"TPK_SUPERVISOR_WINDOW_MIN": raw})
        got = _port_call(tmp_path, port.estimate_window_minutes, [],
                         now=1.0, env={"TPKT_SUPERVISOR_WINDOW_MIN": raw})
        assert got == want


@pytest.mark.parametrize("base_cap", [None, (30, 600), (0.02, 0.05),
                                      (1.5, 100.0)])
def test_probe_delay_schedule_equals_the_references(tmp_path, base_cap):
    kw = {} if base_cap is None else dict(base_s=base_cap[0],
                                          cap_s=base_cap[1])
    want = _ref_call(tmp_path, lambda: [ref.probe_delay_s(n, **kw)
                                        for n in range(41)])
    got = _port_call(tmp_path, lambda: [port.probe_delay_s(n, **kw)
                                        for n in range(41)])
    assert got == want
    env = {"BASE_S": "0.5", "CAP_S": "9"}
    want = _ref_call(tmp_path, lambda: [ref.probe_delay_s(n)
                                        for n in range(41)],
                     env={f"TPK_SUPERVISOR_PROBE_{k}": v
                          for k, v in env.items()})
    got = _port_call(tmp_path, lambda: [port.probe_delay_s(n)
                                        for n in range(41)],
                     env={f"TPKT_SUPERVISOR_PROBE_{k}": v
                          for k, v in env.items()})
    assert got == want


def test_a_reference_checkpoint_replays_the_same(tmp_path):
    """Records appended by the reference's Checkpoint (every kind replay
    reads, an interrupted attempt, yesterday's lines) replay to the same
    state under the port's, and the other way round."""
    def fill(mod, path):
        cp = mod.Checkpoint(str(path))
        for kind, fields in (
                ("step_start", dict(step="a", attempt=1)),
                ("step_done", dict(step="a", outcome="green", rc=0)),
                ("step_start", dict(step="w", attempt=1)),
                ("step_done", dict(step="w", outcome="wedged", rc=None)),
                ("step_start", dict(step="w", attempt=2)),
                ("step_done", dict(step="w", outcome="wedged", rc=None)),
                ("step_quarantined", dict(step="w", wedges=2)),
                ("step_start", dict(step="k", attempt=1)),
                ("step_skipped", dict(step="z", reason="deferred-window")),
                ("supervisor_resume", dict(green=["a"]))):
            cp.append(kind, **fields)
        with open(path, "a") as f:
            f.write(json.dumps({"ts": "2001-01-01T00:00:00", "kind":
                                "step_done", "step": "a",
                                "outcome": "wedged"}) + "\n")
            f.write("{torn\n")
        return cp

    rp, pp = tmp_path / "ref.jsonl", tmp_path / "port.jsonl"
    _ref_call(tmp_path, fill, ref, rp)
    _port_call(tmp_path, fill, port, pp)
    want = ref.Checkpoint(str(rp)).replay()
    assert want["steps"]["k"]["interrupted"] == 1
    assert port.Checkpoint(str(rp)).replay() == want
    assert ref.Checkpoint(str(pp)).replay() == \
        port.Checkpoint(str(pp)).replay() == want


@pytest.fixture
def git_repo(tmp_path):
    repo = tmp_path / "repo"
    repo.mkdir()
    for f in ("bench.py", "other.txt", "chip_smoke.py"):
        (repo / f).write_text("# v1\n")

    def git(*args):
        return subprocess.run(
            ["git", "-C", str(repo), *args], capture_output=True,
            text=True, timeout=30, check=True,
            env={**os.environ, "GIT_AUTHOR_NAME": "t",
                 "GIT_AUTHOR_EMAIL": "t@t", "GIT_COMMITTER_NAME": "t",
                 "GIT_COMMITTER_EMAIL": "t@t"})

    git("init", "-q")
    git("add", "-A")
    git("commit", "-qm", "seed")
    return repo, git


def test_stamp_freshness_equals_the_references(tmp_path, git_repo):
    """One stamp directory read by both sides: a stamp either writes is
    fresh to both, a commit that does not touch the inputs leaves it
    fresh, one that does makes it stale for both, and FORCE re-runs."""
    repo, git = git_repo
    stamps = tmp_path / "stamps"
    env_r = {"TPK_REVALIDATE_STAMP_DIR": str(stamps)}
    env_p = {"TPKT_REVALIDATE_STAMP_DIR": str(stamps)}
    spec_r = ref.StepSpec("s1", "true", inputs=("bench.py",))
    spec_p = port.StepSpec("s1", "true", inputs=("bench.py",))

    def both():
        r = _ref_call(tmp_path, ref.stamp_fresh, spec_r, repo=str(repo),
                      env=env_r)
        p = _port_call(tmp_path, port.stamp_fresh, spec_p, repo=str(repo),
                       env=env_p)
        assert r == p
        return p

    assert both() is False                       # no stamp yet
    _ref_call(tmp_path, ref.write_stamp, "s1", repo=str(repo), env=env_r)
    assert both() is True
    (repo / "other.txt").write_text("y\n")
    git("commit", "-qam", "unrelated")
    assert both() is True
    (repo / "bench.py").write_text("# v2\n")
    git("commit", "-qam", "touch the input")
    assert both() is False
    _port_call(tmp_path, port.write_stamp, "s1", repo=str(repo), env=env_p)
    assert both() is True
    assert (stamps / f"s1_{time.strftime('%Y-%m-%d')}.done").read_text() \
        .strip() == git("rev-parse", "HEAD").stdout.strip()
    env_r["TPK_REVALIDATE_FORCE"] = "1"
    env_p["TPKT_REVALIDATE_FORCE"] = "1"
    assert both() is False
    del env_r["TPK_REVALIDATE_FORCE"], env_p["TPKT_REVALIDATE_FORCE"]
    # a sha-less stamp is honoured on the wall clock alone, by both
    (stamps / f"s1_{time.strftime('%Y-%m-%d')}.done").write_text("")
    (repo / "bench.py").write_text("# v3\n")
    git("commit", "-qam", "touch it again")
    assert both() is True


def test_default_stamp_inputs_are_the_ports(tmp_path, git_repo):
    """With no inputs a step's stamp goes stale on a commit to the port,
    the C drivers or chip_smoke.py, not on one to the reference."""
    repo, git = git_repo
    env = {"TPKT_REVALIDATE_STAMP_DIR": str(tmp_path / "stamps")}
    spec = port.StepSpec("s2", "true")
    assert port.DEFAULT_INPUTS == ("tpukernels_torch", "c", "chip_smoke.py")
    _port_call(tmp_path, port.write_stamp, "s2", repo=str(repo), env=env)
    (repo / "bench.py").write_text("# reference side\n")
    git("commit", "-qam", "a reference file")
    assert _port_call(tmp_path, port.stamp_fresh, spec, repo=str(repo),
                      env=env)
    (repo / "chip_smoke.py").write_text("# v2\n")
    git("commit", "-qam", "the script on the card")
    assert not _port_call(tmp_path, port.stamp_fresh, spec, repo=str(repo),
                          env=env)


def test_state_lives_under_the_supervisor_dir(tmp_path):
    def paths():
        return port.checkpoint_path(), port.stamp_dir()

    day = time.strftime("%Y-%m-%d")
    cp, st = _port_call(tmp_path, paths)
    base = tmp_path / "port_state"
    assert (cp, st) == (str(base / f"supervisor_{day}.jsonl"),
                        str(base / ".revalidate_stamps"))
    # the two knobs move the checkpoint (a file or a directory) and the
    # stamps alone
    (tmp_path / "cpdir").mkdir()
    cp, st = _port_call(tmp_path, paths, env={
        "TPKT_SUPERVISOR_CHECKPOINT": str(tmp_path / "cpdir"),
        "TPKT_REVALIDATE_STAMP_DIR": str(tmp_path / "s")})
    assert (cp, st) == (str(tmp_path / "cpdir" / f"supervisor_{day}.jsonl"),
                        str(tmp_path / "s"))
    # unset, it is the repository's .tpkt_cache/supervisor
    with mock.patch.dict(os.environ):
        for n in _KNOBS + ("SUPERVISOR_DIR",):
            os.environ.pop(f"TPKT_{n}", None)
        assert port.checkpoint_path() == str(
            ROOT / ".tpkt_cache" / "supervisor" / f"supervisor_{day}.jsonl")


def test_fault_points_equal_the_references(tmp_path):
    """``probe_outcome`` walks the plan's script as the reference's does,
    and ``hang_probe`` is its sugar; both journal ``fault_injected``."""
    plans = [{"probe": ["hang", "dead", "ok"]}, {"hang_probe": 2},
             {"probe": ["ok"]}, {"kill_supervisor": "x"}]
    for plan in plans:
        def walk(mod, fm):
            fm.reload_plan()
            return [fm.probe_outcome() for _ in range(5)]

        want = _ref_call(tmp_path, walk, ref, ref_faults,
                         env={"TPK_FAULT_PLAN": json.dumps(plan)})
        got = _port_call(tmp_path, walk, port, faults,
                         env={"TPKT_FAULT_PLAN": json.dumps(plan)})
        assert got == want, plan
    injected = [e for e in map(json.loads, open(
        tmp_path / "port_health.jsonl").read().splitlines())
        if e["kind"] == "fault_injected"]
    assert injected and all(e["site"] == "probe" for e in injected)
    # a kill_supervisor plan for another step does nothing here
    _port_call(tmp_path, lambda: (faults.reload_plan(),
                                  faults.supervisor_fault("y")),
               env={"TPKT_FAULT_PLAN": json.dumps({"kill_supervisor":
                                                   {"step": "x"}})})
