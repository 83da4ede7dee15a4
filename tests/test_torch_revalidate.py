"""``python -m tpukernels_torch.revalidate`` on the CPU: its production
queue against the reference's, its exit codes, its lock and its probe.

- :data:`PRODUCTION_QUEUE` plus :data:`WAITING` (now empty) name exactly
  the steps of the reference's ``tools/revalidate.py``; each ported step
  keeps the reference's name, gating, stamp policy, timeout, cost, value,
  ``needs_chip``, attempts a day and dependencies, every ``after`` edge
  resolves, every body parses, and no body names the reference
  (``tools/``, ``bench.py``, ``tpukernels.``) or JAX.
- The exit-code contract: 0 green, 2 incomplete, 124 wedge, a gating
  step's rc, 3 lock held, 64 usage; ``--whos-holding``; step children
  inherit the lock fd 9, probe children do not.
- The supervisor and the CLI import no torch, and the probe says dead on
  a host without a card and alive with one.
Every run is a subprocess with its state and lock in ``tmp_path``;
nothing new appears under ``docs/logs/``.
"""

import json
import os
import re
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest

import tools.revalidate as ref_cli
from tpukernels_torch import revalidate
from tpukernels_torch.resilience import supervisor

ROOT = Path(__file__).resolve().parent.parent
DOCS_LOGS = ROOT / "docs" / "logs"


@pytest.fixture(autouse=True)
def docs_logs_untouched():
    before = sorted(os.listdir(DOCS_LOGS)) if DOCS_LOGS.exists() else []
    yield
    after = sorted(os.listdir(DOCS_LOGS)) if DOCS_LOGS.exists() else []
    assert after == before


def _env(tmp_path, plan=None, **extra):
    env = {k: v for k, v in os.environ.items() if not k.startswith("TPKT_")}
    env.update(TPKT_SUPERVISOR_DIR=str(tmp_path / "state"),
               TPKT_HEALTH_JOURNAL=str(tmp_path / "health.jsonl"),
               TPKT_REVALIDATE_LOCK=str(tmp_path / "gpu_wait.lock"))
    if plan is not None:
        env["TPKT_FAULT_PLAN"] = json.dumps(plan)
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _run(env, *args, timeout=120):
    return subprocess.run(
        [sys.executable, "-m", "tpukernels_torch.revalidate", *args],
        env=env, capture_output=True, text=True, timeout=timeout, cwd=ROOT)


def _queue(tmp_path, steps):
    qf = tmp_path / "queue.json"
    qf.write_text(json.dumps(steps))
    return qf


def _events(path, kind):
    if not os.path.exists(path):
        return []
    return [r for r in map(json.loads, open(path).read().splitlines())
            if r.get("kind") == kind]


# ------------------------------------------------- the production queue

def _by_name(q):
    return {s.name: s for s in q}


def test_production_plus_waiting_are_the_references_steps():
    ref = [s.name for s in ref_cli.PRODUCTION_QUEUE]
    port = [s.name for s in revalidate.PRODUCTION_QUEUE]
    assert len(set(port)) == len(port)
    assert not set(port) & set(revalidate.WAITING)
    assert sorted(port + list(revalidate.WAITING)) == sorted(ref)
    # the ported steps keep the reference's declaration order
    assert port == [n for n in ref if n not in revalidate.WAITING]
    for name, item in revalidate.WAITING.items():
        assert re.match(r"Queue A item (1|4)\b", item), (name, item)


@pytest.mark.parametrize("name", [s.name for s in
                                  revalidate.PRODUCTION_QUEUE])
def test_each_step_keeps_the_references_schedule(name):
    ref = _by_name(ref_cli.PRODUCTION_QUEUE)[name]
    port = _by_name(revalidate.PRODUCTION_QUEUE)[name]
    for attr in ("gating", "stamp", "timeout_s", "cost_min", "value",
                 "needs_chip", "max_attempts_per_day", "quarantine_after",
                 "cost_from"):
        assert getattr(port, attr) == getattr(ref, attr), attr
    assert port.after == ref.after
    known = {s.name for s in revalidate.PRODUCTION_QUEUE}
    assert set(port.after) <= known
    # the body parses, runs the port and names no part of the reference
    r = subprocess.run(["bash", "-n", "-c", port.shell],
                       capture_output=True, text=True, timeout=30)
    assert r.returncode == 0, r.stderr
    assert re.search(r"tpukernels_torch|tests/test_torch_", port.shell)
    for banned in (r"\btools/", r"\bbench\.py\b", r"\btpukernels\.",
                   r"\bjax\b", r"docs/logs", r"\bTPK_"):
        assert not re.search(banned, port.shell), (name, banned)
    # a step with inputs the reference names none for has none either
    assert bool(port.inputs) == bool(ref.inputs)
    assert all((ROOT / i).exists() for i in port.inputs)


def test_production_queue_loads_as_a_queue_file(tmp_path):
    """The production specs round-trip through the queue-file loader
    (unique names, known dependencies, no cycle), and the planner's
    order on a fresh window is the reference's with its waiting steps
    taken out (none now): the prewarm first, then the bench and the
    probes, the sanitizers last."""
    fields = ("name", "shell", "gating", "timeout_s", "cost_min", "value",
              "max_attempts_per_day", "quarantine_after", "stamp",
              "needs_chip", "inputs", "after", "cost_from")
    qf = _queue(tmp_path, [{f: getattr(s, f) for f in fields}
                           for s in revalidate.PRODUCTION_QUEUE])
    assert [s.name for s in supervisor.load_queue_file(str(qf))] == \
        [s.name for s in revalidate.PRODUCTION_QUEUE]
    from tpukernels.resilience import supervisor as ref_sup

    def order(mod, queue, cp):
        sup = mod.Supervisor(queue, checkpoint=mod.Checkpoint(str(cp)),
                             announce=False)
        out = []
        while True:
            spec, _forced = sup.plan(25.0, may_force=False)
            if spec is None:
                return out
            out.append(spec.name)
            sup._settled.add(spec.name)
            sup._attempted.add(spec.name)

    got = order(supervisor, revalidate.PRODUCTION_QUEUE, tmp_path / "p.jsonl")
    want = order(ref_sup, ref_cli.PRODUCTION_QUEUE, tmp_path / "r.jsonl")
    assert len(got) == len(revalidate.PRODUCTION_QUEUE)
    assert got == [n for n in want if n not in revalidate.WAITING]
    assert got[:8] == ["prewarm_all", "bench", "slo_probe", "serve_probe",
                       "obs_check", "roofline_report", "busbw_sweep",
                       "c_gate"]
    assert got[-2:] == ["san_asan", "san_ubsan"]


def test_served_probes_send_the_keys_the_h100_row_judges():
    """The serve and fleet probes send the keys obs/slo.py's H100 row
    holds (the port's daemon cannot drain the reference's nine-key mix at
    the avatars), and the fleet's clients ride out a router respawn."""
    from tpukernels_torch.obs import slo

    judged = {k for k, rows in slo.TARGETS.items() if slo.EVIDENCE_ROW in rows}
    q = _by_name(revalidate.PRODUCTION_QUEUE)
    for name in ("serve_probe", "fleet_probe"):
        mixes = set(re.findall(r"--mix (\S+)", q[name].shell))
        assert mixes == {revalidate._SERVED_MIX}, name
        assert {kw.split("=")[0] for kw in revalidate._SERVED_MIX.split(",")} \
            == judged
        assert "--shapes record" in q[name].shell
    assert "export TPKT_CLIENT_RECONNECT_S=60" in q["fleet_probe"].shell
    # the in-process probe keeps the reference's load
    assert "--mix all" in q["slo_probe"].shell
    assert "--rate 8" in q["slo_probe"].shell


def test_pytest_steps_fail_on_a_skipped_test(tmp_path):
    """A pytest step's body fails when pytest's summary says a test
    skipped (the card's evidence must not pass by skipping), and passes
    on a clean summary."""
    spec = _by_name(revalidate.PRODUCTION_QUEUE)["pytest_vector_add"]
    body = re.sub(r"timeout 1200 python3 -m pytest .*?(?= 2>&1)",
                  "cat summary", spec.shell, flags=re.S)
    assert body != spec.shell
    for summary, rc in (("5 passed, 1 skipped in 0.1s", 1),
                        ("6 passed in 0.1s", 0), ("1 failed in 0.1s", 0)):
        (tmp_path / "summary").write_text(f"....\n{summary}\n")
        p = subprocess.run(["bash", "-c", body], cwd=tmp_path,
                           env=dict(os.environ,
                                    TPKT_SUPERVISOR_DIR=str(tmp_path)),
                           capture_output=True, text=True, timeout=30)
        assert p.returncode == rc, (summary, p.stdout)
    # each run writes pytest's whole output into the supervisor's logs
    assert list((tmp_path / "logs").glob("pytest_vector_add_*.log"))
    # the groups cover every port test file once: the named groups by
    # name, pytest_rest by collecting the rest of tests/
    files = set()
    for s in revalidate.PRODUCTION_QUEUE:
        if s.name.startswith("pytest_") and s.name != "pytest_rest":
            files |= set(re.findall(r"tests/\S+\.py", s.shell))
    rest = _by_name(revalidate.PRODUCTION_QUEUE)["pytest_rest"].shell
    assert set(re.findall(r"--ignore=(\S+)", rest)) == files
    assert all((ROOT / f).exists() for f in files)
    args = re.search(r"python3 -m pytest (.*?) -q", rest).group(1)
    p = subprocess.run(f"{sys.executable} -m pytest {args} --collect-only "
                       "-q -p no:cacheprovider", shell=True, cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    collected = {ln.split("::")[0] for ln in p.stdout.splitlines()
                 if "::" in ln}
    port = {str(f.relative_to(ROOT)) for f in
            (ROOT / "tests").glob("test_torch_*.py")}
    assert collected == port - files, p.stdout[-2000:] + p.stderr[-2000:]


def test_plan_prints_the_production_queue(tmp_path):
    p = _run(_env(tmp_path), "--plan")
    assert p.returncode == 0, p.stderr
    lines = p.stdout.splitlines()
    assert lines[0].startswith("window estimate: 25.0 min (default")
    names = [ln.split()[0] for ln in lines[2:]]
    assert sorted(names) == sorted(s.name for s in
                                   revalidate.PRODUCTION_QUEUE)
    assert names[0] == "prewarm_all" and names[-1] == "san_ubsan"
    # read only: no checkpoint, no journal, no lock
    assert not (tmp_path / "gpu_wait.lock").exists()
    assert not list((tmp_path / "state").glob("supervisor_*.jsonl"))
    assert not (tmp_path / "health.jsonl").exists()


def test_only_the_bench_gate_and_the_roofline_wait():
    """Nothing waits any more: the bench's regression gate and the
    roofline are steps (``bench`` persists its line and pipes it to the
    gate, ``--union-persisted`` under skip-captured; ``roofline_report``
    prints the table), ``knob_sanity`` and ``autotune_smoke`` run the
    port's commands, ``prewarm_all`` warms the bench's chains and the
    adaptive canary re-tunes its candidate (``--autotune quick``)."""
    assert revalidate.WAITING == {}
    q = _by_name(revalidate.PRODUCTION_QUEUE)
    bench = q["bench"].shell
    assert "bench_out=$(timeout 5400 python3 -m tpukernels_torch.bench)" \
        in bench
    assert '"$bench_dir/bench_$(date +%Y-%m-%d_%H%M%S).json"' in bench
    assert "python3 -m tpukernels_torch.bench --check-regression " \
        "$union_flag" in bench
    assert 'union_flag="--union-persisted"' in bench
    assert "TPKT_BENCH_SKIP_CAPTURED" in bench
    assert "python3 -m tpukernels_torch.obs.report --roofline" in \
        q["roofline_report"].shell
    assert q["obs_check"].after == q["roofline_report"].after == ("bench",)
    assert "--autotune quick" in q["adapt_canary"].shell
    knob = q["knob_sanity"].shell
    assert "for fuse in off on" in knob
    assert "TPKT_SCANHIST_FUSE=$fuse" in knob
    assert "from tpukernels_torch.bench import bench_scan_hist" in knob
    assert "TPKT_SGEMM_PRECISION=float32" in knob
    assert "from tpukernels_torch.bench import bench_sgemm" in knob
    smoke = q["autotune_smoke"].shell
    assert "python3 -m tpukernels_torch.autotune --kernel sgemm" in smoke
    assert "--smoke" in smoke
    assert "--bench all" in q["prewarm_all"].shell
    assert "--timeout-s 420" in q["prewarm_all"].shell


def test_autotune_smoke_step_runs_green_on_the_cpu(tmp_path):
    """The step's body as the queue runs it, on a host without a card:
    the smoke sweep's children run on the CPU, its log lands in the
    supervisor's logs/, and its entry in the (isolated) tuning cache is
    keyed device_kind=cpu."""
    spec = _by_name(revalidate.PRODUCTION_QUEUE)["autotune_smoke"]
    env = _env(tmp_path, TPKT_TUNING_CACHE_DIR=tmp_path / "tuning",
               TPKT_AOT_DIR=tmp_path / "aot",
               TPKT_INTEGRITY_DIR=tmp_path / "integrity",
               CUDA_VISIBLE_DEVICES="", PYTHONPATH=ROOT)
    p = subprocess.run(["bash", "-c", spec.shell], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "autotune smoke: OK" in p.stdout
    (log,) = (tmp_path / "state" / "logs").glob("autotune_smoke_*.log")
    assert "promoted ->" in log.read_text()
    entries = json.loads((tmp_path / "tuning" / "tuning.json").read_text())
    assert list(entries["entries"]) == ["sgemm|1024x1024x1024|float32|cpu"]


# ------------------------------------------------------ exit codes

def _stub(tmp_path, name="a", **kw):
    spec = {"name": name, "shell": f"echo {name} >> {tmp_path / 'runlog'}",
            "cost_min": 1, "value": 1, "needs_chip": False}
    spec.update(kw)
    return spec


@pytest.mark.parametrize("case,want", [
    ("green", 0), ("incomplete", 2), ("wedge", 124), ("slow_gating", 124),
    ("gating_rc", 7), ("usage", 64), ("bad_queue", 64), ("no_value", 64),
    ("lock_held", 3)])
def test_rc_contract(tmp_path, case, want):
    env = _env(tmp_path)
    args = []
    if case == "green":
        qf = _queue(tmp_path, [_stub(tmp_path)])
    elif case == "incomplete":
        qf = _queue(tmp_path, [_stub(tmp_path, cost_min=20, value=100,
                                     needs_chip=True),
                               _stub(tmp_path, "b", cost_min=3, value=10,
                                     needs_chip=True)])
        env = _env(tmp_path, plan={"probe": ["ok"]},
                   TPKT_SUPERVISOR_WINDOW_MIN=5)
    elif case in ("wedge", "slow_gating"):
        qf = _queue(tmp_path, [{"name": "w", "shell": "sleep 60",
                                "timeout_s": 1, "cost_min": 1,
                                "value": 1}])
        env = _env(tmp_path, plan={"probe": ["dead" if case == "wedge"
                                             else "ok"]})
    elif case == "gating_rc":
        qf = _queue(tmp_path, [_stub(tmp_path, shell="exit 7")])
    elif case == "usage":
        qf, args = _queue(tmp_path, []), ["--frobnicate"]
    elif case == "bad_queue":
        qf = _queue(tmp_path, [{"name": "a", "shell": "true",
                                "after": ["ghost"]}])
    elif case == "no_value":
        qf, args = _queue(tmp_path, []), ["--max-hours"]
    else:
        qf = _queue(tmp_path, [_stub(tmp_path)])
        holder = subprocess.Popen(
            ["bash", "-c", f'exec 9>>"{tmp_path / "gpu_wait.lock"}"; '
             f'flock 9; echo 12345 > "{tmp_path / "gpu_wait.lock"}"; '
             "sleep 60"])
    try:
        if case == "lock_held":
            time.sleep(0.5)
        p = _run(env, "--queue", str(qf), *args)
    finally:
        if case == "lock_held":
            holder.kill()
            holder.wait()
    assert p.returncode == want, p.stdout + p.stderr
    if case == "lock_held":
        assert "whos-holding" in p.stdout
        # the losing contender did not wipe the holder's recorded pid
        assert (tmp_path / "gpu_wait.lock").read_text().strip() == "12345"
        assert not (tmp_path / "runlog").exists()
    if case == "slow_gating":
        (done,) = _events(tmp_path / "health.jsonl", "step_done")
        assert done["outcome"] == "slow"


def test_lock_is_waited_for_then_taken(tmp_path):
    """A held lock is waited for TPKT_REVALIDATE_LOCK_WAIT_S; once the
    holder lets go, the queue takes it and records its own pid."""
    qf = _queue(tmp_path, [_stub(tmp_path)])
    lock = tmp_path / "gpu_wait.lock"
    holder = subprocess.Popen(["bash", "-c", f'exec 9>>"{lock}"; flock 9; '
                               "sleep 1.5"])
    time.sleep(0.3)
    p = _run(_env(tmp_path, TPKT_REVALIDATE_LOCK_WAIT_S=30), "--queue",
             str(qf))
    holder.wait()
    assert p.returncode == 0, p.stdout + p.stderr
    assert (tmp_path / "runlog").read_text().split() == ["a"]
    assert lock.read_text().strip().isdigit()


def test_lock_wait_defaults(monkeypatch):
    monkeypatch.delenv("TPKT_REVALIDATE_LOCK_WAIT_S", raising=False)
    assert (revalidate.lock_wait_s(True), revalidate.lock_wait_s(False)) \
        == (1800.0, 0.0)
    monkeypatch.setenv("TPKT_REVALIDATE_LOCK_WAIT_S", "2.5")
    assert revalidate.lock_wait_s(True) == revalidate.lock_wait_s(False) \
        == 2.5


def test_lock_path_default_and_no_home(tmp_path):
    env = _env(tmp_path, HOME=tmp_path / "home")
    del env["TPKT_REVALIDATE_LOCK"]
    (tmp_path / "home").mkdir()
    qf = _queue(tmp_path, [_stub(tmp_path)])
    assert _run(env, "--queue", str(qf)).returncode == 0
    assert (tmp_path / "home" / ".tpkt_gpu_wait.lock").exists()
    del env["HOME"]
    p = _run(env, "--queue", str(qf))
    assert p.returncode == 64 and "HOME unset" in p.stderr


def test_watch_mode(tmp_path):
    qf = _queue(tmp_path, [_stub(tmp_path)])
    p = _run(_env(tmp_path, plan={"probe": ["ok"]}), "--queue", str(qf),
             "--wait", "--max-hours", "0.01")
    assert p.returncode == 0, p.stdout + p.stderr
    assert "card ALIVE" in p.stdout
    # a dead card until the deadline: rc 1, each wait journaled
    d = tmp_path / "dead"
    d.mkdir()
    p = _run(_env(d, plan={"probe": ["dead"]},
                  TPKT_SUPERVISOR_PROBE_BASE_S=0.02,
                  TPKT_SUPERVISOR_PROBE_CAP_S=0.05),
             "--queue", str(qf), "--wait", "--max-hours", "0.0001")
    assert p.returncode == 1 and "gave up" in p.stdout
    sched = _events(d / "health.jsonl", "probe_scheduled")
    assert sched and all(e["delay_s"] <= 0.05 for e in sched)
    # a deterministic failure with the card alive: its rc, at once
    qf2 = _queue(tmp_path, [_stub(tmp_path, "boom", shell="exit 7")])
    d2 = tmp_path / "boom"
    d2.mkdir()
    p = _run(_env(d2, plan={"probe": ["ok"]}), "--queue", str(qf2),
             "--wait", "--max-hours", "0.01")
    assert p.returncode == 7 and "deterministic failure" in p.stderr


def test_queue_from_the_knob_and_the_default_journal(tmp_path):
    """``TPKT_SUPERVISOR_QUEUE`` names the queue file; with no
    ``TPKT_HEALTH_JOURNAL`` the supervisor and its steps share a dated
    journal in the supervisor's state directory, and the steps see
    ``TPKT_SUPERVISOR_DIR``."""
    qf = _queue(tmp_path, [_stub(
        tmp_path, shell=f'echo "$TPKT_SUPERVISOR_DIR $TPKT_HEALTH_JOURNAL" '
        f'>> {tmp_path / "runlog"}')])
    env = _env(tmp_path, TPKT_SUPERVISOR_QUEUE=qf)
    del env["TPKT_HEALTH_JOURNAL"]
    p = _run(env)
    assert p.returncode == 0, p.stdout + p.stderr
    state = tmp_path / "state"
    assert (tmp_path / "runlog").read_text().split() == [str(state)] * 2
    day = time.strftime("%Y-%m-%d")
    assert _events(state / f"health_{day}.jsonl", "step_done")
    assert (state / "logs").is_dir()
    assert (state / f"supervisor_{day}.jsonl").exists()
    assert (state / ".revalidate_stamps" / f"a_{day}.done").exists()


# ------------------------------------------------------------ the lock

def test_step_children_inherit_the_lock_fd(tmp_path):
    qf = _queue(tmp_path, [_stub(
        tmp_path, "fd", shell=f"readlink /proc/$$/fd/9 >> "
        f"{tmp_path / 'runlog'} 2>/dev/null || echo none >> "
        f"{tmp_path / 'runlog'}")])
    p = _run(_env(tmp_path), "--queue", str(qf))
    assert p.returncode == 0, p.stdout + p.stderr
    assert (tmp_path / "runlog").read_text().split() == [
        str(tmp_path / "gpu_wait.lock")]


def test_probe_children_do_not_inherit_the_lock_fd(tmp_path):
    """In a process that holds the lock on fd 9 (``take_lock``), a step
    child sees fd 9 and a probe child does not: the probe snippet is
    swapped for one that is alive only when fd 9 is absent."""
    lock = tmp_path / "gpu_wait.lock"
    code = textwrap.dedent(f"""
        import os, subprocess
        os.environ["TPKT_REVALIDATE_LOCK"] = {str(lock)!r}
        from tpukernels_torch import revalidate
        from tpukernels_torch.resilience import supervisor
        assert revalidate.take_lock({str(lock)!r}, 0)
        assert supervisor._inherited_lock_fds() == (9,)
        supervisor._PROBE_SNIPPET = (
            "import os, sys; sys.exit(os.path.exists('/proc/self/fd/9'))")
        print("probe", supervisor.probe_alive())
        step = subprocess.run(["bash", "-c", "readlink /proc/$$/fd/9"],
                              pass_fds=supervisor._inherited_lock_fds(),
                              capture_output=True, text=True)
        print("step", step.stdout.strip())
        """)
    env = {k: v for k, v in os.environ.items() if not k.startswith("TPKT_")}
    p = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=60)
    assert p.returncode == 0, p.stderr
    assert p.stdout.split("\n")[:2] == ["probe True", f"step {lock}"]


def test_whos_holding(tmp_path):
    lock = tmp_path / "gpu_wait.lock"
    env = _env(tmp_path)
    p = _run(env, "--whos-holding")
    assert p.returncode == 0 and "no lock file" in p.stdout
    lock.write_text("99999999\n")
    p = _run(env, "--whos-holding")
    assert p.returncode == 0 and "NOT held" in p.stdout
    holder = subprocess.Popen(
        ["bash", "-c", f'exec 9>"{lock}"; echo $$ > "{lock}"; flock 9; '
         "exec sleep 60"])
    try:
        time.sleep(0.5)
        p = _run(env, "--whos-holding")
        assert p.returncode == 3 and "sleep 60" in p.stdout
        assert "unrecognized holder" in p.stdout
    finally:
        holder.kill()
        holder.wait()
    assert revalidate.classify_holder(
        "python -m tpukernels_torch.revalidate --wait --max-hours 10") == \
        "live-watcher"
    assert revalidate.classify_holder(
        "python3 -m tpukernels_torch.revalidate") == "live-queue"
    assert revalidate.classify_holder(
        "python3 -m tpukernels_torch.loadgen --mix all") == "orphaned-queue"
    assert revalidate.classify_holder(
        "python3 -m tpukernels_torch.profile") == "orphaned-queue"
    assert revalidate.classify_holder("sleep 60") == "unknown"


# -------------------------------------------------- no torch, no card

def test_supervisor_and_cli_import_no_torch():
    code = ("import sys\n"
            "import tpukernels_torch.resilience.supervisor\n"
            "import tpukernels_torch.revalidate\n"
            "import tpukernels_torch.obs.health_report\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'jaxlib', 'tpukernels')))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=60)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"


def test_a_queue_run_loads_no_torch(tmp_path):
    """The supervisor process of a whole queue run (with a wedge and its
    probe answered by the plan) never loads torch."""
    qf = _queue(tmp_path, [{"name": "w", "shell": "sleep 60",
                            "timeout_s": 1, "cost_min": 1, "value": 1}])
    code = ("import sys, runpy\n"
            "sys.argv = ['revalidate', '--queue', sys.argv[1]]\n"
            "try:\n"
            "    runpy.run_module('tpukernels_torch.revalidate', "
            "run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    print('rc', e.code, 'torch' in sys.modules)\n")
    p = subprocess.run([sys.executable, "-c", code, str(qf)],
                       env=_env(tmp_path, plan={"probe": ["dead"]}),
                       cwd=ROOT, capture_output=True, text=True, timeout=60)
    assert p.stdout.strip().splitlines()[-1] == "rc 124 False", \
        p.stdout + p.stderr


def test_probe_is_alive_only_with_a_card(tmp_path):
    """The real probe child: dead on a host without a card, alive where
    a card answers."""
    import torch

    env = _env(tmp_path)
    code = ("from tpukernels_torch.resilience import supervisor\n"
            "print(supervisor.probe_alive(attempt=3, timeout_s=120))\n")
    p = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=180)
    assert p.returncode == 0, p.stderr
    card = torch.cuda.is_available()
    assert p.stdout.strip() == str(card)
    (probe,) = _events(tmp_path / "health.jsonl", "probe")
    assert (probe["site"], probe["attempt"], probe["outcome"]) == (
        "supervisor", 3, "alive" if card else "error")
