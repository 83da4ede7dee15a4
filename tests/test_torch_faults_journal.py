"""The port's journal and fault plan against the JAX package's (CPU).

The same plans and journal settings go through both packages' copies:
the same routing of ``*_HEALTH_JOURNAL``, the same decisions of
``output_fault`` and ``dispatch_fault``, the same torn writes. Then the
port's own: a wedge and a kill in a child process, an env-narrowed
plan, and ``git_head`` outside a git checkout.
"""

import json
import os
import subprocess
import sys
import time

import pytest

from tpukernels.resilience import faults as ref_faults
from tpukernels.resilience import journal as ref_journal
from tpukernels_torch.resilience import atomic, faults, journal

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def plans(monkeypatch, tmp_path):
    """Set one plan in both packages (and a journal each), restored
    after the test."""
    monkeypatch.setenv("TPKT_HEALTH_JOURNAL", str(tmp_path / "tpkt.jsonl"))
    monkeypatch.setenv("TPK_HEALTH_JOURNAL", str(tmp_path / "tpk.jsonl"))

    def set_plan(plan):
        raw = plan if isinstance(plan, str) else json.dumps(plan)
        monkeypatch.setenv("TPKT_FAULT_PLAN", raw)
        monkeypatch.setenv("TPK_FAULT_PLAN", raw)
        faults.reload_plan()
        ref_faults.reload_plan()

    yield set_plan
    for var in ("TPKT_FAULT_PLAN", "TPK_FAULT_PLAN"):
        monkeypatch.delenv(var, raising=False)
    faults.reload_plan()
    ref_faults.reload_plan()


def _events(path):
    return journal.load_events([path])[0]


# ------------------------------------------------------------------ #
# journal                                                            #
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("raw", [None, "", "0", "off", "NONE", "dir",
                                 "file.jsonl"])
def test_journal_routing_matches_reference(tmp_path, raw):
    value = {"dir": str(tmp_path), "file.jsonl": str(tmp_path / "j.jsonl")
             }.get(raw, raw)
    assert journal.resolve(value) == ref_journal.resolve(value)


def test_journal_off_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.delenv("TPKT_HEALTH_JOURNAL", raising=False)
    monkeypatch.chdir(tmp_path)
    assert journal.path() is None
    journal.emit("probe", x=1)
    assert os.listdir(tmp_path) == []


def test_journal_emits_stamped_records(tmp_path, monkeypatch):
    monkeypatch.setenv("TPKT_HEALTH_JOURNAL", str(tmp_path))
    journal.emit("probe", x=1, obj=object())
    (name,) = os.listdir(tmp_path)
    assert name.startswith("health_") and name.endswith(".jsonl")
    (rec,) = _events(tmp_path / name)
    assert rec["kind"] == "probe" and rec["x"] == 1
    assert rec["pid"] == os.getpid() and "ts" in rec and "t" in rec
    assert "git_head" in rec and isinstance(rec["obj"], str)


def test_journal_never_raises(tmp_path, monkeypatch):
    (tmp_path / "f").write_text("a file, not a directory")
    monkeypatch.setenv("TPKT_HEALTH_JOURNAL", str(tmp_path / "f" / "j"))
    journal.emit("probe")
    assert (tmp_path / "f").read_text() == "a file, not a directory"


def test_load_events_is_tolerant(tmp_path):
    p = tmp_path / "j.jsonl"
    p.write_text('{"kind": "a"}\n\nnot json\n[1]\n{"kind": "b"}\n{"kind"')
    events, bad = journal.load_events([p, tmp_path / "missing.jsonl"])
    assert [e["kind"] for e in events] == ["a", "b"]
    assert bad == 2
    assert (events, bad) == ref_journal.load_events([p])


def test_git_head_outside_a_checkout_is_none(tmp_path):
    assert journal.git_head(str(tmp_path)) is None
    assert journal.git_head(str(tmp_path / "missing")) is None


# ------------------------------------------------------------------ #
# fault plan                                                         #
# ------------------------------------------------------------------ #

OUTPUT_PLANS = [
    {"corrupt_output": {"kernel": "sgemm", "site": "registry"}},
    {"nan_output": "stencil2d"},
    {"nan_output": {"site": "manual"}, "corrupt_output": {}},
    {"corrupt_output": {"kernel": "scan", "env": {"TPKT_TEST_X": "1"}}},
]


@pytest.mark.parametrize("plan", OUTPUT_PLANS)
def test_output_fault_matches_reference(plans, monkeypatch, plan):
    plans(plan)
    for env in (None, "1"):
        if env is None:
            monkeypatch.delenv("TPKT_TEST_X", raising=False)
        else:
            monkeypatch.setenv("TPKT_TEST_X", env)
        for site in ("registry", "manual"):
            for kernel in ("sgemm", "stencil2d", "scan", "histogram"):
                assert faults.output_fault(site, kernel) == (
                    ref_faults.output_fault(site, kernel)), (site, kernel)


def test_unset_plan_is_one_check(monkeypatch):
    monkeypatch.delenv("TPKT_FAULT_PLAN", raising=False)
    assert faults.reload_plan() is None
    assert faults.output_fault("registry", "sgemm") is None
    assert faults.dispatch_fault("sgemm") is None
    assert faults.torn_write_fault("/x/integrity.json") is None


def test_plan_from_a_file_and_bad_plans(plans, tmp_path):
    p = tmp_path / "plan.json"
    p.write_text(json.dumps({"nan_output": "sgemm"}))
    plans(str(p))
    assert faults.output_fault("registry", "sgemm") == "nan"
    with pytest.raises(ValueError, match="TPKT_FAULT_PLAN"):
        plans("[1, 2]")


def test_slow_dispatch_delays_every_nth_call(plans, tmp_path):
    plans({"slow_dispatch": {"kernel": "scan", "delay_s": 0.2,
                             "every": 3}})
    walls = []
    for _ in range(6):
        t0 = time.perf_counter()
        faults.dispatch_fault("scan")
        faults.dispatch_fault("sgemm")  # another kernel: never delayed
        walls.append(time.perf_counter() - t0)
    slow = [i + 1 for i, w in enumerate(walls) if w >= 0.2]
    assert slow == [3, 6]
    fired = [e for e in _events(tmp_path / "tpkt.jsonl")
             if e["kind"] == "fault_injected"]
    assert [e["call"] for e in fired] == [3, 6]
    assert all(e["fault"] == "slow_dispatch" for e in fired)


def test_reload_resets_the_counters(plans):
    plans({"slow_dispatch": {"kernel": "scan", "delay_s": 0.0,
                             "every": 2}})
    faults.dispatch_fault("scan")
    assert faults._DISPATCH_CALLS == {"scan": 1}
    faults.reload_plan()
    assert faults._DISPATCH_CALLS == {}


def test_torn_write_keeps_the_old_content(plans, tmp_path):
    target = tmp_path / "integrity.json"
    atomic.dump_json(str(target), {"old": True})
    plans({"torn_write": {"path_substr": "integrity.json"}})
    new = {"new": True, "pad": "x" * 100}
    with pytest.raises(OSError, match="torn_write"):
        atomic.dump_json(str(target), new)
    assert json.load(open(target)) == {"old": True}
    (tmp,) = [p for p in os.listdir(tmp_path) if ".tmp." in p]
    full = len(json.dumps(new, indent=1, sort_keys=True))
    assert os.path.getsize(tmp_path / tmp) == full // 2
    atomic.dump_json(str(target), {"new": True})  # on_call 1 only
    assert json.load(open(target)) == {"new": True}
    fired = [e for e in _events(tmp_path / "tpkt.jsonl")
             if e["kind"] == "fault_injected"]
    assert [e["fault"] for e in fired] == ["torn_write"]


@pytest.mark.parametrize("spec,fires", [
    ({"path_substr": "tuning"}, [False, False, False]),
    ({"on_call": 2}, [False, True, False]),
    ("integrity", [True, False, False]),
])
def test_torn_write_matching_matches_reference(plans, tmp_path, spec,
                                               fires):
    plans({"torn_write": spec})
    path = str(tmp_path / "integrity.json")
    got = [faults.torn_write_fault(path) is not None for _ in range(3)]
    want = [ref_faults.torn_write_fault(path) is not None
            for _ in range(3)]
    assert got == want == fires


_CHILD = """
import sys, torch
from tpukernels_torch import registry
x = torch.arange(16, dtype=torch.int32)
for i in range(3):
    registry.dispatch("scan", x)
    print("done", i + 1, flush=True)
"""


def _child(tmp_path, plan, timeout):
    env = dict(os.environ, PYTHONPATH=ROOT, TPKT_FAULT_PLAN=json.dumps(plan),
               TPKT_HEALTH_JOURNAL=str(tmp_path / "child.jsonl"),
               TPKT_INTEGRITY="0", CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen([sys.executable, "-c", _CHILD], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=ROOT)


def test_kill_worker_kills_on_the_nth_call(tmp_path):
    once = tmp_path / "once"
    p = _child(tmp_path, {"kill_worker": {"kernel": "scan", "on_call": 2,
                                          "once_file": str(once)}}, 120)
    out, err = p.communicate(timeout=120)
    assert p.returncode == -9, err
    assert out.split() == ["done", "1"]
    assert once.exists()
    # the one-shot file spares the next incarnation
    p = _child(tmp_path, {"kill_worker": {"kernel": "scan", "on_call": 2,
                                          "once_file": str(once)}}, 120)
    out, err = p.communicate(timeout=120)
    assert p.returncode == 0, err
    fired = [e for e in _events(tmp_path / "child.jsonl")
             if e["kind"] == "fault_injected"]
    assert [(e["fault"], e["call"]) for e in fired] == [("kill_worker", 2)]


def test_wedge_dispatch_hangs_the_first_call(tmp_path):
    p = _child(tmp_path, {"wedge_dispatch": {"kernel": "scan"}}, 120)
    deadline = time.monotonic() + 90
    while time.monotonic() < deadline:
        fired = [e for e in _events(tmp_path / "child.jsonl")
                 if e["kind"] == "fault_injected"]
        if fired:
            break
        time.sleep(0.2)
    time.sleep(0.5)
    try:
        assert p.poll() is None  # still hanging
    finally:
        p.kill()
        out, _err = p.communicate(timeout=30)
    assert out == ""
    assert [e["fault"] for e in fired] == ["wedge_dispatch"]


def test_env_clause_narrows_dispatch_faults(plans, monkeypatch, tmp_path):
    plans({"slow_dispatch": {"kernel": "scan", "delay_s": 0.0,
                             "env": {"TPKT_TEST_WORKER": "1"}}})
    monkeypatch.setenv("TPKT_TEST_WORKER", "0")
    faults.dispatch_fault("scan")
    monkeypatch.setenv("TPKT_TEST_WORKER", "1")
    faults.dispatch_fault("scan")
    fired = [e for e in _events(tmp_path / "tpkt.jsonl")
             if e["kind"] == "fault_injected"]
    assert len(fired) == 1
