"""The port's load generator against the reference, on the CPU.

``python -m tpukernels_torch.loadgen`` must draw the reference's schedule
byte for byte: ``build_schedule`` is held against the function of
``tools/loadgen.py`` (read out of that file, not imported: the
reference's CLI module sets JAX cache variables when imported) for
several seeds, all three arrival processes and several mixes, and the
two CLIs' ``--print-schedule`` output is compared. Then the port's own
runs: ``--simulate`` twice with one seed lands identical buckets; in
process on the CPU (``--device cpu``) it judges against the ``cpu|probe``
row, with the integrity guard a tripwire unless the caller chose, and
with no card and no ``--device cpu`` it refuses; ``--verify`` catches an
answer that differs; ``--serve`` against the port's daemon
(``TPKT_SERVE_DEVICE=cpu``) completes every request with seeded ids,
stamps the trace budget and the copy budget, and its journal assembles
to the same timelines under the port's ``obs/reqtrace.py`` and the
reference's; through a one-worker fleet's router, a ``slow_dispatch``
breach is stamped with the worker's versions, so ``slo.breaches()``
reads it back; usage errors exit 2.
"""

import ast
import json
import math
import os
import random
import re
import subprocess
import sys

import pytest

from test_torch_serve import ROOT, _daemon
from test_torch_serve_fleet import _fleet
from tpukernels.obs import reqtrace as ref_reqtrace
from tpukernels_torch import aot, loadgen
from tpukernels_torch.obs import metrics, reqtrace, slo
from tpukernels_torch.resilience import journal
from tpukernels_torch.serve.client import ServeClient
from tpukernels_torch.tuning import cache as tcache

REF_LOADGEN = ROOT / "tools" / "loadgen.py"


def _reference_schedule():
    """``build_schedule`` (with ``_rate_at`` and ``ARRIVALS``) as the
    reference's file defines it."""
    tree = ast.parse(REF_LOADGEN.read_text())
    keep = [n for n in tree.body
            if isinstance(n, ast.FunctionDef)
            and n.name in ("build_schedule", "_rate_at")
            or isinstance(n, ast.Assign)
            and any(getattr(t, "id", None) == "ARRIVALS" for t in n.targets)]
    ns = {"math": math, "random": random}
    exec(compile(ast.Module(body=keep, type_ignores=[]), str(REF_LOADGEN),
                 "exec"), ns)
    return ns["build_schedule"]


REF_SCHEDULE = _reference_schedule()
ALL = {k: 1.0 for k in sorted(aot.BENCH_CONFIGS)}
MIXES = {"one": {"scan": 1.0}, "weighted": {"sgemm": 3.0, "scan": 1.0},
         "all": ALL, "served": {"vector_add": 1.0, "scan": 1.0, "sgemm": 1.0},
         "replay": {"e000": 31.0, "e001": 29.0}}


@pytest.mark.parametrize("seed", (0, 1, 7, 11, 12345))
@pytest.mark.parametrize("arrivals", ("poisson", "bursty", "diurnal"))
@pytest.mark.parametrize("mix", sorted(MIXES))
def test_schedule_equals_reference(seed, arrivals, mix):
    for rate, requests, duration, period in ((20.0, 200, None, 60.0),
                                             (5.0, 0, 25.0, 60.0),
                                             (40.0, 64, 3.0, 7.5)):
        args = (seed, arrivals, rate, requests, duration, MIXES[mix], period)
        mine, theirs = loadgen.build_schedule(*args), REF_SCHEDULE(*args)
        assert mine == theirs
        assert [f"{t:.6f} {k}" for t, k in mine] == [
            f"{t:.6f} {k}" for t, k in theirs]


def test_schedule_errors_equal_reference():
    for args in ((0, "uniform", 1.0, 5, None, ALL),
                 (0, "poisson", 1.0, 0, None, ALL)):
        with pytest.raises(ValueError) as mine:
            loadgen.build_schedule(*args)
        with pytest.raises(ValueError) as theirs:
            REF_SCHEDULE(*args)
        assert str(mine.value) == str(theirs.value)


def _env(tmp_path, **extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPKT_", "TPK_"))}
    env.update(PYTHONPATH=str(ROOT), TPKT_SLO_DIR=str(tmp_path / "slo"),
               TPKT_HEALTH_JOURNAL=str(tmp_path / "j.jsonl"),
               TPKT_AOT_DIR=str(tmp_path / "aot"),
               TPKT_INTEGRITY_DIR=str(tmp_path / "integrity"),
               TPKT_TUNING_CACHE_DIR=str(tmp_path / "tuning"))
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _run(args, env, timeout=300):
    return subprocess.run([sys.executable, "-m", "tpukernels_torch.loadgen",
                           *args], capture_output=True, text=True,
                          timeout=timeout, cwd=ROOT, env=env)


def _entries(tmp_path):
    return json.loads((tmp_path / "slo" / "slo.json").read_text())["entries"]


def test_print_schedule_equals_the_reference_cli(tmp_path):
    args = ["--mix", "all", "--arrivals", "bursty", "--rate", "40",
            "--requests", "64", "--print-schedule"]
    mine = _run(args, _env(tmp_path, TPKT_LOADGEN_SEED=7))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPKT_", "TPK_"))}
    env.update(JAX_PLATFORMS="cpu", TPK_LOADGEN_SEED="7")
    theirs = subprocess.run([sys.executable, str(REF_LOADGEN), *args],
                            capture_output=True, text=True, timeout=300,
                            cwd=ROOT, env=env)
    assert mine.returncode == theirs.returncode == 0, (mine.stderr,
                                                       theirs.stderr)
    assert mine.stdout == theirs.stdout
    assert len(mine.stdout.splitlines()) == 64
    other = _run(args, _env(tmp_path, TPKT_LOADGEN_SEED=8))
    assert other.stdout != mine.stdout
    bad = _run(args, _env(tmp_path, TPKT_LOADGEN_SEED="x"))
    assert bad.returncode == 2 and "TPKT_LOADGEN_SEED" in bad.stderr


def test_simulate_is_bucket_identical_across_runs(tmp_path):
    rows = []
    for tag in ("a", "b"):
        d = tmp_path / tag
        r = _run(["--mix", "scan=1,sgemm=2", "--arrivals", "diurnal",
                  "--period", "5", "--rate", "40", "--requests", "120",
                  "--seed", "3", "--simulate", "5"], _env(d))
        assert r.returncode == 0, r.stdout + r.stderr
        assert "(SIMULATED)" in r.stdout
        entries = _entries(d)
        assert set(entries) == {"scan|probe|cpu|sim", "sgemm|probe|cpu|sim"}
        assert all(e["simulated"] and e["torch"] is None
                   for e in entries.values())
        rows.append({k: (e["buckets"], e["p50_s"], e["p99_s"], e["count"])
                     for k, e in entries.items()})
    assert rows[0] == rows[1]


def test_in_process_on_the_cpu(tmp_path):
    r = _run(["--mix", "scan=1,vector_add=1,histogram=1", "--requests", "60",
              "--rate", "100", "--seed", "5", "--device", "cpu", "--verify"],
             _env(tmp_path, TPKT_TRACE=1))
    assert r.returncode == 0, r.stdout + r.stderr
    assert "0 answer(s) differ" in r.stdout
    assert "generator lateness" in r.stdout
    entries = _entries(tmp_path)
    assert set(entries) == {"histogram|probe|cpu", "scan|probe|cpu",
                            "vector_add|probe|cpu"}
    assert sum(e["count"] for e in entries.values()) == 60
    events, _ = journal.load_events([tmp_path / "j.jsonl"])
    (probe,) = [e for e in events if e["kind"] == "slo_probe"]
    assert probe["lateness_s"]["count"] == 60
    assert probe["dropped"] == {} and probe["mismatched"] == {}
    assert set(probe["answers"]) == {"histogram", "scan", "vector_add"}
    # the integrity guard defaults to the tripwire: no canary ran
    assert not [e for e in events if e["kind"] == "span"
                and "integrity/canary" in e["name"]]
    assert [e["site"] for e in events
            if e["kind"] == "device_inventory"] == ["loadgen"]
    # a caller's choice wins: the first-trust canaries run
    r = _run(["--kernel", "scan", "--requests", "3", "--rate", "100",
              "--device", "cpu"],
             _env(tmp_path / "full", TPKT_TRACE=1, TPKT_INTEGRITY=1))
    assert r.returncode == 0, r.stdout + r.stderr
    events, _ = journal.load_events([tmp_path / "full" / "j.jsonl"])
    assert [e for e in events if e["kind"] == "span"
            and e["name"].endswith("integrity/canary/scan")]


def test_in_process_without_a_card_refuses(tmp_path):
    # no card: hidden from the child on a host that has one
    r = _run(["--kernel", "scan", "--requests", "3"],
             _env(tmp_path, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode == 2
    assert "no CUDA device" in r.stderr
    assert not (tmp_path / "slo").exists()


def test_verify_catches_a_differing_answer(tmp_path, monkeypatch, capsys):
    from tpukernels_torch import registry

    real = registry.dispatch
    calls = []

    def flaky(name, *args, **statics):
        out = real(name, *args, **statics)
        calls.append(name)
        return out + 1 if len(calls) == 4 else out

    monkeypatch.setattr(registry, "dispatch", flaky)
    for k, v in _env(tmp_path).items():
        if k.startswith("TPKT_"):
            monkeypatch.setenv(k, v)
    monkeypatch.setenv("TPKT_INTEGRITY", "0")
    metrics.reset()
    try:
        rc = loadgen.main(["--kernel", "scan", "--requests", "6", "--rate",
                           "500", "--device", "cpu", "--verify"])
        mismatched = metrics.counters("slo.mismatched.")
    finally:
        metrics.reset()
    assert rc == 1 and mismatched == {"slo.mismatched.scan": 1}
    out = capsys.readouterr()
    assert "1 answer(s) differ" in out.out
    assert "scan answer differs" in out.err
    assert len(calls) == 7  # the warm dispatch and the six scheduled


@pytest.mark.parametrize("args,said", [
    (["--shapes", "x.json", "--simulate", "5"], "requires --serve"),
    (["--serve", "s", "--shapes", "x.json", "--kernel", "scan"],
     "don't combine"),
    (["--serve", "s", "--shapes", "/nonexistent.json"], "replay-spec"),
    (["--serve", "s", "--simulate", "5"], "exclusive"),
    (["--serve", "s", "--device", "cpu"], "in-process runs only"),
    (["--device", "gpu"], "--device"),
    (["--tenant", "a"], "only apply to --serve"),
    (["--serve", "s", "--tenant", "a@b"], "bad --tenant"),
    (["--serve", "s", "--priority", "urgent"], "--priority"),
    (["--deadline-ms", "250"], "only applies to --serve"),
    (["--serve", "s", "--deadline-ms", "400:200"], "bad value"),
    (["--kernel", "nope"], "unknown kernel"),
    (["--rate", "0"], "--rate must be > 0"),
    (["--bogus"], "unknown argument"),
    (["--requests"], "requires a value"),
])
def test_usage_errors(tmp_path, args, said):
    r = _run(args, _env(tmp_path))
    assert r.returncode == 2, r.stdout + r.stderr
    assert said in r.stderr, r.stderr


def test_replay_spec_validation(tmp_path):
    spec = tmp_path / "replay.json"
    for bad, hint in (({"entries": []}, "at least one entry"),
                      ({"entries": [{"kernel": "k",
                                     "args": [["f64", [4]]]}]}, "bad arg"),
                      ({"entries": [{"kernel": "k", "args": [["f32", [4]]],
                                     "weight": 0}]}, "weight"),
                      ({"entries": [{"args": [["f32", [4]]]}]},
                       "needs a kernel name")):
        spec.write_text(json.dumps(bad))
        r = _run(["--serve", "/nonexistent.sock", "--shapes", str(spec),
                  "--requests", "5"], _env(tmp_path))
        assert r.returncode == 2 and hint in r.stderr, r.stderr


def test_served_run_against_the_port_daemon(tmp_path):
    """``--serve`` against a port daemon on the CPU: every request ok,
    ids seeded and contiguous, the trace and copy budgets stamped, the
    verdicts under the daemon's device kind and versions; the journal
    assembles to the same timelines under both reqtrace modules."""
    with _daemon(tmp_path, "served") as d:
        # targets widened 3x: a shared CPU host can stall one request for
        # most of a second
        env = _env(tmp_path, TPKT_HEALTH_JOURNAL=d.journal,
                   TPKT_SLO_SCALE=3)
        r = _run(["--serve", d.sock, "--mix", "scan=1,vector_add=1",
                  "--seed", "7", "--requests", "40", "--rate", "40",
                  "--verify", "--check"], env)
        assert r.returncode == 0, r.stdout + r.stderr
        assert "(SERVED)" in r.stdout and "dropped 0" in r.stdout
        r2 = _run(["--serve", d.sock, "--kernel", "scan", "--seed", "7",
                   "--requests", "30", "--rate", "60", "--tenant", "acme",
                   "--priority", "batch", "--deadline-ms", "20000"], env)
        assert r2.returncode == 0, r2.stdout + r2.stderr
        assert "goodput 30/30" in r2.stdout
        pong = d.events("serve_start")
        assert pong
    events = d.events()
    clients = [e for e in events if e["kind"] == "serve_client_request"]
    pids = sorted({e["pid"] for e in clients})
    assert len(pids) == 2
    first = [e for e in clients if e["pid"] == pids[0]]
    assert all(e["ok"] for e in clients)
    assert [e["request_id"] for e in first if not e["warm"]] == [
        f"lg7-{pids[0]}-{i:05d}" for i in range(40)]
    assert sorted(e["request_id"] for e in first if e["warm"]) == [
        f"lg7-{pids[0]}-warm-scan", f"lg7-{pids[0]}-warm-vector_add"]
    served = {e["request_id"] for e in events if e["kind"] == "serve_request"}
    assert {e["request_id"] for e in clients} <= served
    budgets = [e for e in events if e["kind"] == "serve_trace_budget"]
    assert [b["requests"] for b in budgets] == [42, 31]
    assert budgets[0]["traced"] == budgets[0]["assembled"] == 42
    assert budgets[0]["server_traced"] is True
    assert budgets[0]["sum_ratio_max"] <= 1 + budgets[0]["sum_tol"]
    copies = [e for e in events if e["kind"] == "serve_copy_budget"]
    assert [c["requests"] for c in copies] == [42, 31]
    entries = _entries(tmp_path)
    assert set(entries) == {"scan|probe|cpu", "vector_add|probe|cpu",
                            "scan@acme|probe|cpu"}
    import torch

    for e in entries.values():
        # fewer than 20 samples of a series judge no_data
        assert e["verdict"] == ("ok" if e["count"] >= 20 else "no_data")
        assert e["run"]["served"] is True
        assert (e["torch"], e["cuda"]) == (torch.__version__,
                                           torch.version.cuda)
    assert entries["scan@acme|probe|cpu"]["goodput_frac"] == 1.0
    probes = [e for e in events if e["kind"] == "slo_probe"]
    assert probes[0]["mismatched"] == {} and probes[0]["dropped"] == {}
    assert re.fullmatch(r"[0-9a-f]{8}", probes[0]["answers"]["scan"])
    # the daemon's journal, assembled by the port and by the reference
    mine = reqtrace.assemble(events)
    assert mine == ref_reqtrace.assemble(events)
    assert len(mine) == 73
    assert reqtrace.aggregate(mine) == ref_reqtrace.aggregate(mine)
    ids = [e["request_id"] for e in first]
    assert reqtrace.run_budget(events, ids) == ref_reqtrace.run_budget(
        events, ids)


def test_served_breach_through_the_fleet_survives_load(tmp_path,
                                                      monkeypatch):
    """``--serve`` against a one-worker fleet's router: the router's pong
    relays the worker's torch and CUDA versions, so the verdicts it
    stamps are not rejected as stale when read back, and a
    ``slow_dispatch`` breach measured through the fleet is one of
    ``slo.breaches()``."""
    plan = json.dumps({"slow_dispatch": {"kernel": "scan", "delay_s": 1.0,
                                         "every": 20}})
    with _fleet(tmp_path, n=1, TPKT_FAULT_PLAN=plan) as (front, jpath, _):
        worker = ServeClient(str(tmp_path / "f" / "fleet" / "worker0"
                                 / "serve.sock"))
        mine = ServeClient(front).ping()
        assert mine["role"] == "router"
        wping = worker.ping()
        assert (mine["torch"], mine["cuda"]) == (wping["torch"],
                                                 wping["cuda"])
        assert (mine["torch"], mine["cuda"]) == tcache.installed_versions()
        env = _env(tmp_path, TPKT_HEALTH_JOURNAL=jpath)
        r = _run(["--serve", front, "--kernel", "scan", "--seed", "7",
                  "--requests", "60", "--rate", "6", "--check"], env)
    assert r.returncode == 1, r.stdout + r.stderr
    assert "BREACH: scan" in r.stdout and "dropped 0" in r.stdout
    monkeypatch.setenv("TPKT_SLO_DIR", str(tmp_path / "slo"))
    monkeypatch.setenv("TPKT_HEALTH_JOURNAL", str(tmp_path / "read.jsonl"))
    slo.reset()
    entries = slo.load_entries()
    assert entries["scan|probe|cpu"]["run"]["served"] is True
    assert set(slo.breaches()) == {"scan|probe|cpu"}
    slo.reset()


def test_unreachable_daemon(tmp_path):
    r = _run(["--serve", str(tmp_path / "none.sock"), "--kernel", "scan",
              "--requests", "3"], _env(tmp_path))
    assert r.returncode == 2 and "unreachable" in r.stderr
