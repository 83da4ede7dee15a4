"""The port's observability gate against the reference, on the CPU.

``tpukernels_torch/obs/trend.py``'s journal analyzers get the events of
the reference's own cases (``tests/test_serve_zero_copy.py``,
``tests/test_reqtrace.py``, ``tests/test_adapt.py``) and seeded ones and
must give the reference's verdicts. ``python -m
tpukernels_torch.obs.report --check`` must give the reference's exit
codes on fixture roots that mirror the reference's cases: a clean root,
a confirmed integrity failure, a ``trace_inconsistent`` and a
``trace_coverage``, a degraded bus-bandwidth series on the card, an
``overlap_low``, an SLO breach and a simulated one, a copy regression, a
pad-waste regression. A ``shared-card`` artifact never gates, and the
report never reads the reference's TPU evidence (``BENCH_r*.json``,
``BASELINE.json``, ``docs/logs/``). Every state path is in a temporary
directory.
"""

import builtins
import glob as glob_mod
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from tpukernels.obs import trend as ref_trend
from tpukernels_torch.obs import report, scaling, slo, trend
from tpukernels_torch.resilience import journal
from tpukernels_torch.tuning import cache as tcache

ROOT = Path(__file__).resolve().parent.parent

CARD_INV = {"source": "torch", "platform": "cuda",
            "device_kind": "nvidia_h100_80gb_hbm3", "n_devices": 8,
            "process_count": 8, "local_devices": 8, "fake": False}


# ------------------------------------------------------ analyzer parity

def _ported(verdicts):
    """The reference's verdicts with its knob names in the port's."""
    return json.loads(json.dumps(verdicts).replace("TPK_", "TPKT_"))


def _copy(sock="/tmp/a.sock", lane="shm", **kw):
    e = {"kind": "serve_copy_budget", "socket": sock, "lane": lane,
         "requests": 40, "bytes_per_request": 0.0,
         "daemon_bytes_copied": 0, "expected_zero": lane == "shm"}
    e.update(kw)
    return e


def _budget(sock="/tmp/a.sock", **kw):
    e = {"kind": "serve_trace_budget", "socket": sock, "requests": 10,
         "traced": 10, "gaps": 0, "untraced_serve_requests": 0,
         "coverage_floor": 0.5, "sum_tol": 0.1}
    e.update(kw)
    return e


COPY_CASES = {
    "clean shm": [_copy()],
    "shm copied": [_copy(daemon_bytes_copied=12, bytes_per_request=0.3)],
    "rounded away": [_copy(daemon_bytes_copied=3, bytes_per_request=0.0)],
    "no raw count": [_copy(daemon_bytes_copied=None,
                           bytes_per_request=4.0)],
    "inline": [_copy(lane="inline", bytes_per_request=8192.0,
                     daemon_bytes_copied=327680)],
    "superseded": [_copy(daemon_bytes_copied=12), _copy()],
    "two sockets": [_copy(daemon_bytes_copied=12),
                    _copy(sock="/x/b.sock"), {"kind": "junk"}],
}

TRACE_CASES = {
    "ok": [_budget(coverage_mean=0.9, sum_ratio_max=0.95)],
    "inconsistent": [_budget(coverage_mean=1.5, sum_ratio_max=1.5)],
    "coverage": [_budget(coverage_mean=0.2, sum_ratio_max=0.3)],
    "nothing traced": [_budget(traced=0)],
    "superseded": [_budget(coverage_mean=1.5, sum_ratio_max=1.5),
                   _budget(coverage_mean=0.9, sum_ratio_max=0.95)],
    "own tolerance": [_budget(sum_tol=0.6, sum_ratio_max=1.5,
                              coverage_mean=0.9)],
    "no tolerance": [_budget(sum_tol=None, coverage_floor=None,
                             sum_ratio_max=1.05, coverage_mean=0.3)],
}


def _promo(pad, t=10.0, table="/x/buckets.json"):
    return {"kind": "adapt_promoted", "pad_frac": pad, "t": t,
            "table": table}


def _served(pad, t=None, ok=True):
    e = {"kind": "serve_request", "ok": ok, "pad_frac": pad}
    if t is not None:
        e["t"] = t
    return e


PAD_CASES = {
    "no promotion": [_served(0.5)] * 30,
    "held": [_promo(0.1)] + [_served(0.12, t=11.0)] * 25,
    "drifted": [_promo(0.1)] + [_served(0.4, t=11.0)] * 25,
    "too few": [_promo(0.1)] + [_served(0.9, t=11.0)] * 5,
    "older traffic": [_served(0.9, t=1.0)] * 40 + [_promo(0.1)]
    + [_served(0.1, t=12.0)] * 20,
    "journal order": [_served(0.9)] * 30 + [_promo(0.1, t=None)]
    + [_served(0.12)] * 21 + [_served(0.9, ok=False)] * 5,
    "not measured": [_promo(None)] + [_served(0.9, t=11.0)] * 25,
}


@pytest.mark.parametrize("case", sorted(COPY_CASES))
def test_copy_budget_equals_reference(case):
    events = COPY_CASES[case]
    got = trend.analyze_copy_budget(events)
    assert got == _ported(ref_trend.analyze_copy_budget(events))
    want_bad = case in ("shm copied", "rounded away", "no raw count",
                        "two sockets")
    assert any(v["verdict"] == "copy_regression"
               for v in got.values()) == want_bad


@pytest.mark.parametrize("case", sorted(TRACE_CASES))
def test_trace_budget_equals_reference(case):
    events = TRACE_CASES[case]
    got = trend.analyze_trace_budget(events)
    assert got == _ported(ref_trend.analyze_trace_budget(events))
    verdict = got["trace[a.sock]"]["verdict"]
    assert verdict == {"inconsistent": "trace_inconsistent",
                       "coverage": "trace_coverage",
                       "no tolerance": "trace_coverage"}.get(case, "ok")


@pytest.mark.parametrize("case", sorted(PAD_CASES))
def test_pad_waste_equals_reference(case):
    events = PAD_CASES[case]
    got = trend.analyze_pad_waste(events)
    assert got == _ported(ref_trend.analyze_pad_waste(events))
    verdicts = {v["verdict"] for v in got.values()}
    assert verdicts == {"no promotion": set(), "not measured": set(),
                        "drifted": {"pad_waste_regression"},
                        "too few": {"no_data"}}.get(case, {"ok"})
    assert trend.PAD_WASTE_SLACK == ref_trend.PAD_WASTE_SLACK
    assert trend.PAD_WASTE_MIN_REQUESTS == ref_trend.PAD_WASTE_MIN_REQUESTS


@pytest.mark.parametrize("seed", range(4))
def test_analyzers_on_seeded_journals_equal_reference(seed):
    rng = np.random.default_rng(seed)
    events = []
    for i in range(60):
        r = rng.random()
        sock = f"/s/{int(rng.integers(3))}.sock"
        if r < 0.3:
            events.append(_copy(sock=sock, lane=["shm", "inline"][
                int(rng.integers(2))],
                daemon_bytes_copied=int(rng.integers(0, 3)) * 64,
                bytes_per_request=float(rng.integers(0, 3))))
        elif r < 0.6:
            events.append(_budget(sock=sock, traced=int(rng.integers(0, 4)),
                                  coverage_mean=float(rng.random() * 1.4),
                                  sum_ratio_max=float(rng.random() * 1.4)))
        elif r < 0.65:
            events.append(_promo(float(rng.random() * 0.3), t=float(i)))
        else:
            events.append(_served(float(rng.random() * 0.5), t=float(i),
                                  ok=bool(rng.random() > 0.1)))
    for name in ("analyze_copy_budget", "analyze_trace_budget",
                 "analyze_pad_waste"):
        assert getattr(trend, name)(events) == \
            _ported(getattr(ref_trend, name)(events)), name


# ------------------------------------------------------- the CLI's rc

@pytest.fixture
def state(tmp_path, monkeypatch):
    """Every state directory the report reads, empty, in ``tmp_path``;
    no journal routed."""
    env = {"TPKT_SLO_DIR": tmp_path / "slo",
           "TPKT_SCALING_DIR": tmp_path / "scaling",
           "TPKT_ROLLUP_DIR": tmp_path / "roll",
           "TPKT_INTEGRITY_DIR": tmp_path / "integrity",
           "TPKT_ADAPT_DIR": tmp_path / "adapt",
           "TPKT_BENCH_DIR": tmp_path / "bench"}
    for k in [k for k in os.environ if k.startswith(("TPKT_", "TPK_"))]:
        monkeypatch.delenv(k)
    for k, v in env.items():
        v.mkdir()
        monkeypatch.setenv(k, str(v))
    slo.reset()
    return tmp_path


def _run(*args, journal_events=None, tmp=None):
    """``python -m tpukernels_torch.obs.report`` with this process's
    env; ``journal_events`` go into a journal passed by ``--journal``."""
    argv = list(args)
    if journal_events is not None:
        jp = Path(tmp) / "j.jsonl"
        jp.write_text("".join(json.dumps(e) + "\n" for e in journal_events))
        argv += ["--journal", str(jp)]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, "-m", "tpukernels_torch.obs.report",
                           *argv], capture_output=True, text=True, cwd=ROOT,
                          env=env, timeout=120)


def test_clean_root_is_rc0(state):
    r = _run("--check")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "0 bench failing, 0 bench ok" in r.stdout
    assert "0 confirmed output-integrity failure(s)" in r.stdout
    r = _run()
    assert r.returncode == 0, r.stdout + r.stderr
    assert "VERDICT: clean" in r.stdout


def test_confirmed_integrity_failure_gates(state):
    bad = [{"kind": "output_integrity_failed", "kernel": "sgemm",
            "site": "registry", "tier": 2, "detail": "max err 3.0"}]
    r = _run("--check", journal_events=bad, tmp=state)
    assert r.returncode == 1, r.stdout + r.stderr
    assert "output_integrity_failed: sgemm at registry (tier 2)" in r.stdout
    r = _run(journal_events=bad, tmp=state)
    assert "FAILED sgemm at registry" in r.stdout


def test_trace_inconsistent_gates_and_coverage_does_not(state):
    r = _run("--check", journal_events=[_budget(coverage_mean=1.4,
                                                sum_ratio_max=1.4)],
             tmp=state)
    assert r.returncode == 1, r.stdout + r.stderr
    assert "trace[a.sock]: trace_inconsistent" in r.stdout
    r = _run("--check", journal_events=[_budget(coverage_mean=0.2,
                                                sum_ratio_max=0.3)],
             tmp=state)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "trace[a.sock]: trace_coverage (non-gating)" in r.stdout


def test_copy_regression_gates(state):
    r = _run("--check", journal_events=[_copy(daemon_bytes_copied=4096,
                                              bytes_per_request=102.4)],
             tmp=state)
    assert r.returncode == 1, r.stdout + r.stderr
    assert "copy/shm[a.sock]: copy_regression" in r.stdout
    r = _run("--check", journal_events=[_copy(lane="inline",
                                              bytes_per_request=8192.0)],
             tmp=state)
    assert r.returncode == 0, r.stdout + r.stderr


def test_pad_waste_regression_gates(state):
    r = _run("--check", journal_events=PAD_CASES["drifted"], tmp=state)
    assert r.returncode == 1, r.stdout + r.stderr
    assert "pad_waste[buckets.json]: pad_waste_regression" in r.stdout
    r = _run("--check", journal_events=PAD_CASES["held"], tmp=state)
    assert r.returncode == 0, r.stdout + r.stderr


def _busbw(d, values, inv):
    for i, gbs in enumerate(values):
        scaling.write_busbw_artifact([(1 << 20, (1 << 20) / gbs / 1e9, gbs)],
                                     "allreduce", 8, inv, out_dir=str(d))
        # one artifact a second: the file name's stamp orders the series
        p = sorted(Path(d).glob("scaling_busbw_allreduce_*.json"))[-1]
        p.rename(Path(d) / f"scaling_busbw_allreduce_2026-08-0{i + 1}"
                           f"_000000_{i}.json")


def test_degraded_busbw_on_the_card_gates(state):
    _busbw(state / "scaling", (45.0, 30.0), CARD_INV)
    analysis = scaling.analyze_repo(str(state / "scaling"))
    assert scaling.gating_findings(analysis)
    r = _run("--check")
    assert r.returncode == 1, r.stdout + r.stderr
    assert "busbw/allreduce/n8/1048576B: regression" in r.stdout
    r = _run()
    assert r.returncode == 1
    assert "VERDICT: busbw/allreduce/n8/1048576B regression" in r.stdout


@pytest.mark.parametrize("basis", ["cpu", "shared-card"])
def test_fake_and_shared_card_series_never_gate(state, basis):
    inv = dict(CARD_INV, fake=True, fake_basis=basis)
    if basis == "cpu":
        inv.update(platform="cpu", device_kind="cpu")
    _busbw(state / "scaling", (45.0, 30.0), inv)
    r = _run("--check")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "busbw/allreduce/n8/1048576B: regression" not in r.stdout
    assert "0 scaling regression(s)" in r.stdout
    r = _run()
    assert r.returncode == 0, r.stdout + r.stderr
    assert "no_data" in r.stdout


def test_overlap_low_prints_and_never_gates(state):
    scaling.write_overlap_artifact(
        [{"op": "nbody_ring", "n_devices": 8, "mesh_shape": None,
          "depth": 2, "t_comm_s": 0.010, "t_compute_s": 0.010,
          "t_full_s": 0.019, "overlap_frac": 0.1}],
        CARD_INV, out_dir=str(state / "scaling"))
    r = _run()
    assert r.returncode == 0, r.stdout + r.stderr
    assert "overlap_low" in r.stdout and "overlap/nbody_ring/n8/d2" in r.stdout
    r = _run("--check")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "overlap_low (non-gating)" in r.stdout
    assert "1 overlap-low (non-gating)" in r.stdout


def _slo_row(kernel, verdict, simulated=False):
    return {kernel: {"kernel": kernel, "count": 40, "p50_s": 0.5,
                     "p95_s": 0.9, "p99_s": 1.0, "max_s": 1.0,
                     "buckets": {}, "target_p99_s": 0.1, "basis": "test",
                     "device_kind": "cpu", "shape_class": "probe",
                     "simulated": simulated, "verdict": verdict}}


def test_slo_breach_gates_and_a_simulated_one_does_not(state):
    slo.record(_slo_row("sgemm", "slo_breach", simulated=True))
    r = _run()
    assert r.returncode == 0, r.stdout + r.stderr
    assert "latency SLOs" in r.stdout and "sgemm" in r.stdout
    assert "simulated - never gates" in r.stdout
    r = _run("--check")
    assert r.returncode == 0, r.stdout + r.stderr
    slo.record(_slo_row("scan", "slo_breach"),
               versions=tcache.installed_versions())
    r = _run("--check")
    assert r.returncode == 1, r.stdout + r.stderr
    assert "scan: slo_breach (p99 1000.0ms > target 100.0ms over 40 " \
        "request(s), probe shapes on cpu)" in r.stdout
    assert "1 confirmed SLO breach(es)" in r.stdout


def test_p99_creep_prints_and_never_gates(state):
    roll = state / "roll"
    for i, p99 in enumerate((1.0, 1.01, 1.02, 1.03, 1.2), start=1):
        (roll / f"rollup_2026-08-0{i}.json").write_text(json.dumps({
            "schema": 1, "date": f"2026-08-0{i}",
            "torch": tcache.installed_versions()[0], "source_sha": None,
            "events": 3, "pids": 1,
            "requests": {"scan": {"count": 50, "p99": p99}}}))
    r = _run("--check")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "p99_creep[scan]: p99_creep (non-gating)" in r.stdout
    r = _run()
    assert "== daily rollups (5 day(s)" in r.stdout
    assert "2026-08-05: 3 event(s), 1 pid(s), 50 request(s)" in r.stdout


def test_the_tpu_evidence_is_never_read(state, monkeypatch, capsys):
    """A root holding a regressed ``BENCH_r01.json``, ``BASELINE.json``
    and a ``docs/logs/`` journal with a confirmed corruption: rc 0, the
    bench sections over the H100 lines alone, and no file of those
    opened or listed."""
    root = state / "root"
    logs = root / "docs" / "logs"
    logs.mkdir(parents=True)
    line = {"metric": "x", "details": {"sgemm_gflops": 72698.0}}
    (root / "BENCH_r01.json").write_text(json.dumps({"parsed": line}))
    (root / "BENCH_r02.json").write_text(json.dumps(
        {"parsed": {"details": {"sgemm_gflops": 100.0}}}))
    (root / "BASELINE.json").write_text(json.dumps(
        {"ceilings": {"sgemm_gflops": 61000.0},
         "measured": {"sgemm_gflops": 50000.0}}))
    (logs / "bench_2026-08-01_000000.json").write_text(json.dumps(line))
    (logs / "health_2026-08-01.jsonl").write_text(json.dumps(
        {"kind": "output_integrity_failed", "kernel": "sgemm"}) + "\n")
    seen = []
    real_open, real_glob = builtins.open, glob_mod.glob

    def spy_open(path, *a, **kw):
        seen.append(str(path))
        return real_open(path, *a, **kw)

    def spy_glob(pattern, *a, **kw):
        seen.append(str(pattern))
        return real_glob(pattern, *a, **kw)

    monkeypatch.setattr(builtins, "open", spy_open)
    monkeypatch.setattr(glob_mod, "glob", spy_glob)
    for argv in (["--check", "--root", str(root)], ["--root", str(root)]):
        assert report.main(argv) == 0
        out = capsys.readouterr().out
        assert ("0 bench failing" if argv[0] == "--check"
                else "== bench trend (H100 lines in") in out
    assert not [p for p in seen
                if "docs/logs" in p or "BENCH_" in p or "BASELINE" in p], seen
    # --root moved the unredirected state dirs under it, and put them back
    monkeypatch.setenv("TPKT_SLO_DIR", str(root / ".tpkt_cache"))
    slo.record(_slo_row("scan", "slo_breach"),
               versions=tcache.installed_versions())
    monkeypatch.delenv("TPKT_SLO_DIR")
    assert report.main(["--check", "--root", str(root)]) == 1
    assert "scan: slo_breach" in capsys.readouterr().out
    assert "TPKT_SLO_DIR" not in os.environ


def test_journal_comes_from_the_flag_or_the_knob(state, monkeypatch):
    jd = state / "journals"
    jd.mkdir()
    (jd / "health_2026-08-01.jsonl").write_text("{}\n")
    (jd / "health_2026-08-02.jsonl").write_text("{}\n")
    (jd / "health_suite.jsonl").write_text("{}\n")
    monkeypatch.setenv("TPKT_HEALTH_JOURNAL", str(jd))
    # the newest of the dated files the rollups compact, one policy
    assert journal.reader_paths() == [str(jd / "health_2026-08-02.jsonl")]
    assert journal.reader_paths() == journal.dated_files()["2026-08-02"]
    monkeypatch.setenv("TPKT_HEALTH_JOURNAL", str(jd / "x.jsonl"))
    assert journal.reader_paths() == [str(jd / "x.jsonl")]
    assert journal.reader_paths(["a"]) == ["a"]
    monkeypatch.setenv("TPKT_HEALTH_JOURNAL", "off")
    assert journal.reader_paths() == []
    monkeypatch.delenv("TPKT_HEALTH_JOURNAL")
    assert journal.reader_paths() == []


def test_root_moves_every_state_dir(state, monkeypatch):
    """``--root DIR`` puts every knob-redirected state directory where
    it lies under ``<repo>/.tpkt_cache``, now under ``DIR/.tpkt_cache``,
    and leaves the env as it found it."""
    from tpukernels_torch import _cachedir

    for k in _cachedir.STATE_DIRS:
        monkeypatch.delenv(k, raising=False)
    repo = {k: _cachedir._state_dir(k, {}) for k in _cachedir.STATE_DIRS}
    assert repo["TPKT_ROLLUP_DIR"] == str(ROOT / ".tpkt_cache" / "rollup")
    with report.state_root(str(state)):
        moved = {k: os.environ[k] for k in _cachedir.STATE_DIRS}
        assert _cachedir.rollup_dir() == moved["TPKT_ROLLUP_DIR"]
        assert _cachedir.slo_path() == os.path.join(
            moved["TPKT_SLO_DIR"], "slo.json")
    assert moved == {k: v.replace(str(ROOT), str(state), 1)
                     for k, v in repo.items()}
    assert not any(k in os.environ for k in _cachedir.STATE_DIRS)


@pytest.mark.parametrize("argv", [["--roofline", "--bogus"],
                                  ["--eps", "abc"],
                                  ["--check", "--eps"], ["--bogus"],
                                  ["--journal"], ["--root"]])
def test_usage_errors_are_rc2(state, argv):
    r = _run(*argv)
    assert r.returncode == 2, r.stdout + r.stderr
    if argv[0] == "--eps":
        assert "needs a numeric value" in r.stderr
    if argv[-1] == "--eps":
        assert "requires a value" in r.stderr
