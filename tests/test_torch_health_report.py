"""``python -m tpukernels_torch.obs.health_report`` against the
reference's ``tools/health_report.py``, on the CPU.

The same events go through both ``summarize``: the narrative, the
supervisor's step table, the served and routed tables, the span
breakdown, the per-process metric state, the totals and the verdict line
must be the reference's, line for line, but for the events whose fields
the port names its own way (``aot_hit``/``aot_miss``, ``prewarm_start``
and ``prewarm_end``), which get their own cases, the slow verdict's
wording (the port has a card where the reference has a tunnel) and the
operator's command (the port's ``ctl`` for ``serve_ctl``). One
supervisor session of the port, run through ``python -m
tpukernels_torch.revalidate`` in a subprocess, renders in both the
health report and ``obs.report``. The report reads its arguments, else
``TPKT_HEALTH_JOURNAL``, and never ``docs/logs/``; it imports no torch.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from tools import health_report as ref_hr
from tpukernels_torch.obs import health_report as hr

ROOT = Path(__file__).resolve().parent.parent
DOCS_LOGS = ROOT / "docs" / "logs"
T0 = 1_792_000_000.0


@pytest.fixture(autouse=True)
def docs_logs_untouched():
    before = sorted(os.listdir(DOCS_LOGS)) if DOCS_LOGS.exists() else []
    yield
    after = sorted(os.listdir(DOCS_LOGS)) if DOCS_LOGS.exists() else []
    assert after == before


def _ev(kind, i, **fields):
    e = {"ts": f"2026-10-18T07:{i // 60:02d}:{i % 60:02d}", "t": T0 + i,
         "pid": 100 + i % 3, "git_head": "a" * 40, "kind": kind}
    e.update(fields)
    return e


def _seq(*pairs):
    return [_ev(kind, i, **fields) for i, (kind, fields) in enumerate(pairs)]


CASES = {
    "supervisor": _seq(
        ("device_inventory", dict(site="supervisor", source="env",
                                  platform=None, fake=True,
                                  fake_basis="unknown-platform")),
        ("window_estimate", dict(minutes=25.0, basis="default", windows=0)),
        ("step_start", dict(step="prewarm_all", attempt=1, gating=False,
                            forced=False)),
        ("span", dict(name="queue/run/step/prewarm_all", wall_s=9.5,
                      depth=2, ok=True)),
        ("step_done", dict(step="prewarm_all", outcome="green", rc=0,
                           wall_s=9.5, wedges_today=0)),
        ("step_start", dict(step="w", attempt=1, gating=True, forced=True)),
        ("watchdog_fire", dict(mechanism="subprocess-kill", site="step/w",
                               timeout_s=3.0)),
        ("fault_injected", dict(site="probe", outcome="dead", attempt=0)),
        ("probe", dict(site="supervisor", attempt=0, outcome="dead",
                       injected=True)),
        ("wedge_classification", dict(verdict="wedged", step="w")),
        ("step_done", dict(step="w", outcome="wedged", rc=None, wall_s=3.0,
                           wedges_today=2)),
        ("step_quarantined", dict(step="w", wedges=2, threshold=2)),
        ("step_skipped", dict(step="x", reason="deferred-window")),
        ("supervisor_resume", dict(events=4, green=["prewarm_all"],
                                   quarantined=["w"], interrupted=["x"])),
        ("step_cost_estimated", dict(step="prewarm_all", cost_min=0.5,
                                     prior_cost_min=12.0,
                                     basis="prewarm_kernel")),
        ("probe_scheduled", dict(attempt=2, delay_s=55.1,
                                 reason="card-dead")),
        ("step_done", dict(step="s", outcome="failed", rc=7, wall_s=0.1,
                           wedges_today=0)),
        ("metrics", dict(site="atexit:revalidate.py", counters={
            "supervisor.steps_green": 1, "supervisor.steps_wedged": 1},
            gauges={}, histograms={}))),
    "serve": _seq(
        ("serve_start", dict(socket="/s", workers=2, queue_max=64,
                             batch_window_ms=2.0)),
        ("serve_start", dict(role="router", socket="/f", workers=2,
                             tenant_rate=5.0, tenant_burst=10)),
        ("serve_request", dict(request="r1", request_id="lg-1",
                               kernel="scan", ok=True, wall_s=0.01,
                               pad_frac=0.5, bucketed=True, batch_size=2,
                               worker_id="0")),
        ("serve_request", dict(request="r1", request_id="lg-1",
                               kernel="scan", ok=False, error="wedged",
                               wall_s=3.0, worker_id="1")),
        ("serve_request", dict(request="r2", kernel="sgemm", ok=True,
                               requeues=1, wall_s=0.2)),
        ("serve_rejected", dict(kernel="scan", depth=64, queue_max=64,
                                retry_after_s=0.5)),
        ("serve_request_requeued", dict(request="r3", kernel="scan",
                                        timeout_s=2.0)),
        ("serve_route", dict(worker=0, ok=True, bucket="scan|64|-",
                             tenant="hot")),
        ("serve_route", dict(worker=1, ok=False, bucket="scan|64|-",
                             spilled_from=0, request="r4", kernel="scan")),
        ("serve_spill", dict(kernel="scan", bucket="scan|64|-",
                             from_worker=0, to_worker=1, reason="wedged")),
        ("serve_drain", dict(worker=0, phase="begin", inflight=3)),
        ("serve_drain", dict(worker=0, phase="end", inflight=0)),
        ("serve_tenant_throttled", dict(tenant="hot", priority="batch",
                                        kernel="scan", retry_after_s=1)),
        ("serve_client_request", dict(kernel="scan", request_id="lg-2",
                                      ok=False, error="dropped")),
        ("serve_trace_budget", dict(traced=9, requests=10, gaps=1,
                                    coverage_mean=0.8,
                                    untraced_serve_requests=2)),
        ("serve_lane_negotiated", dict(kernel="scan", request="r5")),
        ("serve_copy_budget", dict(bytes_per_request=0.0, requests=40,
                                   lane="shm", expected_zero=True,
                                   daemon_bytes_copied=0)),
        ("serve_stop", dict(served=10, rejected=1, requeued=1,
                            uptime_s=30.0)),
        ("serve_stop", dict(role="router", routed=10, spilled=1,
                            throttled=1, uptime_s=30.0))),
    "fleet_health": _seq(
        ("worker_dead", dict(worker=1, via="probe", crashes=1,
                             worker_pid=55, backoff_s=0.2,
                             swept_segments=2, swept_bytes=4096)),
        ("worker_respawned", dict(worker=1, worker_pid=56, restarts=1,
                                  down_s=9.4)),
        ("worker_quarantined", dict(worker=1, crashes=3, threshold=3)),
        ("serve_request_replayed", dict(via="wal", ok=False,
                                        request_id="x", reason="expired")),
        ("serve_request_replayed", dict(via="wal", kernel="scan",
                                        request_id="y", to_worker=0)),
        ("serve_request_replayed", dict(kernel="scan", request="z",
                                        from_worker=1, to_worker=0)),
        ("router_dead", dict(via="flock", crashes=1, router_pid=7,
                             backoff_s=0.2)),
        ("router_respawned", dict(router_pid=8, restarts=1, down_s=2.7)),
        ("router_quarantined", dict(crashes=3, threshold=3)),
        ("fleet_degraded", dict(level="degraded", down=[1])),
        ("fleet_degraded", dict(level="critical", down=[0, 1],
                                quarantined=[1], retry_after_s=4.0)),
        ("fleet_degraded", dict(level="ok", down=[])),
        ("fleet_fsck", dict(stale_pidfiles=1, swept_segments=0,
                            torn_configs=0)),
        ("chaos_event", dict(seq=1, of=5, event="kill_router", seed=1)),
        ("artifact_rejected", dict(path="/x/fleet.json", reason="torn"))),
    "adapt_slo": _seq(
        ("adapt_proposed", dict(proposals=[1, 2], requests_mined=40,
                                before={"pad_frac": 0.43},
                                after={"pad_frac": 0.12}, pad_target=0.25)),
        ("adapt_canary", dict(promote=True, seed=11, reason="p99 win")),
        ("adapt_promoted", dict(table="/a/buckets.json", pad_frac=0.12)),
        ("adapt_rejected", dict(reason="no win")),
        ("slo_probe", dict(requests=80, arrivals="poisson", seed=0,
                           shape_class="record",
                           device_kind="nvidia_h100_80gb_hbm3",
                           verdicts={"scan": {"verdict": "ok"},
                                     "sgemm": {"verdict": "slo_breach"}})),
        ("slo_probe", dict(requests=5, arrivals="poisson", seed=1,
                           shape_class="probe", device_kind="cpu",
                           simulated=True, verdicts={})),
        ("slo_breach", dict(kernel="sgemm", p99_s=1.2348,
                            target_p99_s=1.0, count=42)),
        ("slo_breach", dict(kernel="scan", p99_s=None, target_p99_s=0.5,
                            count=3, simulated=True)),
        ("slo_rejected", dict(key="scan|record|cpu", reason="stale"))),
    "integrity_scaling": _seq(
        ("output_integrity_failed", dict(kernel="sgemm", site="registry",
                                         tier=3, detail="max err 4.0")),
        ("output_integrity_quarantined", dict(kernel="sgemm", config="c",
                                              failures=2, threshold=2)),
        ("output_integrity_quarantined_repeat", dict(kernel="sgemm",
                                                     failures=3)),
        ("output_integrity_envelope", dict(kernel="scan", leaves=1)),
        ("output_integrity_rejected", dict(key="k", reason="sha")),
        ("output_integrity_check_error", dict(kernel="scan", site="capi",
                                              error="boom")),
        ("aot_invalidated", dict(kernel="sgemm", memo_dropped=2,
                                 manifest_dropped=["a", "b"])),
        ("aot_rejected", dict(key="k", reason="torch version")),
        ("device_inventory", dict(site="busbw", source="torch",
                                  platform="cuda",
                                  device_kind="nvidia_h100_80gb_hbm3",
                                  n_devices=1, process_index=0,
                                  process_count=1, fake=False)),
        ("device_inventory", dict(site="dryrun", source="torch",
                                  platform="cuda", n_devices=1,
                                  process_count=4, fake=True,
                                  fake_basis="shared-card")),
        ("busbw_point", dict(op="allreduce", n_devices=1,
                             size_bytes=16777216, gb_s=1125.0,
                             fake=False)),
        ("weak_scaling_point", dict(program="stencil2d", n_devices=4,
                                    wall_s=1.5, fake=True)),
        ("weak_scaling_point", dict(program="nbody", n_devices=4,
                                    ok=False, error="timeout")),
        ("scaling_computed", dict(artifacts=3, busbw={"a": "ok"},
                                  weak={"b": "below_scaling_efficiency"}))),
    "probes_and_tuning": _seq(
        ("probe", dict(attempt=0, outcome="alive")),
        ("probe_failed", dict(label="probe", attempt=1, attempts=3,
                              backoff_s=5.0)),
        ("watchdog_fire", dict(mechanism="sigalrm", site="dispatch",
                               timeout_s=10)),
        ("wedge_classification", dict(verdict="wedged", metric="m")),
        ("fault_injected", dict(site="dispatch", kernel="scan",
                                fault="slow_dispatch", delay_s=0.5)),
        ("capi_error", dict(kernel="sgemm", error="bad buffer")),
        ("import_failure", dict(kernels=["nbody"], error="ImportError")),
        ("tuning_resolved", dict(kernel="sgemm", params={"bm": 128},
                                 sources={"bm": "env"})),
        ("tuning_rejected", dict(key="k", reason="stale")),
        ("tuning_cache_put", dict(key="k", params={"bm": 64}, smoke=True)),
        ("tuning_sweep_start", dict(kernel="sgemm", candidates=4,
                                    pruned=1)),
        ("tuning_candidate", dict(params={"bm": 64}, value=None,
                                  status="timeout", aot_hit_ratio=0.5)),
        ("tuning_promoted", dict(kernel="sgemm", params={"bm": 64},
                                 value=1.0, control=0.9)),
        ("tuning_sweep_end", dict(measured=3, failed=1, promoted=True)),
        ("rollup_written", dict(date="2026-10-17", events=5224,
                                requests=900, kernels=9, bad_lines=2)),
        ("rollup_rejected", dict(path="/r.json", reason="torn")),
        ("roofline_computed", dict(metrics={"m": {"frac": 0.1}},
                                   device_kind="cpu", basis="x",
                                   min_frac=0.3)),
        ("something_new", dict(x=1)),
        ("metrics_snapshot", dict(seq=1, site="serve", counters={
            "serve.requests.scan": 3}, gauges={}, histograms={})),
        ("metrics_snapshot", dict(seq=2, site="serve", counters={
            "serve.requests.scan": 2}, gauges={"g": 1}, histograms={})),
        ("metrics_snapshot", dict(seq=2, site="serve", counters={
            "serve.requests.scan": 2}, gauges={"g": 1}, histograms={}))),
}


def _ref_text(events, bad=0):
    """The reference's summary in the port's words: a card, not a
    tunnel; ``ctl``, not ``serve_ctl``; a cost in device-minutes, not in
    the reference's own unit."""
    text = ref_hr.summarize(events, bad).replace(
        " - tunnel still answers, continuing",
        " - the card still answers, continuing").replace(
        "`serve_ctl ", "`ctl ")
    return re.sub(r"(\] step \S+) \w+-minute cost", r"\1 device-minute cost",
                  text)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("bad", [0, 3])
def test_summary_equals_the_references(case, bad):
    events = CASES[case]
    got = hr.summarize(events, bad)
    assert got == _ref_text(events, bad)
    assert got.count("\n") > len(events) // 2


def test_summary_of_every_case_at_once():
    events = [e for case in sorted(CASES) for e in CASES[case]]
    assert hr.summarize(events) == _ref_text(events)


def test_the_slow_verdict_names_the_card():
    (line,) = [hr._fmt(_ev("wedge_classification", 0, verdict="slow",
                           step="w"))]
    assert line.endswith("timeout on w classified SLOW - the card still "
                         "answers, continuing")


def test_the_ports_own_event_fields():
    """The port's compile discipline and prewarm name their fields their
    own way; the narrative reads those fields."""
    lines = [hr._fmt(e) for e in _seq(
        ("aot_miss", dict(key="scan|4194304|int32|cuda", build_s=0.0,
                          load_s=0.01, plan_s=0.002)),
        ("aot_hit", dict(key="scan|4194304|int32|cuda", build_s=0.0,
                         load_s=0.01, plan_s=0.001, prior_build_s=21.5)),
        ("prewarm_start", dict(kernels=["scan", "sgemm"], device="cuda")),
        ("prewarm_kernel", dict(kernel="scan", wall_s=0.4,
                                expected="miss")),
        ("prewarm_kernel", dict(kernel="sgemm", status="error",
                                error="a spill")),
        ("prewarm_end", dict(warmed=1, failed=["sgemm"],
                             total_wall_s=9.5)),
        ("chaos_fleet_stats", dict(workers=[{"served": 3}])))]
    assert lines[0].endswith("aot MISS scan|4194304|int32|cuda (build 0.0s, "
                             "load 0.01s, plan 0.002s)")
    assert "prior build 21.5s" in lines[1]
    assert lines[2].endswith("prewarm started: 2 kernel config(s) on cuda")
    assert lines[3].endswith("prewarm scan warmed in 0.4s (expected miss)")
    assert lines[4].endswith("prewarm sgemm FAILED (error): a spill")
    assert lines[5].endswith("prewarm done: 1 warmed, 1 failed in 9.5s")
    assert lines[6] is None


def _revalidate(tmp_path, queue, plan=None, **extra):
    env = {k: v for k, v in os.environ.items() if not k.startswith("TPKT_")}
    env.update(TPKT_SUPERVISOR_DIR=str(tmp_path / "state"),
               TPKT_HEALTH_JOURNAL=str(tmp_path / "journal"),
               TPKT_REVALIDATE_LOCK=str(tmp_path / "lock"),
               TPKT_SUPERVISOR_WINDOW_MIN="30", **extra)
    if plan is not None:
        env["TPKT_FAULT_PLAN"] = json.dumps(plan)
    return subprocess.run(
        [sys.executable, "-m", "tpukernels_torch.revalidate", "--queue",
         str(queue)], env=env, capture_output=True, text=True, timeout=120,
        cwd=ROOT)


def test_one_session_renders_in_both_reports(tmp_path):
    """A traced session with a step wedged and quarantined, then a green
    run: the health report's step table and narrative, and obs.report's
    step breakdown with the span's wall, show the same steps and
    outcomes; the reference's health report renders the same table."""
    (tmp_path / "journal").mkdir()
    qf = tmp_path / "queue.json"
    qf.write_text(json.dumps([
        {"name": "w", "shell": "sleep 60", "timeout_s": 1, "cost_min": 1,
         "value": 10, "quarantine_after": 1},
        {"name": "x", "shell": "true", "cost_min": 1, "value": 5,
         "needs_chip": False}]))
    assert _revalidate(tmp_path, qf, plan={"probe": ["dead"]},
                       TPKT_TRACE="1").returncode == 124
    assert _revalidate(tmp_path, qf).returncode == 0
    env = {k: v for k, v in os.environ.items() if not k.startswith("TPKT_")}
    env["TPKT_HEALTH_JOURNAL"] = str(tmp_path / "journal")
    p = subprocess.run([sys.executable, "-m",
                        "tpukernels_torch.obs.health_report"], env=env,
                       cwd=ROOT, capture_output=True, text=True, timeout=60)
    assert p.returncode == 0, p.stderr
    out = p.stdout
    assert "supervisor steps (attempts / outcomes / quarantine):" in out
    assert "timeout on w classified WEDGED" in out
    assert "step w QUARANTINED after 1 wedge(s)" in out
    assert "healthy-window estimate 30.0 min (env, 0 observed)" in out
    table = [ln for ln in out.splitlines() if ln.startswith("  w ")
             or ln.startswith("  x ")]
    assert len(table) == 2 and "wedged=1" in table[0] and \
        "QUARANTINED" in table[0] and "green=1" in table[1]
    (journal,) = (tmp_path / "journal").glob("health_*.jsonl")
    ref = subprocess.run([sys.executable, str(ROOT / "tools" /
                                              "health_report.py"),
                          str(journal)], cwd=ROOT, capture_output=True,
                         text=True, timeout=60)
    assert ref.returncode == 0, ref.stderr
    assert [ln for ln in ref.stdout.splitlines()
            if ln.startswith(("  w ", "  x "))] == table
    obs = subprocess.run([sys.executable, "-m", "tpukernels_torch.obs.report",
                          "--journal", str(journal)], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert obs.returncode == 0, obs.stderr
    assert "supervisor step breakdown (2 step(s), 1 traced)" in obs.stdout
    (w_row,) = [ln for ln in obs.stdout.splitlines() if ln.startswith("w ")]
    assert "wedged=1" in w_row and "QUARANTINED" in w_row
    assert w_row.split()[3] != "-"            # the step/w span's wall


def test_what_it_reads(tmp_path):
    """Its arguments, else TPKT_HEALTH_JOURNAL (a directory: its newest
    dated file); with neither no journal, rc 1, though docs/logs holds
    the reference's journals."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("TPKT_")}

    def run(*args, **extra):
        return subprocess.run(
            [sys.executable, "-m", "tpukernels_torch.obs.health_report",
             *args], env={**env, **extra}, cwd=ROOT, capture_output=True,
            text=True, timeout=60)

    p = run()
    assert p.returncode == 1 and "no journal" in p.stderr
    assert list(DOCS_LOGS.glob("health_*.jsonl"))
    d = tmp_path / "j"
    d.mkdir()
    for day, step in (("2026-10-16", "old"), ("2026-10-17", "new")):
        (d / f"health_{day}.jsonl").write_text(json.dumps(_ev(
            "step_skipped", 0, step=step, reason="green-today")) + "\n")
    p = run(TPKT_HEALTH_JOURNAL=str(d))
    assert p.returncode == 0, p.stderr
    assert "step new skipped" in p.stdout and "step old" not in p.stdout
    p = run(str(d / "health_2026-10-16.jsonl"),
            str(d / "health_2026-10-17.jsonl"))
    assert "step old skipped" in p.stdout and "step new skipped" in p.stdout
    assert "health report: 2 events" in p.stdout
    p = run(TPKT_HEALTH_JOURNAL="off")
    assert p.returncode == 1


def test_imports_no_torch():
    code = ("import sys, tpukernels_torch.obs.health_report\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'jaxlib', 'tpukernels')))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=60)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"
