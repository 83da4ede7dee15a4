"""The port's request-timeline assembly against the reference, on the CPU.

``tpukernels_torch/obs/reqtrace.py`` and the reference's
``tpukernels/obs/reqtrace.py`` get the same journal events — a clean
request, a wedged-and-requeued one, a spilled one, a replay off a dead
worker and one off a dead router's WAL, a hedge with its cancelled
loser, an expired and an infeasible deadline, a rejected-then-served
and a throttled request, a client-confirmed request no worker journaled,
skewed process clocks, untraced records and junk — and must assemble
the same timelines, aggregate the same phase table and summarise the
same run budget. A real journal of the port's daemon is held the same
way in ``tests/test_torch_loadgen.py``.
"""

import copy

import pytest

from tpukernels.obs import reqtrace as ref
from tpukernels_torch.obs import reqtrace


def _span(rid, name, wall, t, pid=10, depth=1, ok=True):
    return {"kind": "span", "request_id": rid, "name": name, "wall_s": wall,
            "t": t, "pid": pid, "depth": depth, "ok": ok}


def _client(rid, wall, kernel="scan", ok=True, tenant=None, pid=1):
    return {"kind": "serve_client_request", "request_id": rid,
            "kernel": kernel, "wall_s": wall, "ok": ok, "tenant": tenant,
            "pid": pid, "t": 100.0}


def _server(rid, t, ok=True, pid=10, bucket="scan|4096|-", worker=None,
            kernel="scan", tenant=None):
    return {"kind": "serve_request", "request_id": rid, "t": t, "ok": ok,
            "pid": pid, "bucket": bucket, "worker_id": worker,
            "kernel": kernel, "tenant": tenant}


def _clean(rid, t0, pid=10, kernel="scan", tenant=None):
    return [
        _span(rid, "serve/wait/queue", 0.002, t0 + 0.002, pid),
        _span(rid, "serve/wait/lock", 0.0005, t0 + 0.0025, pid),
        _span(rid, "serve/pad", 0.001, t0 + 0.0035, pid),
        _span(rid, f"serve/{kernel}", 0.010, t0 + 0.0135, pid),
        _span(rid, f"serve/{kernel}/dispatch/{kernel}", 0.006, t0 + 0.012,
              pid, depth=2),
        _span(rid, f"serve/{kernel}/aot/load/{kernel}", 0.001, t0 + 0.008,
              pid, depth=3),
        _span(rid, f"serve/{kernel}/integrity/canary/{kernel}", 0.002,
              t0 + 0.011, pid, depth=3),
        _server(rid, t0 + 0.014, pid=pid, kernel=kernel, tenant=tenant),
        _client(rid, 0.020, kernel=kernel, tenant=tenant),
    ]


EVENTS = (
    [{"kind": "serve_start", "pid": 10, "t": 99.0},
     {"kind": "serve_start", "pid": 11, "t": 5000.0},  # a skewed clock
     {"kind": "serve_start", "pid": 10, "t": 98.0}]     # the first wins
    + _clean("r-clean", 100.0)
    + _clean("r-tenant", 100.5, kernel="vector_add", tenant="acme")
    # wedged on worker 0, requeued, answered by the same daemon
    + [_span("r-wedge", "serve/wait/queue", 0.001, 101.001),
       {"kind": "serve_request_requeued", "request_id": "r-wedge",
        "timeout_s": 2.0, "pid": 10, "t": 103.0},
       _server("r-wedge", 103.0, ok=False),
       _span("r-wedge", "serve/scan", 0.02, 103.1),
       _server("r-wedge", 103.2),
       _client("r-wedge", 2.3)]
    # spilled from worker 0 to worker 1 (another pid, another clock)
    + [{"kind": "serve_route", "request_id": "r-spill", "kernel": "scan",
        "bucket": "scan|4096|-", "pid": 5, "t": 104.0},
       {"kind": "serve_spill", "request_id": "r-spill", "pid": 5,
        "t": 104.1, "reason": "wedged"},
       _span("r-spill", "serve/scan", 0.01, 5001.0, pid=11),
       _server("r-spill", 5001.01, pid=11, worker="1"),
       _client("r-spill", 0.5)]
    # replayed off a dead worker, and off a dead router's WAL (twice:
    # once replayed, once skipped)
    + [{"kind": "serve_request_replayed", "request_id": "r-dead",
        "from_worker": "0", "to_worker": "1", "pid": 5, "t": 105.0},
       _span("r-dead", "serve/scan", 0.01, 5002.0, pid=11),
       _server("r-dead", 5002.01, pid=11, worker="1"),
       _client("r-dead", 1.0),
       {"kind": "serve_request_replayed", "request_id": "r-wal",
        "via": "wal", "to_worker": "1", "pid": 6, "t": 106.0},
       {"kind": "serve_request_replayed", "request_id": "r-wal2",
        "via": "wal", "ok": False, "reason": "stale", "pid": 6,
        "t": 106.5},
       _server("r-wal", 106.1, pid=11),
       _client("r-wal", 0.9), _client("r-wal2", 0.4)]
    # a hedge: the loser cancelled
    + [{"kind": "serve_hedged", "request_id": "r-hedge", "from_worker": "0",
        "to_worker": "1", "threshold_s": 0.05, "pid": 5, "t": 107.0},
       {"kind": "serve_cancelled", "request_id": "r-hedge", "site":
        "router", "to_worker": "0", "pid": 5, "t": 107.1},
       {"kind": "serve_cancelled", "request_id": "r-hedge", "site":
        "server", "phase": "queued", "pid": 10, "t": 107.2},
       _span("r-hedge", "serve/scan", 0.01, 107.05, pid=11),
       _server("r-hedge", 107.06, pid=11),
       _client("r-hedge", 0.07)]
    # deadlines
    + [{"kind": "serve_request_expired", "request_id": "r-exp",
        "site": "server", "where": "queue", "pid": 10, "t": 108.0},
       _span("r-exp", "serve/wait/queue", 0.3, 108.0),
       _client("r-exp", 0.31, ok=False),
       {"kind": "serve_deadline_infeasible", "request_id": "r-inf",
        "pid": 5, "t": 108.5},
       _client("r-inf", 0.001, ok=False)]
    # rejected once then served; throttled once then served
    + [{"kind": "serve_rejected", "request_id": "r-rej", "pid": 10,
        "t": 109.0}]
    + _clean("r-rej", 109.1)
    + [{"kind": "serve_tenant_throttled", "request_id": "r-thr", "pid": 5,
        "t": 109.5}]
    + _clean("r-thr", 109.6)
    # the client saw an answer that no worker journaled
    + [_client("r-lost", 0.2)]
    # untraced records, junk, stamps of the wrong type
    + [{"kind": "serve_request", "kernel": "scan", "ok": True},
       {"kind": "serve_request", "kernel": "scan", "ok": True},
       {"kind": "metrics"}, {"kind": "span", "name": "dispatch/scan"},
       {"kind": "span", "request_id": "r-junk", "name": None,
        "wall_s": "x", "t": None},
       {"kind": "serve_client_request", "request_id": 42, "wall_s": None},
       {"kind": "unknown_kind", "request_id": "r-clean"}]
)


@pytest.mark.parametrize("n", (0, 9, 30, len(EVENTS)))
def test_assemble_and_aggregate_equal_reference(n):
    events = EVENTS[:n]
    mine = reqtrace.assemble(copy.deepcopy(events))
    assert mine == ref.assemble(copy.deepcopy(events))
    assert reqtrace.aggregate(mine) == ref.aggregate(mine)
    assert reqtrace.untraced_serve_requests(events) == \
        ref.untraced_serve_requests(events)


def test_the_timelines_say_what_happened():
    tls = reqtrace.assemble(EVENTS)
    clean = tls["r-clean"]
    assert clean["clean"] and clean["coverage"] == pytest.approx(
        0.0135 / 0.020, abs=1e-4)
    assert clean["phases"]["compile"] == pytest.approx(0.001)
    assert clean["phases"]["dispatch"] == pytest.approx(0.010 - 0.003)
    assert tls["r-tenant"]["tenant"] == "acme"
    gaps = {rid: [g["kind"] for g in t["gaps"]] for rid, t in tls.items()}
    assert gaps["r-wedge"] == ["abandoned-worker"]
    assert gaps["r-dead"] == ["dead-worker"]
    assert gaps["r-wal"] == ["dead-router"]
    # skipped by the WAL replay and retried: no worker record survives
    assert gaps["r-wal2"] == ["dead-router", "missing-server-record"]
    assert gaps["r-hedge"] == ["hedged", "cancelled", "cancelled"]
    assert gaps["r-exp"] == ["deadline-expired"]
    assert gaps["r-inf"] == ["deadline-infeasible"]
    assert gaps["r-lost"] == ["missing-server-record"]
    for rid in ("r-wedge", "r-spill", "r-dead", "r-hedge", "r-rej",
                "r-thr", "r-exp"):
        assert not tls[rid]["clean"], rid
    assert tls["r-spill"]["worker_id"] == "1"
    # the skewed worker's lane is anchored to its own serve_start
    (seg,) = tls["r-spill"]["segments"]
    assert seg["rel1"] == pytest.approx(1.0)


@pytest.mark.parametrize("ids", [None, ["r-clean", "r-tenant", "r-none"],
                                 ["r-wedge", "r-hedge"], ["r-none"]],
                         ids=["all", "three", "gated-out", "absent"])
def test_run_budget_equals_reference(ids):
    mine = reqtrace.run_budget(copy.deepcopy(EVENTS), request_ids=ids)
    assert mine == ref.run_budget(copy.deepcopy(EVENTS), request_ids=ids)
    if ids == ["r-none"]:
        assert mine is None


@pytest.mark.parametrize("name", [
    "serve/wait/queue", "serve/wait/lock", "serve/pad", "serve/scan",
    "serve/scan/dispatch/scan", "dispatch/scan", "serve/scan/aot/plan/scan",
    "aot/load/x", "integrity/canary/scan", "serve/x/integrity/canary/y",
    "collective/allreduce", "capi/scan", ""])
def test_phase_of_equals_reference(name):
    assert reqtrace.phase_of(name) == ref.phase_of(name)


def test_coverage_knob(monkeypatch):
    monkeypatch.delenv("TPKT_TRACE_COVERAGE_MIN", raising=False)
    assert reqtrace.coverage_min() == reqtrace.DEFAULT_COVERAGE_MIN == 0.5
    monkeypatch.setenv("TPKT_TRACE_COVERAGE_MIN", "0.25")
    monkeypatch.setenv("TPK_TRACE_COVERAGE_MIN", "0.25")
    assert reqtrace.coverage_min() == ref.coverage_min() == 0.25
    assert reqtrace.run_budget(EVENTS) == ref.run_budget(EVENTS)
    for bad in ("1.5", "-0.1", "x"):
        monkeypatch.setenv("TPKT_TRACE_COVERAGE_MIN", bad)
        with pytest.raises(ValueError, match="TPKT_TRACE_COVERAGE_MIN"):
            reqtrace.coverage_min()
