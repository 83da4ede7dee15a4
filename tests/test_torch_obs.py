"""The port's metrics and spans against the JAX package's (CPU).

The same samples go into both packages' histograms and must land in the
same log buckets with the same percentiles; the same span events must
aggregate the same way. Then the port's own: the disabled tracer's
shared no-op, nested span paths, reserved field names, ``clear`` and a
threaded stress test of the counters.
"""

import json
import sys
import threading

import numpy as np
import pytest

from tpukernels.obs import metrics as ref_metrics
from tpukernels.obs import trace as ref_trace
from tpukernels_torch.obs import metrics, trace
from tpukernels_torch.resilience import journal


@pytest.fixture
def fresh():
    metrics.reset()
    ref_metrics.reset()
    yield
    metrics.reset()
    ref_metrics.reset()


@pytest.fixture
def traced(monkeypatch, tmp_path):
    path = tmp_path / "spans.jsonl"
    monkeypatch.setenv("TPKT_HEALTH_JOURNAL", str(path))
    monkeypatch.setenv("TPKT_TRACE", "1")
    trace.reload()
    yield lambda: journal.load_events([path])[0]
    monkeypatch.delenv("TPKT_TRACE")
    trace.reload()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histograms_match_reference(fresh, seed):
    rng = np.random.default_rng(seed)
    samples = np.concatenate([rng.lognormal(-7, 1.5, 500), [0.0, -1e-9],
                              rng.uniform(1e-6, 5e-6, 50)]).tolist()
    for v in samples:
        metrics.observe("dispatch.wall_s.scan", v)
        ref_metrics.observe("dispatch.wall_s.scan", v)
        assert metrics.bucket_index(v) == ref_metrics.bucket_index(v)
    got = metrics.snapshot()["histograms"]["dispatch.wall_s.scan"]
    want = ref_metrics.snapshot()["histograms"]["dispatch.wall_s.scan"]
    assert got == want
    assert got["count"] == len(samples) and got["max"] == round(
        max(samples), 6)


def test_percentiles_match_reference():
    buckets = {"-3": 4, "2": 90, "7": 5, "9": 1}
    for qs in ((0.5, 0.95, 0.99), (0.01, 1.0)):
        assert metrics.percentiles(100, 3.0, buckets, qs) == (
            ref_metrics.percentiles(100, 3.0, buckets, qs))
    for idx in (-40, -1, 0, 3, metrics._NONPOS_BUCKET):
        assert metrics.bucket_upper(idx) == ref_metrics.bucket_upper(idx)


def test_counters_gauges_snapshot(fresh):
    metrics.inc("a")
    metrics.inc("a", 2)
    metrics.inc("b.x")
    metrics.gauge("g", 1.5)
    metrics.gauge("g", 2.5)
    snap = metrics.snapshot()
    assert snap["counters"] == {"a": 3, "b.x": 1}
    assert snap["gauges"] == {"g": 2.5}
    assert metrics.counter("a") == 3 and metrics.counter("zz") == 0
    assert metrics.counters("b.") == {"b.x": 1}
    snap["counters"]["a"] = 99  # a copy
    assert metrics.counter("a") == 3
    assert json.loads(json.dumps(snap)) == snap


def test_clear_drops_one_prefix(fresh):
    metrics.inc("dispatch.calls.scan")
    metrics.inc("integrity.checks")
    metrics.observe("dispatch.wall_s.scan", 1e-3)
    metrics.gauge("dispatch.calls.g", 1)
    metrics.clear("dispatch.calls.")
    snap = metrics.snapshot()
    assert snap["counters"] == {"integrity.checks": 1}
    assert snap["gauges"] == {}
    assert list(snap["histograms"]) == ["dispatch.wall_s.scan"]


def test_counters_survive_threads(fresh):
    """No lost update under contention: 8 threads x 5000 increments
    with a short switch interval."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [(metrics.inc("n"), metrics.observe("h", 1.0))
                            for _ in range(5000)]) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert metrics.counter("n") == 40000
    assert metrics.snapshot()["histograms"]["h"]["count"] == 40000


def test_disabled_tracer_is_a_shared_noop(monkeypatch, tmp_path):
    monkeypatch.setenv("TPKT_HEALTH_JOURNAL", str(tmp_path / "j.jsonl"))
    for raw in (None, "0", "off", "none"):
        if raw is None:
            monkeypatch.delenv("TPKT_TRACE", raising=False)
        else:
            monkeypatch.setenv("TPKT_TRACE", raw)
        assert trace.reload() is False
        s = trace.span("dispatch/scan", n=1)
        assert s is trace.span("other")
        with s:
            assert trace.current_path() is None
        trace.emit_span("wait", 0.1)
    assert not (tmp_path / "j.jsonl").exists()


def test_spans_nest_and_emit(traced):
    with trace.span("dispatch/scan", n=4, name="x", wall_s=7):
        assert trace.current_path() == "dispatch/scan"
        with trace.span("integrity/canary/scan", site="registry"):
            assert trace.current_path() == (
                "dispatch/scan/integrity/canary/scan")
        trace.emit_span("wait", 0.25, q=1)
    with pytest.raises(ValueError):
        with trace.span("boom"):
            raise ValueError("x")
    events = traced()
    assert [e["name"] for e in events] == [
        "dispatch/scan/integrity/canary/scan", "dispatch/scan/wait",
        "dispatch/scan", "boom"]
    inner, wait, outer, boom = events
    assert (inner["depth"], inner["site"], inner["ok"]) == (2, "registry",
                                                            True)
    assert wait["wall_s"] == 0.25 and wait["q"] == 1
    assert outer["n"] == 4 and outer["param_name"] == "x"
    assert outer["param_wall_s"] == 7 and outer["wall_s"] >= inner["wall_s"]
    assert boom["ok"] is False
    assert trace.current_path() is None


def test_aggregate_spans_matches_reference(traced):
    for _ in range(3):
        with trace.span("dispatch/scan"):
            pass
    trace.emit_span("dispatch/sgemm", 0.5)
    events = traced() + [{"kind": "other", "name": "dispatch/scan"}]
    got = trace.aggregate_spans(events)
    assert got == ref_trace.aggregate_spans(events)
    assert got["dispatch/scan"]["count"] == 3
    assert got["dispatch/sgemm"] == {"count": 1, "total_s": 0.5,
                                     "max_s": 0.5}
