"""The port fleet's health manager against the reference, on the CPU.

The port's daemons run with ``TPKT_SERVE_DEVICE=cpu`` behind the port's
router (``tests/test_torch_serve_fleet.py``'s helpers), the health
windows compressed. Here:

- units: ``pidfile_state`` and ``probe_worker`` give the reference's
  answers for a missing, a stale, a held and a live pidfile, and a
  missing and a live socket;
- chaos, one drive each, as the reference's own tests drive its fleet:
  a worker wedged on scan (``wedge_dispatch`` narrowed to its
  ``TPKT_SERVE_WORKER_ID``) gives a spill with reason ``wedged``, then
  the cooldown routes straight to the sibling; a worker SIGKILLed in the
  middle of a stream of requests (``kill_worker``) gives ``worker_dead``,
  one ``serve_request_replayed``, ``worker_respawned`` and no dropped
  request; a crash loop ends in ``worker_quarantined`` and ``ctl
  health`` rc 1; with a bucket's home and sibling both down, batch
  requests are shed with a backoff hint while interactive ones are
  served.

Every wait has its own deadline; no sleep is longer than the probe
interval.
"""

import json
import os
import signal
import threading
import time

import numpy as np
import pytest

from test_torch_serve_fleet import (
    FAST_HEALTH,
    SCAN_BUCKET,
    _ctl,
    _events,
    _fleet,
    _scan_case,
    _wait_events,
)
from tpukernels.serve import client as ref_client
from tpukernels.serve import health as ref_health
from tpukernels_torch.serve import health, proc, router


def test_pidfile_state_and_probe_are_the_references(tmp_path):
    missing = str(tmp_path / "none.pid")
    stale = tmp_path / "stale.pid"
    stale.write_text("12345\n")
    held_path = str(tmp_path / "held.pid")
    f = proc.hold_pidfile(held_path)
    try:
        for path in (missing, str(stale), held_path):
            assert (health.pidfile_state(path)
                    == ref_health.pidfile_state(path))
        assert health.pidfile_state(held_path) == (True, os.getpid())
        assert health.pidfile_state(str(stale)) == (False, 12345)
        # a held pidfile beside a socket that does not answer: slow
        sock = str(tmp_path / "held.sock")
        os.replace(held_path, str(tmp_path / "serve.pid"))
        assert health.probe_worker(sock, 0.2) == ("slow", os.getpid())
        assert ref_health.probe_worker(sock, 0.2) == ("slow", os.getpid())
    finally:
        f.close()
    dead = str(tmp_path / "gone" / "serve.sock")
    assert health.probe_worker(dead, 0.2) == ("dead", None)
    assert ref_health.probe_worker(dead, 0.2) == ("dead", None)
    # a second holder is refused while the first holds
    f = proc.hold_pidfile(held_path)
    try:
        with pytest.raises(RuntimeError, match="another serve daemon"):
            proc.hold_pidfile(held_path)
    finally:
        f.close()


def test_retry_hint_follows_the_backoff(tmp_path):
    socks = [str(tmp_path / f"w{i}" / "serve.sock") for i in range(2)]
    mine = health.HealthManager(socks, repo=str(tmp_path), probe_s=0.5,
                                restart_max=2, backoff_s=0.2)
    ref = ref_health.HealthManager(socks, repo=str(tmp_path), probe_s=0.5,
                                   restart_max=2, backoff_s=0.2)
    for hm in (mine, ref):
        assert hm.retry_hint() == 0.5
        hm.workers[0].state = "quarantined"
        assert hm.retry_hint([0]) == health.MAX_DEGRADED_HINT_S
        hm.workers[1].state = "joining"
        assert hm.retry_hint([1]) == 0.5
        assert hm.live_count() == 0
    assert mine.row(0) == ref.row(0)


def test_wedged_worker_spills_then_cools(tmp_path):
    """Every scan dispatch on the bucket's home wedges: the home's own
    watchdog gives up and answers ``wedged``, the router spills to the
    sibling and cools the home, and the next request goes straight to
    the sibling."""
    home, sib = router.ring_order(SCAN_BUCKET, 2)[:2]
    plan = json.dumps({"wedge_dispatch": {
        "kernel": "scan", "times": 0,
        "env": {"TPKT_SERVE_WORKER_ID": str(home)}}})
    with _fleet(tmp_path, n=2, TPKT_SERVE_REQUEST_TIMEOUT_S="1",
                TPKT_ROUTE_COOLDOWN_S="120", TPKT_FAULT_PLAN=plan) as (
            front, jpath, _env):
        x, want = _scan_case()
        with ref_client.ServeClient(front, timeout_s=120) as c:
            np.testing.assert_array_equal(c.dispatch("scan", x), want)
            np.testing.assert_array_equal(c.dispatch("scan", x), want)
    events = _events(jpath)
    spills = [e for e in events if e["kind"] == "serve_spill"]
    assert [(e["reason"], e["from_worker"], e["to_worker"])
            for e in spills] == [("wedged", home, sib)]
    routes = [e for e in events if e["kind"] == "serve_route"]
    assert [(e["ok"], e["worker"], e["spilled_from"]) for e in routes] == [
        (True, sib, home), (True, sib, None)]
    # the home's watchdog evidence is in the fleet's one journal
    assert any(e["kind"] == "serve_request_requeued" for e in events)
    assert any(e["kind"] == "fault_injected"
               and e.get("fault") == "wedge_dispatch" for e in events)


def test_kill_worker_mid_stream_self_heals(tmp_path):
    """The scan bucket's home SIGKILLs itself on its third scan dispatch
    (``kill_worker`` with a once file, so the respawned worker runs
    clean) while a client streams requests: no request drops, the one in
    flight is replayed on the sibling, and the home is respawned,
    smoke-checked and back in the ring."""
    home, sib = router.ring_order(SCAN_BUCKET, 2)[:2]
    once = tmp_path / "killed.once"
    plan = json.dumps({"kill_worker": {
        "kernel": "scan", "on_call": 3, "once_file": str(once),
        "env": {"TPKT_SERVE_WORKER_ID": str(home)}}})
    with _fleet(tmp_path, n=2, TPKT_FAULT_PLAN=plan, **FAST_HEALTH) as (
            front, jpath, env):
        wsock = os.path.join(env["TPKT_SERVE_DIR"], "fleet",
                             f"worker{sib}", "serve.sock")
        state, pid = health.probe_worker(wsock)
        assert state == "up" and pid
        assert ref_health.probe_worker(wsock) == (state, pid)
        x, want = _scan_case()
        errors, done = [], []
        stop = threading.Event()

        def stream():
            try:
                with ref_client.ServeClient(front, timeout_s=120) as c:
                    k = 0
                    while not stop.is_set():
                        c.next_request_id = f"kw-{k}"
                        np.testing.assert_array_equal(c.dispatch("scan", x),
                                                      want)
                        done.append(k)
                        k += 1
                        time.sleep(0.02)
            except Exception as e:  # noqa: BLE001 - collected, asserted
                errors.append(repr(e))

        t = threading.Thread(target=stream)
        t.start()
        try:
            _, resp = _wait_events(
                jpath, lambda e: e["kind"] == "worker_respawned",
                timeout=90, msg="worker_respawned")
            _wait_events(
                jpath, lambda e: (e["kind"] == "serve_route"
                                  and e["t"] > resp[0]["t"]
                                  and e["worker"] == home),
                timeout=60, msg="a request routed to the healed home")
        finally:
            stop.set()
            t.join(60)
        assert not t.is_alive() and not errors, errors
        r = _ctl(env, "health", "--wait", "30")
        assert r.returncode == 0 and "CONVERGED" in r.stdout, r.stdout
        r = _ctl(env, "status")
        assert r.returncode == 0 and "restarts=1" in r.stdout, r.stdout
    assert once.exists(), "the kill fault never fired"
    events = _events(jpath)
    routes = [e for e in events if e["kind"] == "serve_route"
              and str(e.get("request_id")).startswith("kw-")]
    assert len(routes) == len(done) and all(e["ok"] for e in routes)
    (dead,) = [e for e in events if e["kind"] == "worker_dead"]
    assert dead["worker"] == home and dead["crashes"] == 1
    assert dead["via"] in ("transport", "probe")
    assert "swept_segments" in dead and "swept_bytes" in dead
    (rep,) = [e for e in events if e["kind"] == "serve_request_replayed"]
    assert (rep["from_worker"], rep["to_worker"]) == (home, sib)
    served = [e for e in events if e["kind"] == "serve_request"
              and e.get("request_id") == rep["request_id"]]
    assert [(e["worker_id"], e["replayed"], e["ok"]) for e in served] == [
        (str(sib), 1, True)]
    (resp,) = [e for e in events if e["kind"] == "worker_respawned"]
    assert resp["worker"] == home and resp["down_s"] is not None
    assert [e["level"] for e in events
            if e["kind"] == "fleet_degraded"] == ["degraded", "ok"]
    assert any(e["kind"] == "serve_request"
               and str(e.get("request_id")).startswith("fleet-smoke-")
               for e in events)


def test_crash_loop_quarantines_loudly(tmp_path):
    """Every incarnation of the home dies on its first scan dispatch
    (the rejoin smoke is a scan): at ``TPKT_FLEET_RESTART_MAX`` crashes
    it is quarantined, out of the ring, and the sibling serves both
    priority classes."""
    home, sib = router.ring_order(SCAN_BUCKET, 2)[:2]
    plan = json.dumps({"kill_worker": {
        "kernel": "scan", "env": {"TPKT_SERVE_WORKER_ID": str(home)}}})
    with _fleet(tmp_path, n=2, TPKT_FAULT_PLAN=plan,
                TPKT_FLEET_RESTART_MAX="2", **FAST_HEALTH) as (
            front, jpath, env):
        x, want = _scan_case()
        with ref_client.ServeClient(front, timeout_s=120) as c:
            # the home dies holding this request; the replay answers
            np.testing.assert_array_equal(c.dispatch("scan", x), want)
        events, quar = _wait_events(
            jpath, lambda e: e["kind"] == "worker_quarantined",
            timeout=90, msg="worker_quarantined")
        assert [(e["worker"], e["threshold"]) for e in quar] == [(home, 2)]
        deaths = [e for e in events if e["kind"] == "worker_dead"]
        assert len(deaths) == 2 and all(e["worker"] == home for e in deaths)
        assert deaths[1]["via"] == "join"
        assert not any(e["kind"] == "worker_respawned" for e in events)
        for prio in ("interactive", "batch"):
            with ref_client.ServeClient(front, timeout_s=120,
                                        priority=prio) as c:
                c.next_request_id = f"cl-{prio}"
                np.testing.assert_array_equal(c.dispatch("scan", x), want)
        routes = {e.get("request_id"): e for e in _events(jpath, "serve_route")}
        assert {routes[f"cl-{p}"]["worker"]
                for p in ("interactive", "batch")} == {sib}
        r = _ctl(env, "status")
        assert "QUARANTINED" in r.stdout, r.stdout + r.stderr
        r = _ctl(env, "health", "--wait", "1")
        assert r.returncode == 1 and "NOT converged" in r.stdout, r.stdout
        # no respawn follows the quarantine: several probe passes later
        # the deaths are still two
        deadline = time.monotonic() + 2.0
        while time.monotonic() < deadline:
            assert len(_events(jpath, "worker_dead")) == 2
            time.sleep(0.3)


def test_home_and_sibling_down_shed_batch_first(tmp_path):
    """Three workers, the scan bucket's home and sibling killed and kept
    down: the fleet goes critical, a batch request is shed with a
    backoff hint, an interactive one rides the last member; with every
    worker down, interactive is shed too."""
    home, sib, last = router.ring_order(SCAN_BUCKET, 3)
    with _fleet(tmp_path, n=3, TPKT_FLEET_PROBE_S="0.3",
                TPKT_FLEET_RESTART_BACKOFF_S="120") as (front, jpath, env):
        def kill(idx):
            pidfile = os.path.join(env["TPKT_SERVE_DIR"], "fleet",
                                   f"worker{idx}", "serve.pid")
            os.kill(health.pidfile_state(pidfile)[1], signal.SIGKILL)

        kill(home)
        kill(sib)
        _, crit = _wait_events(
            jpath, lambda e: (e["kind"] == "fleet_degraded"
                              and e["level"] == "critical"
                              and len(e["down"]) == 2),
            timeout=30, msg="fleet_degraded critical")
        assert sorted(crit[-1]["down"]) == sorted([home, sib])
        x, want = _scan_case()
        with ref_client.ServeClient(front, timeout_s=60, priority="batch",
                                    tenant="bg") as c:
            with pytest.raises(ref_client.ServeRejected) as exc:
                c.dispatch("scan", x)
        assert 0 < exc.value.retry_after_s <= health.MAX_DEGRADED_HINT_S
        with ref_client.ServeClient(front, timeout_s=120) as c:
            c.next_request_id = "shed-interactive"
            np.testing.assert_array_equal(c.dispatch("scan", x), want)
        events = _events(jpath)
        (route,) = [e for e in events if e["kind"] == "serve_route"
                    and e.get("request_id") == "shed-interactive"]
        assert route["ok"] and route["worker"] == last
        sheds = [e for e in events if e["kind"] == "serve_rejected"
                 and e.get("reason") == "fleet_degraded"]
        assert [e["priority"] for e in sheds] == ["batch"]
        kill(last)
        _wait_events(jpath, lambda e: (e["kind"] == "worker_dead"
                                       and e["worker"] == last),
                     timeout=30, msg=f"worker_dead {last}")
        with ref_client.ServeClient(front, timeout_s=60) as c:
            with pytest.raises(ref_client.ServeRejected) as exc:
                c.dispatch("scan", x)
        assert 0 < exc.value.retry_after_s <= health.MAX_DEGRADED_HINT_S
        r = _ctl(env, "health", "--wait", "1")
        assert r.returncode == 1, r.stdout + r.stderr
