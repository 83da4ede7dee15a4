"""The port's serving daemon under faults and load, on the CPU.

Each test runs its own ``python -m tpukernels_torch.serve`` with
``TPKT_SERVE_DEVICE=cpu`` and its state in a temporary directory
(``tests/test_torch_serve.py``'s rig): backpressure (a full queue
rejects with ``retry_after_s``), a deadline that expires before
dispatch, a wedged dispatch abandoned and requeued once (the watchdog's
liveness probe and ``wedge_classification`` at site ``serve``),
``delay_response``, the ``cancel`` op, the copy accounting of the inline
and shm lanes (``bytes_copied``), the metrics flusher, the pidfile that
keeps a second daemon out, and a clean SIGTERM (rc 0, socket and pidfile
gone, ``serve_stop`` and the final metrics journaled, nothing on
stdout).
"""

import json
import os
import threading
import time
from unittest import mock

import numpy as np
import pytest

from test_torch_serve import _daemon
from tpukernels_torch import _cachedir
from tpukernels_torch.serve import client, protocol

# a slow scan: every scan dispatch sleeps before it runs
SLOW_SCAN = json.dumps({"slow_dispatch": {"kernel": "scan", "delay_s": 0.6}})


def _scan_input(n=3000, seed=1):
    return np.random.default_rng(seed).integers(0, 99, n).astype(np.int32)


def _one(sock, key, *args):
    """One request on a connection of its own, closed after."""
    with client.ServeClient(sock, timeout_s=60) as c:
        return c.dispatch(key, *args)


def _in_thread(fn):
    box = {}

    def run():
        try:
            box["out"] = fn()
        except Exception as e:  # noqa: BLE001 — read by the test
            box["err"] = e

    t = threading.Thread(target=run)
    t.start()
    return t, box


def test_backpressure_rejects_with_a_retry_hint(tmp_path):
    """One worker, a queue of one, scans that take 0.6 s: the third
    request at once is rejected, with a hint, and journaled."""
    with _daemon(tmp_path, args=("--workers", "1", "--queue-max", "1"),
                 TPKT_FAULT_PLAN=SLOW_SCAN) as d:
        x = _scan_input()
        runs = []
        for _ in range(2):  # one in flight, one queued
            runs.append(_in_thread(lambda: _one(d.sock, "scan", x)))
            time.sleep(0.2)
        with client.ServeClient(d.sock, timeout_s=60) as c:
            with pytest.raises(client.ServeRejected) as e:
                c.dispatch("scan", x)
        assert e.value.retry_after_s >= 0.05
        for t, box in runs:
            t.join(60)
            assert not t.is_alive() and "err" not in box
            np.testing.assert_array_equal(box["out"],
                                          np.cumsum(x, dtype=np.int32))
        # the shared policy waits out the hint and gets served
        with client.ServeClient(d.sock, timeout_s=60) as c:
            out = client.dispatch_with_backpressure(c, "scan", (x,), {})
        np.testing.assert_array_equal(out, np.cumsum(x, dtype=np.int32))
        (rej,) = d.events("serve_rejected")
        assert rej["queue_max"] == 1 and rej["retry_after_s"] >= 0.05


def test_deadline_expires_before_dispatch(tmp_path):
    """A request queued behind a slow one with a budget shorter than the
    wait is expired at the worker, never dispatched."""
    with _daemon(tmp_path, args=("--workers", "1"),
                 TPKT_FAULT_PLAN=SLOW_SCAN) as d:
        x = _scan_input()
        t, box = _in_thread(lambda: _one(d.sock, "scan", x))
        time.sleep(0.2)
        with client.ServeClient(d.sock, timeout_s=60,
                                deadline_ms=100) as c:
            c.next_request_id = "doomed"
            with pytest.raises(client.ServeExpired):
                c.dispatch("scan", x)
        t.join(60)
        assert not t.is_alive() and "err" not in box
        (exp,) = d.events("serve_request_expired")
        assert exp["request_id"] == "doomed" and exp["where"] == "worker"
        served = [e["request_id"] for e in d.events("serve_request")]
        assert "doomed" not in served and len(served) == 1


def test_wedged_dispatch_is_requeued_once(tmp_path):
    """The first scan dispatch hangs; the watchdog finds the device
    alive (slow), doubles the grace once, then abandons the worker and
    requeues the request, which the new worker answers correctly."""
    plan = json.dumps({"wedge_dispatch": {"kernel": "scan", "times": 1}})
    with _daemon(tmp_path, TPKT_FAULT_PLAN=plan,
                 TPKT_SERVE_REQUEST_TIMEOUT_S="0.5") as d:
        x = _scan_input()
        with client.ServeClient(d.sock, timeout_s=60) as c:
            out = c.dispatch("scan", x)
            np.testing.assert_array_equal(out, np.cumsum(x, dtype=np.int32))
            assert c.ping()["requeued"] == 1
        (req,) = d.events("serve_request_requeued")
        assert req["kernel"] == "scan"
        verdicts = d.events("wedge_classification")
        assert verdicts and all(v["site"] == "serve" for v in verdicts)
        assert verdicts[0]["verdict"] == "slow"  # the probe answered
        (fire,) = d.events("watchdog_fire")
        assert fire["mechanism"] == "serve-abandon"
        (done,) = d.events("serve_request")
        assert done["ok"] and done["requeues"] == 1


def test_delay_response_and_cancel(tmp_path):
    """``delay_response`` holds a finished scan; a cancel of a request
    queued behind it drops it before dispatch."""
    plan = json.dumps({"delay_response": {"kernel": "scan", "delay_s": 0.8,
                                          "times": 1}})
    with _daemon(tmp_path, args=("--workers", "1"),
                 TPKT_FAULT_PLAN=plan) as d:
        x = _scan_input()
        t, box = _in_thread(lambda: _one(d.sock, "scan", x))
        time.sleep(0.3)

        def queued():
            with client.ServeClient(d.sock, timeout_s=2) as c:
                c.next_request_id = "cancel-me"
                return c.dispatch("vector_add", np.float32(1),
                                  np.ones(8, np.float32),
                                  np.ones(8, np.float32))

        t2, box2 = _in_thread(queued)
        time.sleep(0.2)
        with client.ServeClient(d.sock, timeout_s=60) as c:
            h, _, _ = c._roundtrip({"v": 1, "op": "cancel", "id": 1,
                                    "request_id": "cancel-me"})
        assert h["ok"] and h["cancelled"] and h["phase"] == "queued"
        t.join(60)
        t2.join(60)
        assert not t.is_alive() and not t2.is_alive()
        np.testing.assert_array_equal(box["out"],
                                      np.cumsum(x, dtype=np.int32))
        assert "err" in box2  # never answered: the client timed out
        (fault,) = d.events("fault_injected")
        assert fault["site"] == "response" and fault["kernel"] == "scan"
        (cancel,) = d.events("serve_cancelled")
        assert cancel["request_id"] == "cancel-me"
        assert [e["kernel"] for e in d.events("serve_request")] == ["scan"]


def test_copy_accounting_of_the_lanes(tmp_path, monkeypatch):
    """``bytes_copied`` counts each byte through the socket and each
    copy the daemon adds: on the CPU, a read-only operand is copied
    before the tensor aliases it. The shm lane moves no payload byte
    through the socket, either way."""
    if not protocol.shm_available():
        pytest.skip("this host cannot map /dev/shm segments")
    x = _scan_input(4096)  # the avatar exactly: no pad copy
    nbytes = x.nbytes
    monkeypatch.setenv("TPKT_SERVE_SHM_MIN_BYTES", "1024")  # as the daemon
    with _daemon(tmp_path) as d:
        def delta(shm):
            if shm:
                monkeypatch.delenv("TPKT_SERVE_SHM", raising=False)
            else:
                monkeypatch.setenv("TPKT_SERVE_SHM", "0")
            with client.ServeClient(d.sock, timeout_s=60) as c:
                before = c.ping()["bytes_copied"]
                out = c.dispatch("scan", x)
                np.testing.assert_array_equal(out,
                                              np.cumsum(x, dtype=np.int32))
                assert c.staged_payloads == (1 if shm else 0)
                return c.ping()["bytes_copied"] - before

        # inline: the request's bytes in, the CPU copy, the result out
        assert delta(shm=False) == 3 * nbytes
        # shm: only the CPU copy (the result rides a segment)
        assert delta(shm=True) == nbytes
        lanes = d.events("serve_lane_negotiated")
        assert lanes and lanes[0]["lane"] == "shm"


def test_clean_sigterm_and_the_pidfile(tmp_path):
    """A second daemon on the same serve directory is refused (rc 3);
    SIGTERM ends the first with rc 0, its socket and pidfile gone,
    ``serve_stop`` and its final metrics journaled, nothing on stdout;
    with ``TPKT_METRICS_FLUSH_S`` the flusher streamed snapshots."""
    import subprocess
    import sys

    from test_torch_serve import ROOT, _env

    with _daemon(tmp_path, TPKT_METRICS_FLUSH_S="0.2") as d:
        with client.ServeClient(d.sock, timeout_s=60) as c:
            c.dispatch("scan", _scan_input())
        r = subprocess.run(
            [sys.executable, "-m", "tpukernels_torch.serve", "--socket",
             str(d.dir / "other.sock")], cwd=ROOT, env=_env(d.dir),
            capture_output=True, text=True, timeout=120)
        assert r.returncode == 3 and "another serve daemon" in r.stderr
        pid = int((d.dir / "serve.pid").read_text())
        assert pid == d.proc.pid
        time.sleep(0.5)
        with client.ServeClient(d.sock, timeout_s=60) as c:
            assert c.ping()["last_snapshot_age_s"] is not None
        assert d.stop() == 0
        out, err = d.output()
        assert out == "" and "listening on" in err
        assert not (d.dir / "s.sock").exists()
        assert not (d.dir / "serve.pid").exists()
        (stop,) = d.events("serve_stop")
        assert stop["served"] == 1 and stop["pid"] == d.proc.pid
        assert d.events("metrics_snapshot")
        (final,) = d.events("metrics")
        assert final["counters"]["serve.requests.scan"] == 1


# ------------------------------------------------------------------ #
# the seeded campaign (python -m tpukernels_torch.serve.chaos)        #
# ------------------------------------------------------------------ #

def _reference_chaos():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "ref_chaos", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "tools", "chaos.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed", range(20))
def test_campaign_schedule_is_the_references(seed, tmp_path, monkeypatch,
                                             capsys):
    """The reference's ``run_campaign`` with its ``_ctl`` answering rc 1
    prints its schedule and sets its fault plan before the fleet start
    fails; the port's ``schedule`` gives the same for 1-6 events."""
    import subprocess

    from tpukernels_torch.serve import chaos

    ref = _reference_chaos()
    monkeypatch.setattr(ref, "_ctl", lambda *a: subprocess.CompletedProcess(
        a, 1, "", "refused"))
    monkeypatch.setenv("TPK_SERVE_DIR", str(tmp_path / "ref"))
    monkeypatch.delenv("TPK_SERVE_FLEET_DIR", raising=False)
    once = str(tmp_path / "ref" / "fleet" / "wedge.once")
    before = {k: os.environ.get(k) for k in (
        "TPK_FAULT_PLAN", "TPK_SERVE_REQUEST_TIMEOUT_S",
        "TPK_CLIENT_RECONNECT_S", "TPK_HEALTH_JOURNAL")}
    for n in range(1, 7):
        # run_campaign assigns its knobs into os.environ: each call gets
        # them unset and leaves the environment as it found it
        with mock.patch.dict(os.environ):
            for var in ("TPK_FAULT_PLAN", "TPK_SERVE_REQUEST_TIMEOUT_S",
                        "TPK_CLIENT_RECONNECT_S", "TPK_HEALTH_JOURNAL"):
                os.environ.pop(var, None)
            capsys.readouterr()
            assert ref.run_campaign(seed, n, 2) == 1
            plan_json = os.environ.get("TPK_FAULT_PLAN", "{}")
        line = next(ln for ln in capsys.readouterr().err.splitlines()
                    if ln.startswith("# chaos: seed "))
        want_events = line.split("schedule: ", 1)[1].split(", ")
        want_plan = json.loads(plan_json.replace("TPK_", "TPKT_"))
        events, plan = chaos.schedule(seed, n, once)
        assert (events, plan) == (want_events, want_plan), (seed, n)
        assert chaos.EVENTS == ref.EVENTS
        assert chaos.RECOVER_WAIT_S == ref.RECOVER_WAIT_S
    # nothing of the reference's plan or knobs outlives the test
    assert before == {k: os.environ.get(k) for k in before}


def test_campaign_invariants_on_fixture_journals(tmp_path, monkeypatch):
    import subprocess
    import sys

    from tpukernels_torch.serve import chaos

    def req(rid, **kw):
        return dict({"kind": "serve_request", "request_id": rid, "ok": True},
                    **kw)

    chaos.assert_no_duplicate_dispatch(
        [req("a"), req("a", replayed=True), req("b"), req(None), req(None),
         {"kind": "serve_route", "request_id": "b"}])
    with pytest.raises(chaos.CampaignFailure, match="silent duplicate"):
        chaos.assert_no_duplicate_dispatch([req("a"), req("b"), req("a")])
    chaos.assert_goodput(10, 10, 90_000.0)
    with pytest.raises(chaos.CampaignFailure, match="goodput violated"):
        chaos.assert_goodput(10, 9, 90_000.0)
    # artifacts: absent and whole pass, a torn one fails
    good, torn = tmp_path / "good.json", tmp_path / "torn.json"
    good.write_text('{"a": 1}')
    torn.write_text('{"a": ')
    chaos.assert_artifacts_readable([str(good), str(tmp_path / "none")])
    with pytest.raises(chaos.CampaignFailure, match="torn after recovery"):
        chaos.assert_artifacts_readable([str(good), str(torn)])
    # leaks: a segment of this process or of a pid the campaign saw, a
    # live pid; another creator's segment is not the campaign's
    monkeypatch.setenv("TPKT_SERVE_DIR", str(tmp_path / "serve"))
    monkeypatch.delenv("TPKT_SERVE_FLEET_DIR", raising=False)
    shm = tmp_path / "shm"
    shm.mkdir()
    monkeypatch.setattr(chaos.serve_protocol, "SHM_DIR", str(shm))
    (shm / "tpkserve-1-0-abc").write_text("")
    chaos.assert_no_leaks(2, set(), wait_s=0)
    (shm / f"tpkserve-{os.getpid()}-3-0f").write_text("")
    with pytest.raises(chaos.CampaignFailure, match="leaked shm"):
        chaos.assert_no_leaks(2, set(), wait_s=0)
    (shm / f"tpkserve-{os.getpid()}-3-0f").unlink()
    (shm / "tpkserve-424242-0-1a").write_text("")
    with pytest.raises(chaos.CampaignFailure, match="leaked shm"):
        chaos.assert_no_leaks(2, {424242}, wait_s=0)
    (shm / "tpkserve-424242-0-1a").unlink()
    p = subprocess.Popen([sys.executable, "-c", "import time; "
                          "time.sleep(60)"])
    try:
        with pytest.raises(chaos.CampaignFailure, match="leaked process"):
            chaos.assert_no_leaks(2, {p.pid}, wait_s=0.2)
    finally:
        p.kill()
        p.wait(10)
    chaos.assert_no_leaks(2, {p.pid}, wait_s=5)


def test_torn_write_targets_are_rejected_by_their_readers(tmp_path,
                                                          monkeypatch):
    """Each artifact ``torn_write`` tears in turn is read in a fresh
    process that rejects it loudly (stderr and ``artifact_rejected``),
    and is removed after."""
    from tpukernels_torch.serve import chaos

    for var in ("TPKT_SERVE_DIR", *_cachedir.STATE_DIRS):
        monkeypatch.setenv(var, str(tmp_path / var.lower()))
    monkeypatch.setenv("TPKT_HEALTH_JOURNAL", str(tmp_path / "j.jsonl"))
    monkeypatch.setenv("PYTHONPATH", chaos._REPO)
    names = []
    for i in range(len(chaos.torn_targets()) + 1):
        detail = chaos._do_torn_write(None, {"torn_write": i + 1})
        names.append(detail["artifact"])
        assert not os.path.exists(detail["path"])
    assert names == ["tuning", "slo", "adapt", "rollup", "tuning"]
    events = [e for e in chaos._journal_events()
              if e.get("kind") == "artifact_rejected"]
    assert len(events) == 5


def _campaign_env(tmp_path, **extra):
    """The campaign's env: the rig's daemon env with the scan avatar
    alone, and the journal, state directories and shm threshold left to
    the campaign's own defaults."""
    from test_torch_serve import _env

    env = _env(tmp_path, TPKT_SERVE_BUCKETS=json.dumps(
        {"scan": {"args": [["i32", [4096]]], "statics": {}}}),
        TPKT_HEALTH_JOURNAL=None, TPKT_INTEGRITY_DIR=None,
        TPKT_TUNING_CACHE_DIR=None, TPKT_SERVE_SHM_MIN_BYTES=None, **extra)
    assert not any(k.startswith("TPK_") for k in env)
    return env, os.path.join(str(tmp_path), "fleet", "chaos_journal.jsonl")


def _campaign(tmp_path, argv, env, timeout):
    import subprocess
    import sys

    return subprocess.run(
        [sys.executable, "-m", "tpukernels_torch.serve.chaos", *argv],
        capture_output=True, text=True, env=env, timeout=timeout,
        cwd=env["PYTHONPATH"])


def _campaign_checks(r, journal_path, n):
    from tpukernels_torch.resilience import journal

    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-6000:]
    assert "chaos: campaign SURVIVED - seed 1" in r.stdout
    assert "0 dropped" in r.stdout
    events, _ = journal.load_events([journal_path])
    marks = [e for e in events if e.get("kind") == "chaos_event"]
    assert [e["seq"] for e in marks] == list(range(1, n + 1))
    assert all(e["seed"] == 1 and e["recover_s"] >= 0 for e in marks)
    return events


def test_a_two_event_campaign_survives_on_the_cpu(tmp_path):
    """Seed 1, two events (a router kill, then the armed wedge) against
    two CPU workers: rc 0, every invariant after every event, the
    report's check over the campaign's own journal, and no leak."""
    env, jp = _campaign_env(
        tmp_path, TPKT_FLEET_PROBE_S="0.3",
        TPKT_FLEET_RESTART_BACKOFF_S="0.2",
        TPKT_ROUTER_RESTART_BACKOFF_S="0.2",
        TPKT_SERVE_REQUEST_TIMEOUT_S="3")
    r = _campaign(tmp_path, ["--seed", "1", "--events", "2", "--workers",
                             "2"], env, timeout=300)
    events = _campaign_checks(r, jp, 2)
    assert [e["event"] for e in events if e.get("kind") == "chaos_event"] \
        == ["kill_router", "wedge_dispatch"]
    kinds = {e.get("kind") for e in events}
    assert {"router_dead", "router_respawned", "serve_request_requeued",
            "fault_injected"} <= kinds
    assert "obs.report --check: 0 confirmed" in r.stderr
    # the state stayed in the campaign's dirs
    assert (tmp_path / "fleet" / "state").is_dir()
    for argv in (["--events", "0"], ["--workers", "1"], ["--seed", "x"],
                 ["--bogus"]):
        assert _campaign(tmp_path, argv, env, 60).returncode == 2


@pytest.mark.slow
def test_chaos_campaign_seeded(tmp_path):
    """The reference's own case (``tests/test_router_health.py``):
    seed 1, three events, the campaign's own knobs."""
    env, jp = _campaign_env(tmp_path)
    r = _campaign(tmp_path, ["--seed", "1", "--events", "3"], env,
                  timeout=570)
    _campaign_checks(r, jp, 3)


def test_campaign_check_reads_its_own_journal(tmp_path, monkeypatch):
    """The campaign's closing ``obs.report --check`` gets the campaign's
    journal by ``--journal`` (the reference's runs with none and reads
    the newest ``docs/logs/`` file), and a member killed again waits out
    the supervisors' stable window first."""
    import subprocess

    from tpukernels_torch.serve import chaos, health

    seen = []
    monkeypatch.setenv("TPKT_HEALTH_JOURNAL", str(tmp_path / "c.jsonl"))
    monkeypatch.setattr(chaos.subprocess, "run", lambda argv, **kw: (
        seen.append(argv) or subprocess.CompletedProcess(argv, 0, "", "")))
    chaos._report_check()
    assert seen[0][-4:] == ["tpukernels_torch.obs.report", "--check",
                            "--journal", str(tmp_path / "c.jsonl")]
    monkeypatch.setenv("TPKT_FLEET_PROBE_S", "0.01")
    assert chaos.stable_window_s() == pytest.approx(
        (health.STABLE_PROBES + 2) * 0.01)
    assert chaos._let_settle("router", {}) == 0.0
    t0 = time.monotonic()
    waited = chaos._let_settle("router", {("up_at", "router"): t0})
    assert 0.0 < waited <= chaos.stable_window_s()
    assert time.monotonic() - t0 >= chaos.stable_window_s() - 0.01
    assert chaos._let_settle(1, {("up_at", 1): t0 - 60}) == 0.0
