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
import threading
import time

import numpy as np
import pytest

from test_torch_serve import _daemon
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
