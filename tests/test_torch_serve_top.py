"""``python -m tpukernels_torch.serve.ctl top`` (``serve/top.py``) against a
live two-worker fleet on the CPU and against the reference's
``tools/fleet_top.py``.

The fleet is the rig of ``tests/test_torch_serve_fleet.py`` (the port's
daemons with ``TPKT_SERVE_DEVICE=cpu`` and the small avatar table, every
state path in a temporary directory). ``ctl top --once`` prints one row a
worker with the requests each served; against no fleet it exits 1. A
frame rendered from the same ``stats`` reply is the reference's frame,
character for character, and the rate is a delta between frames, so an
idle fleet shows 0.0.
"""

import importlib.util
import io
import os

import numpy as np

from test_torch_serve_fleet import _ctl, _fleet, _scan_case
from tpukernels_torch.serve import client as serve_client
from tpukernels_torch.serve import top

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference_top():
    spec = importlib.util.spec_from_file_location(
        "ref_fleet_top", os.path.join(ROOT, "tools", "fleet_top.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rows(text):
    return {line.split()[0]: line.split() for line in text.splitlines()
            if line.split() and line.split()[0].startswith("worker")}


def test_top_once_against_a_live_fleet(tmp_path):
    with _fleet(tmp_path, n=2) as (front, _journal, env):
        x, want = _scan_case()
        with serve_client.ServeClient(front, timeout_s=60) as c:
            for _ in range(3):
                # scan's bucket is homed on worker 1, the exclusive
                # scan's on worker 0 (router.ring_order)
                np.testing.assert_array_equal(c.dispatch("scan", x), want)
                c.dispatch("scan_exclusive", x)
            reply = c.stats()
        r = _ctl(env, "top", "--once")
        assert r.returncode == 0, r.stdout + r.stderr
        assert "workers=2/2" in r.stdout
        rows = _rows(r.stdout)
        assert set(rows) == {"worker0", "worker1"}, r.stdout
        for name, parts in rows.items():
            assert parts[1] == "up"
            assert int(parts[7]) >= 3, (name, parts)   # served
            assert float(parts[3]) > 0 and float(parts[4]) > 0  # p50, p99
            assert "/" in parts[5]                     # depth/queue_max
        # the same reply renders the reference's frame
        got, want_out = io.StringIO(), io.StringIO()
        served = top.render(reply, out=got)
        ref_served = _reference_top().render(reply, out=want_out)
        assert got.getvalue() == want_out.getvalue()
        assert served == ref_served
        # rates are deltas: no request between two frames is 0.0
        idle = io.StringIO()
        top.render(reply, prev=served, dt=2.0, out=idle)
        assert all(parts[2] == "0.0" for parts in _rows(idle.getvalue())
                   .values()), idle.getvalue()
        busy = io.StringIO()
        top.render(reply, prev={k: v - 4 for k, v in served.items()},
                   dt=2.0, out=busy)
        assert all(parts[2] == "2.0" for parts in _rows(busy.getvalue())
                   .values()), busy.getvalue()
        # a lone worker's socket: one daemon row
        r = _ctl(env, "top", "--once", "--socket",
                 str(tmp_path / "f" / "fleet" / "worker0" / "serve.sock"))
        assert r.returncode == 0, r.stdout + r.stderr
        assert r.stdout.startswith("daemon: pid ")


def test_top_against_no_fleet_is_rc1(tmp_path):
    from test_torch_serve import _env

    env = _env(tmp_path)
    r = _ctl(env, "top", "--once")
    assert r.returncode == 1, r.stdout + r.stderr
    assert "no stats answer" in r.stderr
    for argv in (["top", "--interval"], ["top", "--interval", "x"],
                 ["top", "--bogus"], ["status", "--once"]):
        assert _ctl(env, *argv).returncode == 2, argv


def test_a_down_worker_renders_a_dash_row():
    reply = {"ok": True, "role": "router", "routed": 4, "spilled": 1,
             "throttled": 0, "rejected": 0, "level": "degraded",
             "n_workers": 2, "uptime_s": 3.0, "fleet": {"answering": 1},
             "workers": [{"state": "live"}, {"draining": True}],
             "worker_stats": [None, {"served": 6, "uptime_s": 3.0,
                                     "depth": 0, "queue_max": 64,
                                     "inflight": 0, "bytes_copied": 0,
                                     "metrics": {}}]}
    got, want = io.StringIO(), io.StringIO()
    top.render(reply, out=got)
    _reference_top().render(reply, out=want)
    assert got.getvalue() == want.getvalue()
    rows = _rows(got.getvalue())
    assert rows["worker0"][1:3] == ["DOWN", "-"]
    assert rows["worker1"][1:3] == ["draining", "2.0"]
