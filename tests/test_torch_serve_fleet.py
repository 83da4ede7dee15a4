"""The port's serving fleet against the reference, on the CPU.

``python -m tpukernels_torch.serve.ctl start-fleet N`` starts N of the
port's daemons with ``TPKT_SERVE_DEVICE=cpu`` (the wrappers' plain
versions) and the port's router over them, each with the small avatar
table of ``tests/test_torch_serve_protocol.py`` and every state path in
a temporary directory. Here:

- parity units: the md5 ring of every avatar bucket for n = 1..8, the
  fleet's layout on disk, the tenant token buckets' admit/throttle
  decisions and retry hints on a seeded arrival sequence (the clock
  patched under both routers), and the knob parsers' fail-loud
  messages, each equal to the reference's;
- end to end: the reference's ``ServeClient`` sends each of the nine
  registry keys through the front socket on both lanes and gets the
  reference's ``registry.dispatch`` answer (bitwise for the stencils
  and the int32 keys, within ``tests/test_torch_serve.py``'s bands for
  the float keys); every bucket lands on ``ring_order(bucket, 2)[0]``
  (the journal's ``serve_route`` events); ``tools/loadgen.py --serve``
  drives the fleet with rc 0; ``ctl status`` shows both workers;
- chaos: a drain of the scan bucket's home in the middle of a burst
  drops no request, and undrain restores it.

The fleet helpers here are shared by ``test_torch_serve_fleet_health.py``
and ``test_torch_serve_router_health.py``. Every wait has its own
deadline.
"""

import contextlib
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from test_torch_serve import (  # noqa: F401  (a fixture)
    CASES,
    TOL,
    WIRE_DTYPES,
    _env,
    reference_results,
)
from tpukernels.serve import client as ref_client
from tpukernels.serve import fleet as ref_fleet
from tpukernels.serve import health as ref_health
from tpukernels.serve import router as ref_router
from tpukernels.serve import server as ref_server
from tpukernels_torch import aot
from tpukernels_torch.resilience import journal
from tpukernels_torch.serve import bucketing, fleet, health, proc, router

ROOT = Path(__file__).resolve().parent.parent

# the scan bucket of the small avatar table: its ring home is the
# routing oracle of the chaos drives
SCAN_BUCKET = "scan|4096|-"

# compressed health windows (the default probe is 5 s)
FAST_HEALTH = {"TPKT_FLEET_PROBE_S": "0.3",
               "TPKT_FLEET_RESTART_BACKOFF_S": "0.2"}


def _ctl(env, *args, timeout=150):
    return subprocess.run(
        [sys.executable, "-m", "tpukernels_torch.serve.ctl", *args],
        capture_output=True, text=True, timeout=timeout, cwd=ROOT, env=env)


def _events(path, kind=None):
    recs, _ = journal.load_events([path])
    return [r for r in recs if kind is None or r.get("kind") == kind]


def _wait_events(path, pred, timeout=60.0, msg="event"):
    """The journal's events once one matches ``pred``, and the matches;
    fails after ``timeout`` seconds."""
    deadline = time.monotonic() + timeout
    while True:
        events = _events(path)
        hits = [e for e in events if pred(e)]
        if hits:
            return events, hits
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out after {timeout} s waiting for "
                                 f"{msg}")
        time.sleep(0.2)


@contextlib.contextmanager
def _fleet(base, n=2, tag="f", **env_extra):
    """``ctl start-fleet n`` in ``base/tag``; yields (front socket,
    journal, env) and stops the fleet on exit."""
    d = base / tag
    d.mkdir()
    env = _env(d, **env_extra)
    r = _ctl(env, "start-fleet", str(n), "--wait", "90")
    assert r.returncode == 0, r.stdout + r.stderr
    try:
        yield str(d / "fleet" / "front.sock"), d / "journal.jsonl", env
    finally:
        r = _ctl(env, "stop-fleet", "--wait", "30")
        assert r.returncode == 0, r.stdout + r.stderr


def _scan_case(n=3000):
    x = (np.arange(n) % 17).astype(np.int32)
    return x, np.cumsum(x, dtype=np.int64).astype(np.int32)


# ------------------------------------------------------------ parity units

def _avatar_buckets():
    """The bucket id of every avatar of ``aot.BENCH_CONFIGS``."""
    out = []
    for key, spec in aot.BENCH_CONFIGS.items():
        arrays = [np.zeros(shape, bucketing._DTYPE_NAMES[kind])
                  for kind, shape in spec["args"]]
        statics = dict(spec["statics"])
        bspec, _ = bucketing.bucket_for(key, arrays, statics)
        out.append(bucketing.bucket_id(key, bspec, statics, arrays))
    return out


def test_ring_order_is_the_references(monkeypatch):
    monkeypatch.delenv("TPKT_SERVE_BUCKETS", raising=False)
    buckets = _avatar_buckets()
    assert len(buckets) == 9 and "scan|4194304|-" in buckets
    for b in buckets + [SCAN_BUCKET]:
        for n in range(1, 9):
            got = router.ring_order(b, n)
            assert got == ref_router.ring_order(b, n), (b, n)
            assert sorted(got) == list(range(n))


def test_fleet_layout_is_the_references(tmp_path):
    env = {"TPKT_SERVE_DIR": str(tmp_path), "TPK_SERVE_DIR": str(tmp_path)}
    moved = {"TPKT_SERVE_FLEET_DIR": str(tmp_path / "elsewhere"),
             "TPK_SERVE_FLEET_DIR": str(tmp_path / "elsewhere"), **env}
    for e in (env, moved):
        for name in ("fleet_dir", "config_path", "front_socket_path",
                     "router_pidfile_path", "guardian_pidfile_path",
                     "wal_path"):
            assert getattr(fleet, name)(e) == getattr(ref_fleet, name)(e)
        for i in range(3):
            assert fleet.worker_dir(i, e) == ref_fleet.worker_dir(i, e)
            assert (fleet.worker_socket_path(i, e)
                    == ref_fleet.worker_socket_path(i, e))
            sock = fleet.worker_socket_path(i, e)
            assert (health.worker_pidfile(sock)
                    == ref_health.worker_pidfile(sock))
    assert fleet.front_socket_path(env) == str(tmp_path / "fleet" /
                                               "front.sock")


def test_child_env_scrubs_the_client_switch(monkeypatch, tmp_path):
    monkeypatch.setenv("TPKT_SERVE_SOCKET", "/elsewhere.sock")
    monkeypatch.setenv("TPKT_SERVE_DEVICE", "cpu")
    monkeypatch.setenv("TPKT_SERVE_DIR", str(tmp_path))
    monkeypatch.delenv("TPKT_HEALTH_JOURNAL", raising=False)
    env = fleet._child_env({"TPKT_SERVE_WORKER_ID": "1"})
    assert "TPKT_SERVE_SOCKET" not in env
    assert env["TPKT_SERVE_DEVICE"] == "cpu"
    assert env["TPKT_SERVE_WORKER_ID"] == "1"
    # one journal for the whole fleet: the caller's serve directory
    assert env["TPKT_HEALTH_JOURNAL"] == str(tmp_path)
    monkeypatch.setenv("TPKT_HEALTH_JOURNAL", "/j.jsonl")
    assert fleet._child_env()["TPKT_HEALTH_JOURNAL"] == "/j.jsonl"


def _arrivals(seed, n=300):
    rng = np.random.default_rng(seed)
    return list(zip(rng.exponential(0.15, n),
                    rng.choice(["acme", "beta", "gamma"], n),
                    rng.choice(["interactive", "batch"], n, p=[0.4, 0.6])))


@pytest.mark.parametrize("rate,burst", [(2.0, 4.0), (0.5, 8.0), (5.0, 1.0),
                                        (0.0, 8.0)])
def test_tenant_decisions_are_the_references(monkeypatch, tmp_path, rate,
                                             burst):
    for var in [k for k in os.environ
                if k.startswith(("TPK_ROUTE", "TPKT_ROUTE",
                                 "TPK_SERVE_BUCKETS", "TPKT_SERVE_BUCKETS"))]:
        monkeypatch.delenv(var)
    socks = [str(tmp_path / f"w{i}.sock") for i in range(2)]
    mine = router.Router(str(tmp_path / "a.sock"), socks, tenant_rate=rate,
                         tenant_burst=burst)
    ref = ref_router.Router(str(tmp_path / "b.sock"), socks,
                            tenant_rate=rate, tenant_burst=burst)
    clock = [1000.0]
    monkeypatch.setattr(router.time, "perf_counter", lambda: clock[0])
    got, want = [], []
    for dt, tenant, prio in _arrivals(int(rate * 10 + burst)):
        clock[0] += float(dt)
        got.append(mine._admit_tenant(str(tenant), str(prio)))
        want.append(ref._admit_tenant(str(tenant), str(prio)))
    assert got == want
    admitted = sum(a for a, _ in got)
    if rate > 0:
        assert 0 < admitted < len(got)
        assert all(0.05 <= r <= router.MAX_RETRY_HINT_S
                   for a, r in got if not a)
    else:
        assert admitted == len(got)


def _err(fn, *args, **kw):
    with pytest.raises(ValueError) as e:
        fn(*args, **kw)
    return str(e.value)


@pytest.mark.parametrize("raw", ["abc", "-1", "0"])
def test_knob_parsers_fail_as_loudly_as_the_references(monkeypatch, raw,
                                                       tmp_path):
    def both(name, port_fn, ref_fn, *a, **kw):
        monkeypatch.setenv(f"TPKT_{name}", raw)
        monkeypatch.setenv(f"TPK_{name}", raw)
        mine = _err(port_fn, f"TPKT_{name}", *a, **kw)
        assert mine == _err(ref_fn, f"TPK_{name}", *a, **kw).replace(
            "TPK_", "TPKT_")
        return mine

    both("X", proc.int_knob, ref_server._int_knob, 3, floor=1)
    both("X", proc.int_knob, ref_health._int_env, 3, floor=1)
    if raw != "0":
        both("X", proc.float_knob, ref_server._float_knob, 2.0)
        assert "expected a number >= 0.0" in both(
            "X", proc.float_knob, ref_health._float_env, 2.0)
    # the components that read them refuse to start the same way
    socks = [str(tmp_path / "w.sock")]
    if raw != "0":
        monkeypatch.setenv("TPKT_ROUTE_HEDGE_PCTL", raw)
        monkeypatch.setenv("TPK_ROUTE_HEDGE_PCTL", raw)
        assert _err(router.Router, "a", socks) == _err(
            ref_router.Router, "a", socks).replace("TPK_", "TPKT_")
    monkeypatch.setenv("TPKT_FLEET_RESTART_MAX", raw)
    monkeypatch.setenv("TPK_FLEET_RESTART_MAX", raw)
    assert _err(health.HealthManager, socks, str(ROOT)) == _err(
        ref_health.HealthManager, socks, str(ROOT)).replace("TPK_", "TPKT_")


def test_router_needs_a_worker(tmp_path):
    assert _err(router.Router, str(tmp_path / "a"), []) == _err(
        ref_router.Router, str(tmp_path / "a"), [])


# -------------------------------------------------------------- end to end

@pytest.fixture(scope="module")
def fleet2(tmp_path_factory):
    with _fleet(tmp_path_factory.mktemp("fleet"), n=2) as f:
        yield f


def _ref_lane(monkeypatch, lane):
    if lane == "shm":
        monkeypatch.delenv("TPK_SERVE_SHM", raising=False)
        monkeypatch.setenv("TPK_SERVE_SHM_MIN_BYTES", "1")
    else:
        monkeypatch.setenv("TPK_SERVE_SHM", "0")


@pytest.mark.parametrize("lane", ["inline", "shm"])
@pytest.mark.parametrize("key", sorted(CASES))
def test_reference_client_gets_the_reference_answer(fleet2,
                                                    reference_results,
                                                    monkeypatch, key, lane):
    front, _, _ = fleet2
    _ref_lane(monkeypatch, lane)
    make, statics = CASES[key]
    args = make(np.random.default_rng(7))
    with ref_client.ServeClient(front, timeout_s=120) as c:
        c.next_request_id = f"nine-{key}-{lane}"
        got = c.dispatch(key, *args, **statics)
        assert c.staged_payloads == (len(args) if lane == "shm" else 0)
    got = got if isinstance(got, tuple) else (got,)
    want = reference_results[key]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype.name in WIRE_DTYPES and g.dtype == w.dtype
        assert g.shape == w.shape
        if TOL[key] is None:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=TOL[key][0],
                                       atol=TOL[key][1])


def test_each_bucket_lands_on_its_ring_home(fleet2):
    front, jpath, _ = fleet2
    x, want = _scan_case()
    with ref_client.ServeClient(front, timeout_s=120) as c:
        for i, (key, (make, statics)) in enumerate(sorted(CASES.items())):
            c.next_request_id = f"home-{key}"
            c.dispatch(key, *make(np.random.default_rng(i)), **statics)
        c.next_request_id = "home-scan-again"
        np.testing.assert_array_equal(c.dispatch("scan", x), want)
    routes = {e["request_id"]: e for e in _events(jpath, "serve_route")
              if str(e.get("request_id")).startswith("home-")}
    assert len(routes) == len(CASES) + 1
    served = {e["request_id"]: e for e in _events(jpath, "serve_request")
              if str(e.get("request_id")).startswith("home-")}
    homes = {}
    for rid, e in routes.items():
        assert e["ok"] and e["spilled_from"] is None, e
        assert e["worker"] == router.ring_order(e["bucket"], 2)[0], e
        # the worker that served it says the same
        assert served[rid]["worker_id"] == str(e["worker"])
        assert served[rid]["bucket"] == e["bucket"]
        homes[e["bucket"]] = e["worker"]
    assert homes[SCAN_BUCKET] == routes["home-scan-again"]["worker"]
    assert set(homes.values()) == {0, 1}  # the table spreads over both


def test_loadgen_drives_the_fleet(fleet2, tmp_path):
    front, jpath, _ = fleet2
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPKT_", "TPK_"))}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT),
               TPK_HEALTH_JOURNAL=str(tmp_path / "lg.jsonl"),
               TPK_SLO_DIR=str(tmp_path / "slo"))
    before = len(_events(jpath, "serve_route"))
    r = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "loadgen.py"), "--serve",
         front, "--mix", "scan=1,vector_add=1", "--seed", "7",
         "--requests", "30", "--tenant", "acme"], capture_output=True,
        text=True, timeout=300, cwd=ROOT, env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "DROPPED" not in r.stdout and "(served)" in r.stdout
    routes = _events(jpath, "serve_route")[before:]
    assert len(routes) == 32 and all(e["ok"] for e in routes)  # + 2 warms
    assert {e["tenant"] for e in routes} == {"acme"}


def test_ctl_status_shows_both_workers(fleet2):
    _, _, env = fleet2
    r = _ctl(env, "status")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "fleet UP - router pid" in r.stdout
    for i in range(2):
        line = next(ln for ln in r.stdout.splitlines()
                    if ln.strip().startswith(f"worker{i}:"))
        assert line.split()[1] == "up" and "served=" in line, line
    r = _ctl(env, "health", "--wait", "5")
    assert r.returncode == 0 and "CONVERGED" in r.stdout, r.stdout
    # a second start is refused while the router lives
    r = _ctl(env, "start-fleet", "2", "--wait", "5")
    assert r.returncode == 3, r.stdout + r.stderr


# ------------------------------------------------------------------ chaos

def test_drain_mid_burst_zero_drops_then_undrain(tmp_path):
    """Drain the scan bucket's home in the middle of a three-thread
    burst: its buckets fail over to the sibling, the worker stops, no
    accepted request drops; undrain restarts it and restores the ring."""
    home = router.ring_order(SCAN_BUCKET, 2)[0]
    with _fleet(tmp_path, n=2, TPKT_SERVE_BATCH_WINDOW_MS="0") as (
            front, jpath, env):
        x, want = _scan_case()
        errors, done = [], []
        stop = threading.Event()

        def stream():
            try:
                with ref_client.ServeClient(front, timeout_s=120) as c:
                    while not stop.is_set():
                        np.testing.assert_array_equal(c.dispatch("scan", x),
                                                      want)
                        done.append(1)
            except Exception as e:  # noqa: BLE001 - collected, asserted
                errors.append(repr(e))

        def wait_more(k, what):
            mark = len(done)
            deadline = time.monotonic() + 60
            while len(done) < mark + k:
                assert not errors, errors
                assert time.monotonic() < deadline, f"stalled {what}"
                time.sleep(0.05)

        threads = [threading.Thread(target=stream) for _ in range(3)]
        for t in threads:
            t.start()
        try:
            wait_more(5, "before the drain")
            r = _ctl(env, "drain", str(home), "--wait", "30")
            assert r.returncode == 0, r.stdout + r.stderr
            wait_more(5, "after the drain")
            r = _ctl(env, "undrain", str(home), "--wait", "90")
            assert r.returncode == 0, r.stdout + r.stderr
            wait_more(5, "after the undrain")
        finally:
            stop.set()
            for t in threads:
                t.join(60)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors
        # the restored home takes its bucket again
        with ref_client.ServeClient(front, timeout_s=120) as c:
            c.next_request_id = "after-undrain"
            np.testing.assert_array_equal(c.dispatch("scan", x), want)
    events = _events(jpath)
    drains = [e for e in events if e["kind"] == "serve_drain"]
    assert [e["phase"] for e in drains] == ["begin", "undrain"]
    assert all(e["worker"] == home for e in drains)
    routes = [e for e in events if e["kind"] == "serve_route"]
    assert routes and all(e["ok"] for e in routes)
    t0, t1 = drains[0]["t"], drains[1]["t"]
    # a forward that started just before the drain op may journal its
    # serve_route just after it
    window = [e for e in routes if t0 + 1.0 < e["t"] < t1]
    assert window and all(e["worker"] != home for e in window)
    (last,) = [e for e in routes if e.get("request_id") == "after-undrain"]
    assert last["worker"] == home
