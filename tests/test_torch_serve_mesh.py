"""The port's serve mesh tier against the reference's, on the CPU.

An over-avatar request of a ``MESH_KERNELS`` key runs on the kernel's
distributed twin: in the reference inside one process over its (fake)
devices, in the port over a standing group of follower ranks the daemon
keeps beside it (``tpukernels_torch/serve/mesh_tier.py``,
``TPKT_SERVE_MESH``). Here:

- admission: the reference's cases (``tests/test_serve.py``'s
  ``test_mesh_tier_admission_rules``) through both packages, the
  reference under ``--xla_force_host_platform_device_count``, the port
  under ``TPKT_SERVE_MESH`` in a process that must load no torch; the
  answers equal case by case;
- one daemon at 4 ranks, the counterpart of the reference's
  ``test_serve_mesh_tier_end_to_end``: a scan 8x its avatar exact
  against ``np.cumsum``, a 2-D stencil over its avatar bitwise the
  port's in-process ``registry.dispatch`` (which
  ``tests/test_torch_dispatch_mesh.py`` holds against the reference),
  a histogram exact against ``np.bincount``, N-body within the band
  that file holds the mesh twin to (rtol 5e-4 / atol 5e-5), the
  journal's ``mesh_shape``, bucket, ``bucketed`` and ``dispatch`` span,
  an in-avatar request still bucketed, the ``stats`` op's tier, and two
  clients' mesh requests of different buckets at once;
- the fleet route with 2 workers of 2 ranks each, the counterpart of
  ``tests/test_fleet.py``'s ``test_fleet_mesh_tier_oversized_request``,
  with one ``aot_miss`` for the mesh bucket across the fleet;
- recovery: a follower SIGKILLed while a mesh request is in flight
  gives exactly that request an error reply, an in-avatar request is
  answered meanwhile, the rebuild is journaled and the next mesh
  request is right; a mesh request past its grace is broken, answered
  with an error and never requeued;
- lifetime: no follower is left after a clean stop or after the daemon
  is SIGKILLed, and a daemon whose group cannot form exits non-zero
  before it listens.

Every state path lies in a temporary directory.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest

from test_torch_serve import ROOT, _daemon, _env
from test_torch_serve_fleet import _ctl, _events
from tpukernels_torch.serve import client

# ------------------------------------------------------------- admission

# (case, kernel, arrays as (dtype, shape) lists, devices / ranks): the
# reference test's cases, its env-less host as n = 0 (no count declared)
ADMISSION = (
    ("scan_divides", "scan", [("int32", (1 << 15,))], 4),
    ("sgemm_no_twin", "sgemm", [("float32", (512, 512))] * 2, 4),
    ("scan_ragged", "scan", [("int32", ((1 << 15) + 1,))], 4),
    ("nbody_seven", "nbody", [("float32", (64,))] * 7, 4),
    ("nbody_six", "nbody", [("float32", (64,))] * 6, 4),
    ("scan_no_count", "scan", [("int32", (1 << 15,))], 0),
    ("scan_one", "scan", [("int32", (1 << 15,))], 1),
)

PORT_ADMISSION = """
import json, os, sys
import numpy as np
from tpukernels_torch.serve import bucketing

out = {}
for case, kernel, args, n in json.loads(sys.argv[1]):
    if n:
        os.environ["TPKT_SERVE_MESH"] = str(n)
    else:
        os.environ.pop("TPKT_SERVE_MESH", None)
    arrays = [np.zeros(shape, dtype) for dtype, shape in args]
    got = bucketing.mesh_tier_for(kernel, arrays, {})
    out[case] = list(got) if got is not None else None
print(json.dumps({"answers": out, "torch": "torch" in sys.modules}))
"""


@pytest.fixture(scope="module")
def port_admission():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPKT_", "TPK_"))}
    env["PYTHONPATH"] = str(ROOT)
    r = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(PORT_ADMISSION),
         json.dumps(ADMISSION)], capture_output=True, text=True, cwd=ROOT,
        env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    return json.loads(r.stdout)


@pytest.mark.parametrize("case", [c[0] for c in ADMISSION])
def test_admission_equals_the_references(case, port_admission, monkeypatch):
    from tpukernels.serve import bucketing as ref_bucketing

    (_, kernel, args, n), = [c for c in ADMISSION if c[0] == case]
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.setenv(
        "XLA_FLAGS",
        f"--xla_force_host_platform_device_count={n}" if n else "")
    ref = ref_bucketing.mesh_tier_for(
        kernel, [np.zeros(shape, dtype) for dtype, shape in args], {})
    got = port_admission["answers"][case]
    assert got == (list(ref) if ref is not None else None), (case, ref, got)
    # the router imports the admission: it must not load torch
    assert port_admission["torch"] is False


def test_a_bad_tier_knob_is_refused(monkeypatch):
    from tpukernels_torch.serve import bucketing

    for raw in ("0", "two", "-3"):
        monkeypatch.setenv("TPKT_SERVE_MESH", raw)
        with pytest.raises(ValueError, match="TPKT_SERVE_MESH"):
            bucketing.mesh_tier_for("scan", [np.zeros(64, np.int32)], {})
    monkeypatch.setenv("TPKT_SERVE_MESH", "1")
    assert bucketing.mesh_tier_for(
        "scan", [np.zeros(1 << 15, np.int32)], {}) is None


# ----------------------------------------------- the daemon at four ranks

TIER = {"TPKT_SERVE_MESH": "4", "TPKT_SERVE_BATCH_WINDOW_MS": "0",
        "TPKT_COORDINATOR_TIMEOUT_S": "120"}


def _tier_env(d):
    return dict(TIER, TPKT_AOT_DIR=str(d / "aot"))


@pytest.fixture(scope="module")
def tier(tmp_path_factory):
    base = tmp_path_factory.mktemp("tier")
    with _daemon(base, **_tier_env(base)) as d:
        yield d


def _scan(n, mod=29):
    x = (np.arange(n) % mod).astype(np.int32)
    return x, np.cumsum(x, dtype=np.int64).astype(np.int32)


def _served(d, request_id):
    (ev,) = [e for e in d.events("serve_request")
             if e.get("request_id") == request_id]
    return ev


def _in_process(monkeypatch, key, args, statics):
    """The port's single-device ``registry.dispatch`` in this process,
    its state layers off."""
    import torch

    from tpukernels_torch import registry

    monkeypatch.setenv("TPKT_AOT_CACHE", "0")
    monkeypatch.setenv("TPKT_INTEGRITY", "0")
    monkeypatch.setenv("TPKT_HEALTH_JOURNAL", "off")
    out = registry.dispatch(key, *(torch.from_numpy(a) for a in args),
                            **statics)
    out = out if isinstance(out, tuple) else (out,)
    return tuple(o.numpy() for o in out)


def test_tier_start_and_stats(tier):
    with client.ServeClient(tier.sock, timeout_s=60) as c:
        st = c.stats()
    mt = st["mesh_tier"]
    assert mt["ranks"] == 4 and mt["backend"] == "gloo", mt
    assert mt["device"] == "cpu" and mt["generation"] >= 1 and mt["up"], mt
    assert len(mt["followers"]) == 3
    for pid in mt["followers"]:
        assert os.path.exists(f"/proc/{pid}"), pid
    (start,) = tier.events("serve_start")
    assert start["mesh"]["ranks"] == 4 and start["mesh"]["backend"] == "gloo"
    assert tier.events("serve_mesh_up")[0]["reason"] == "start"


def test_scan_over_its_avatar_runs_on_the_tier(tier):
    x, want = _scan(32768)
    small, want_small = _scan(4096)
    with client.ServeClient(tier.sock, timeout_s=120) as c:
        c.next_request_id = "mesh-scan"
        np.testing.assert_array_equal(c.dispatch("scan", x), want)
        c.next_request_id = "mesh-scan-small"
        np.testing.assert_array_equal(c.dispatch("scan", small), want_small)
    big, sml = _served(tier, "mesh-scan"), _served(tier, "mesh-scan-small")
    assert big["mesh_shape"] == [4], big
    assert big["bucket"] == "scan|32768|-|mesh4", big["bucket"]
    assert big["ok"] and not big["bucketed"], big
    assert big["mesh_bytes"]["broadcast"] == x.nbytes, big
    assert sml["mesh_shape"] is None and sml["bucketed"], sml
    assert sml["mesh_bytes"] is None
    spans = [e for e in tier.events("span")
             if e.get("request_id") == "mesh-scan"]
    disp = [e for e in spans if e["name"] == "serve/scan/dispatch/scan"]
    assert [e.get("mesh") for e in disp] == ["4"], spans
    assert any(e["name"] == "serve/scan/mesh/broadcast" for e in spans)
    assert any(e["name"] == "serve/scan/mesh/wait" for e in spans)


def test_stencil2d_over_its_avatar_is_bitwise_the_in_process_dispatch(
        tier, monkeypatch):
    g = np.random.default_rng(3).standard_normal((160, 72)).astype(
        np.float32)
    with client.ServeClient(tier.sock, timeout_s=120) as c:
        c.next_request_id = "mesh-stencil2d"
        got = c.dispatch("stencil2d", g, iters=3)
    (want,) = _in_process(monkeypatch, "stencil2d", [g], {"iters": 3})
    assert got.dtype == want.dtype and np.array_equal(got, want)
    ev = _served(tier, "mesh-stencil2d")
    assert ev["mesh_shape"] == [4] and ev["bucket"].endswith("|mesh4"), ev


def test_histogram_and_nbody_over_their_avatars(tier, monkeypatch):
    rng = np.random.default_rng(5)
    v = rng.integers(0, 64, 8192).astype(np.int32)
    bodies = [rng.uniform(-1, 1, 512).astype(np.float32) for _ in range(6)]
    bodies.append(rng.uniform(0.5, 1.5, 512).astype(np.float32))
    statics = {"dt": 1e-3, "eps": 1e-2, "steps": 1}
    with client.ServeClient(tier.sock, timeout_s=120) as c:
        c.next_request_id = "mesh-histogram"
        counts = c.dispatch("histogram", v, nbins=64)
        c.next_request_id = "mesh-nbody"
        got = c.dispatch("nbody", *bodies, **statics)
    np.testing.assert_array_equal(counts, np.bincount(v, minlength=64))
    want = _in_process(monkeypatch, "nbody", bodies, statics)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=5e-4, atol=5e-5)
    for rid in ("mesh-histogram", "mesh-nbody"):
        ev = _served(tier, rid)
        assert ev["mesh_shape"] == [4] and not ev["bucketed"], ev


def test_two_clients_mesh_buckets_at_once(tier):
    x, want = _scan(65536, 31)
    v = (np.arange(16384) % 64).astype(np.int32)
    errors = []

    def drive(key, arg, check):
        try:
            with client.ServeClient(tier.sock, timeout_s=120) as c:
                for _ in range(4):
                    kw = {"nbins": 64} if key == "histogram" else {}
                    check(c.dispatch(key, arg, **kw))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))

    threads = [
        threading.Thread(target=drive, args=(
            "scan", x, lambda o: np.testing.assert_array_equal(o, want))),
        threading.Thread(target=drive, args=(
            "histogram", v, lambda o: np.testing.assert_array_equal(
                o, np.bincount(v, minlength=64)))),
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    assert not errors and not any(t.is_alive() for t in threads), errors


# ------------------------------------------------------------- the fleet

def test_fleet_routes_an_oversized_request_to_a_worker_tier(tmp_path):
    """Client -> router -> worker -> its tier of 2 ranks -> traced
    response, twice; one compile of the mesh bucket across the fleet."""
    d = tmp_path / "f"
    d.mkdir()
    env = _env(d, TPKT_SERVE_MESH="2", TPKT_SERVE_BATCH_WINDOW_MS="0",
               TPKT_AOT_DIR=str(d / "aot"), TPKT_COORDINATOR_TIMEOUT_S="120")
    r = _ctl(env, "start-fleet", "2", "--wait", "120")
    assert r.returncode == 0, r.stdout + r.stderr
    try:
        x, want = _scan(32768, 31)
        with client.ServeClient(str(d / "fleet" / "front.sock"),
                                timeout_s=180) as c:
            np.testing.assert_array_equal(c.dispatch("scan", x), want)
            np.testing.assert_array_equal(c.dispatch("scan", x), want)
    finally:
        r = _ctl(env, "stop-fleet", "--wait", "60")
        assert r.returncode == 0, r.stdout + r.stderr
    events = _events(d / "journal.jsonl")
    served = [e for e in events if e.get("kind") == "serve_request"
              and e.get("kernel") == "scan"]
    assert len(served) == 2, served
    for e in served:
        assert e["ok"] and e["mesh_shape"] == [2], e
        assert e["bucket"] == "scan|32768|-|mesh2" and not e["bucketed"], e
    spans = [e for e in events if e.get("kind") == "span"
             and e.get("name", "").endswith("dispatch/scan")]
    assert any(e.get("mesh") == "2" for e in spans), spans
    misses = [e for e in events if e.get("kind") == "aot_miss"
              and e["key"].startswith("scan@mesh2|32768|")]
    assert len(misses) == 1, misses
    # each worker formed its own tier; the fleet left no follower
    ups = [e for e in events if e.get("kind") == "serve_mesh_up"]
    assert len({e["pid"] for e in ups}) == 2, ups
    _gone([p for e in ups for p in e["followers"]])


# -------------------------------------------------------------- recovery

def _alive(pid) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def _gone(pids, timeout=15.0):
    deadline = time.monotonic() + timeout
    while any(_alive(p) for p in pids):
        assert time.monotonic() < deadline, [p for p in pids if _alive(p)]
        time.sleep(0.1)


def test_a_follower_killed_in_flight_fails_one_request(tmp_path):
    plan = {"slow_dispatch": {"kernel": "histogram", "delay_s": 2.0}}
    with _daemon(tmp_path, TPKT_FAULT_PLAN=json.dumps(plan),
                 **_tier_env(tmp_path)) as d:
        with client.ServeClient(d.sock, timeout_s=60) as c:
            first = c.stats()["mesh_tier"]
        v = (np.arange(8192) % 64).astype(np.int32)
        res = {}

        def big():
            with client.ServeClient(d.sock, timeout_s=120) as c:
                c.next_request_id = "mesh-doomed"
                try:
                    res["out"] = c.dispatch("histogram", v, nbins=64)
                except client.ServeError as e:
                    res["error"] = str(e)

        t = threading.Thread(target=big)
        t.start()
        # the order is out once rank 0 sleeps in its fault point
        deadline = time.monotonic() + 60
        while not d.events("fault_injected"):
            assert time.monotonic() < deadline
            time.sleep(0.05)
        os.kill(first["followers"][1], signal.SIGKILL)
        small, want_small = _scan(4096)
        with client.ServeClient(d.sock, timeout_s=60) as c:
            c.next_request_id = "in-avatar-meanwhile"
            np.testing.assert_array_equal(c.dispatch("scan", small),
                                          want_small)
        t.join(120)
        assert "error" in res and "mesh tier" in res["error"], res
        x, want = _scan(32768)
        with client.ServeClient(d.sock, timeout_s=120) as c:
            c.next_request_id = "mesh-after"
            np.testing.assert_array_equal(c.dispatch("scan", x), want)
            now = c.stats()["mesh_tier"]
        _gone(first["followers"])
    assert now["generation"] == first["generation"] + 1, now
    assert now["rebuilds"] == 1 and now["up"], now
    assert not set(now["followers"]) & set(first["followers"])
    failed = [e for e in d.events("serve_request") if not e["ok"]]
    assert [e["request_id"] for e in failed] == ["mesh-doomed"], failed
    assert not d.events("serve_request_requeued")
    (broken,) = d.events("serve_mesh_broken")
    # the killed follower first; a peer that saw it die may follow
    assert broken["exited"][0] == {"pid": first["followers"][1], "rc": -9}
    ups = d.events("serve_mesh_up")
    assert [e["generation"] for e in ups] == [1, 2], ups
    assert ups[1]["reason"] == broken["reason"]
    assert _served(d, "in-avatar-meanwhile")["mesh_shape"] is None
    assert _served(d, "mesh-after")["mesh_shape"] == [4]


def test_a_mesh_request_past_its_grace_is_broken_not_requeued(tmp_path):
    # the grace is 1.5 request timeouts: 3 s, well over a scan's time
    # under load and well under the 6 s the fault holds the order
    plan = {"slow_dispatch": {"kernel": "histogram", "delay_s": 6.0}}
    with _daemon(tmp_path, TPKT_FAULT_PLAN=json.dumps(plan),
                 TPKT_SERVE_REQUEST_TIMEOUT_S="2",
                 **_tier_env(tmp_path)) as d:
        v = (np.arange(8192) % 64).astype(np.int32)
        with client.ServeClient(d.sock, timeout_s=60) as c:
            c.next_request_id = "mesh-overdue"
            with pytest.raises(client.ServeError, match="past its grace"):
                c.dispatch("histogram", v, nbins=64)
        # the next mesh request waits for the rebuilt group (its wait is
        # half the request timeout: retry until the group is back)
        x, want = _scan(32768)
        deadline = time.monotonic() + 60
        while True:
            with client.ServeClient(d.sock, timeout_s=60) as c:
                try:
                    np.testing.assert_array_equal(c.dispatch("scan", x),
                                                  want)
                    break
                except client.ServeError as e:
                    assert "no group" in str(e), e
                    assert time.monotonic() < deadline
                    time.sleep(0.5)
    assert not d.events("serve_request_requeued")
    fires = [e for e in d.events("watchdog_fire")
             if e.get("mechanism") == "serve-mesh-break"]
    assert len(fires) == 1, fires
    assert len(d.events("serve_mesh_up")) == 2


def test_no_follower_outlives_its_daemon(tmp_path):
    with _daemon(tmp_path, "clean", **_tier_env(tmp_path)) as d:
        with client.ServeClient(d.sock, timeout_s=60) as c:
            pids = c.ping()["mesh_tier"]["followers"]
        assert d.stop() == 0
    _gone(pids)
    assert len(d.events("serve_stop")) == 1
    with _daemon(tmp_path, "killed", **_tier_env(tmp_path)) as d:
        with client.ServeClient(d.sock, timeout_s=60) as c:
            pids = c.ping()["mesh_tier"]["followers"]
        d.proc.kill()
        d.proc.wait(30)
        _gone(pids)


def test_a_tier_that_cannot_form_stops_the_daemon(tmp_path):
    """A file where the tier's folder should be: the group cannot form,
    and the daemon exits 1 before it listens; a bad knob exits 2."""
    for tag, extra, rc in (("blocked", {}, 1),
                           ("bad", {"TPKT_SERVE_MESH": "zero"}, 2)):
        d = tmp_path / tag
        d.mkdir()
        (d / "mesh").write_text("not a folder\n")
        env = _env(d, **dict(_tier_env(d), **extra))
        r = subprocess.run(
            [sys.executable, "-m", "tpukernels_torch.serve", "--socket",
             str(d / "s.sock")], cwd=ROOT, env=env, capture_output=True,
            text=True, timeout=120)
        assert r.returncode == rc, (tag, r.returncode, r.stderr)
        assert "TPKT_SERVE_MESH" in r.stderr, r.stderr
        assert not (d / "s.sock").exists() and not (d / "serve.pid").exists()
