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
  gives exactly that request an error reply and no requeue (the
  reference has no followers: a divergence by design), an in-avatar
  request is answered meanwhile, the rebuild is journaled and the next
  mesh request is right;
- the watchdog, on the reference's terms: a wedged mesh order is
  requeued once onto the next generation and answered, or answered
  ``wedged`` when it wedges twice, with the reference daemon's answer,
  requeue and watchdog counts under the same plan (4 fake devices
  there); a follower that dies under a wedged order makes it wedged at
  once, and the wedged order's tier lock is retired so the group is
  rebuilt without it; an abandoned order that wakes after the rebuild
  raises on its own, left group and generation 2 stays whole; a fleet
  fails a twice-wedged mesh bucket over to the sibling's tier;
- lifetime: no follower is left after a clean stop or after the daemon
  is SIGKILLed, and a daemon whose group cannot form exits non-zero
  before it listens.

Every state path lies in a temporary directory.
"""

import contextlib
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

from test_torch_serve import ROOT, _daemon, _env, _wait_ping
from test_torch_serve_fleet import _ctl, _events
from test_torch_serve_protocol import SMALL
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


def _raw(sock, kernel, arrays, timeout_s=120.0, **statics):
    """One dispatch over the wire: ``("ok", outputs)`` or ``(kind,
    error)`` of the reply, as the daemon gave them (the client's
    ``dispatch`` keeps no kind)."""
    from tpukernels_torch.serve import protocol

    specs, payloads = protocol.pack_arrays(arrays)
    req = {"v": protocol.VERSION, "op": "dispatch", "id": 1,
           "kernel": kernel, "statics": statics, "args": specs}
    with client.ServeClient(sock, timeout_s=timeout_s) as c:
        header, outs, _ = c._roundtrip(req, payloads)
    if not header.get("ok"):
        return header.get("kind"), header.get("error")
    return "ok", protocol.unpack_arrays(header["outputs"], outs)


def _until(pred, what, timeout=60.0):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, what
        time.sleep(0.05)


def test_a_mesh_request_past_its_grace_is_broken_not_requeued(tmp_path):
    """Past its grace, a mesh request is the watchdog's as any request
    is, on the reference's terms: its group is broken and it is
    requeued once onto the next generation, which answers it. Here the
    order wedges on rank 0 and a follower is SIGKILLed meanwhile, so the
    watchdog finds its generation broken and calls it wedged at once (no
    second grace); the wedged order's tier lock is retired, so the
    keeper, which waited for it, forms generation 2 without it."""
    plan = {"wedge_dispatch": {"kernel": "histogram", "times": 1}}
    with _daemon(tmp_path, TPKT_FAULT_PLAN=json.dumps(plan),
                 TPKT_SERVE_REQUEST_TIMEOUT_S="2",
                 **_tier_env(tmp_path)) as d:
        with client.ServeClient(d.sock, timeout_s=60) as c:
            first = c.stats()["mesh_tier"]
        v = (np.arange(8192) % 64).astype(np.int32)
        res = {}

        def overdue():
            res["got"] = _raw(d.sock, "histogram", [v], nbins=64)

        t = threading.Thread(target=overdue)
        t.start()
        _until(lambda: d.events("fault_injected"), "no wedge")
        os.kill(first["followers"][0], signal.SIGKILL)
        t.join(120)
        kind, got = res["got"]
        assert kind == "ok", res
        np.testing.assert_array_equal(got[0], np.bincount(v, minlength=64))
        x, want = _scan(32768)
        with client.ServeClient(d.sock, timeout_s=60) as c:
            np.testing.assert_array_equal(c.dispatch("scan", x), want)
            now = c.stats()["mesh_tier"]
    assert now["generation"] == first["generation"] + 1 and now["up"], now
    (req,) = d.events("serve_request_requeued")
    assert req["kernel"] == "histogram", req
    (fire,) = d.events("watchdog_fire")
    assert fire["mechanism"] == "serve-abandon", fire
    assert [e["verdict"] for e in d.events("wedge_classification")] == [
        "wedged"]
    (broken,) = d.events("serve_mesh_broken")
    assert broken["exited"][0] == {"pid": first["followers"][0], "rc": -9}
    assert [e["generation"] for e in d.events("serve_mesh_up")] == [1, 2]
    served = [e for e in d.events("serve_request")
              if e["kernel"] == "histogram"]
    assert [(e["ok"], e["requeues"]) for e in served] == [(True, 1)], served
    # the wedged order never unwinds: nothing of it reached generation 2
    assert not d.events("serve_mesh_stale_order")


# the reference daemon under JAX on the CPU with 4 fake devices, and the
# port's with a tier of 4 ranks: one wedge plan, one request sequence
WEDGE_T = "2"


@contextlib.contextmanager
def _ref_daemon(base, plan):
    d = base / "ref"
    d.mkdir()
    sock = str(d / "s.sock")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPKT_", "TPK_"))}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               TPK_SERVE_DIR=str(d), TPK_HEALTH_JOURNAL=str(d / "j.jsonl"),
               TPK_AOT_CACHE="0", TPK_SERVE_BUCKETS=json.dumps(SMALL),
               TPK_SERVE_BATCH_WINDOW_MS="0",
               TPK_SERVE_REQUEST_TIMEOUT_S=WEDGE_T,
               TPK_FAULT_PLAN=json.dumps(plan))
    with open(d / "stderr.txt", "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "tpukernels.serve", "--socket", sock],
            cwd=ROOT, env=env, stdout=subprocess.DEVNULL, stderr=err)
    try:
        _wait_ping(sock, proc, d)
        yield sock, d / "j.jsonl"
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(10)


def _wedge_sequence(sock, x, out):
    """The wedged request, then a later one over the avatar."""
    out["first"] = _raw(sock, "scan", [x])
    out["later"] = _raw(sock, "scan", [x])


@pytest.mark.parametrize("times", [1, 2])
def test_a_wedged_mesh_order_is_handled_as_the_reference_does(tmp_path,
                                                             times):
    """``wedge_dispatch`` on the mesh key ``times`` times: answered
    after one requeue (1), or ``wedged`` after the requeued attempt
    wedged too (2), in both daemons; the same counts of requeues and
    watchdog fires; a later over-avatar request answered in both."""
    plan = {"wedge_dispatch": {"kernel": "scan", "times": times}}
    x = np.random.default_rng(25 + times).integers(
        0, 1 << 10, 32768).astype(np.int32)
    want = np.cumsum(x, dtype=np.int64).astype(np.int32)
    got = {"ref": {}, "port": {}}
    with _ref_daemon(tmp_path, plan) as (rsock, rjournal), \
            _daemon(tmp_path, TPKT_FAULT_PLAN=json.dumps(plan),
                    TPKT_SERVE_REQUEST_TIMEOUT_S=WEDGE_T,
                    **_tier_env(tmp_path)) as d:
        threads = [threading.Thread(target=_wedge_sequence,
                                    args=(sock, x, got[k]))
                   for k, sock in (("ref", rsock), ("port", d.sock))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(240)
        assert not any(t.is_alive() for t in threads), got
        with client.ServeClient(d.sock, timeout_s=60) as c:
            tier_now = c.stats()["mesh_tier"]
    ref_events = _events(rjournal)
    counts = {}
    for k, evs in (("ref", ref_events), ("port", d.events())):
        counts[k] = {kind: sum(e.get("kind") == kind for e in evs)
                     for kind in ("serve_request_requeued", "watchdog_fire")}
        kind, out = got[k]["first"]
        if times == 1:
            assert kind == "ok", (k, got[k]["first"])
            np.testing.assert_array_equal(out[0], want)
        else:
            assert kind == "wedged", (k, got[k]["first"])
            assert out.startswith("request wedged twice"), out
        kind, out = got[k]["later"]
        assert kind == "ok", (k, got[k]["later"])
        np.testing.assert_array_equal(out[0], want)
    assert counts["port"] == counts["ref"] == {
        "serve_request_requeued": 1, "watchdog_fire": times}, counts
    if times == 1:
        np.testing.assert_array_equal(got["port"]["first"][1][0],
                                      got["ref"]["first"][1][0])
    else:
        assert got["port"]["first"][1] == got["ref"]["first"][1], got
    # each wedge broke its generation; the next one served what followed
    assert tier_now["generation"] == 1 + times and tier_now["up"], tier_now
    assert len(d.events("serve_mesh_broken")) == times
    mesh_served = [e for e in d.events("serve_request")
                   if e["mesh_shape"] == [4]]
    assert [e["ok"] for e in mesh_served] == [times == 1, True]


def test_a_late_unwind_reaches_no_later_generation(tmp_path):
    """Rank 0's order sleeps in its fault point past its grace, the
    break and the rebuild (``slow_dispatch`` on every 2nd histogram:
    the first is a warm-up, the third the retry). The retry is answered
    on generation 2; when the abandoned order wakes, its pinned mesh's
    group is left and it raises on that, issuing no collective on
    generation 2: generation 2 answers a later request and is never
    broken."""
    plan = {"slow_dispatch": {"kernel": "histogram", "delay_s": 20.0,
                              "every": 2}}
    v = (np.arange(8192) % 64).astype(np.int32)
    want = np.bincount(v, minlength=64)
    with _daemon(tmp_path, TPKT_FAULT_PLAN=json.dumps(plan),
                 TPKT_SERVE_REQUEST_TIMEOUT_S="2",
                 **_tier_env(tmp_path)) as d:
        with client.ServeClient(d.sock, timeout_s=120) as c:
            np.testing.assert_array_equal(c.dispatch("histogram", v,
                                                     nbins=64), want)
            c.next_request_id = "late"
            np.testing.assert_array_equal(c.dispatch("histogram", v,
                                                     nbins=64), want)
            (slow,) = [e for e in d.events("fault_injected")
                       if e.get("fault") == "slow_dispatch"]
            # the abandoned order wakes 20 s after it slept
            _until(lambda: d.events("serve_mesh_stale_order"),
                   "the abandoned order never unwound", timeout=60)
            x, want_x = _scan(32768)
            c.next_request_id = "after-unwind"
            np.testing.assert_array_equal(c.dispatch("scan", x), want_x)
            now = c.stats()["mesh_tier"]
    (stale,) = d.events("serve_mesh_stale_order")
    assert stale["generation"] == 1 and stale["current"] == 2, stale
    assert "GroupLeft" in stale["error"], stale
    assert stale["t"] >= slow["t"] + 20.0 - 0.5
    assert len(d.events("serve_mesh_broken")) == 1
    assert [e["generation"] for e in d.events("serve_mesh_up")] == [1, 2]
    assert now["generation"] == 2 and now["up"] and now["rebuilds"] == 1
    assert len(d.events("serve_request_requeued")) == 1
    # one answer a request: the retry's (the unwind was discarded)
    served = [e["request_id"] for e in d.events("serve_request")]
    assert served.count("late") == 1 and served.count("after-unwind") == 1
    assert all(e["ok"] for e in d.events("serve_request"))


def test_fleet_fails_a_twice_wedged_mesh_bucket_over(tmp_path,
                                                     monkeypatch):
    """A mesh bucket that wedges twice on its home worker's tier is
    answered ``wedged`` there; the router fails it over to the sibling,
    whose tier answers it, and cools the home."""
    from tpukernels_torch.serve import bucketing, router

    x, want = _scan(32768, 31)
    monkeypatch.setenv("TPKT_SERVE_BUCKETS", json.dumps(SMALL))
    spec, _ = bucketing.bucket_for("scan", [x], {})
    bucket = bucketing.bucket_id("scan", spec, {}, [x])
    home, sib = router.ring_order(bucket, 2)[:2]
    d = tmp_path / "f"
    d.mkdir()
    plan = {"wedge_dispatch": {"kernel": "scan", "times": 2,
                               "env": {"TPKT_SERVE_WORKER_ID": str(home)}}}
    env = _env(d, TPKT_SERVE_MESH="2", TPKT_SERVE_BATCH_WINDOW_MS="0",
               TPKT_AOT_DIR=str(d / "aot"), TPKT_COORDINATOR_TIMEOUT_S="120",
               TPKT_SERVE_REQUEST_TIMEOUT_S=WEDGE_T,
               TPKT_ROUTE_COOLDOWN_S="120", TPKT_FAULT_PLAN=json.dumps(plan))
    r = _ctl(env, "start-fleet", "2", "--wait", "120")
    assert r.returncode == 0, r.stdout + r.stderr
    try:
        with client.ServeClient(str(d / "fleet" / "front.sock"),
                                timeout_s=180) as c:
            np.testing.assert_array_equal(c.dispatch("scan", x), want)
            np.testing.assert_array_equal(c.dispatch("scan", x), want)
    finally:
        r = _ctl(env, "stop-fleet", "--wait", "60")
        assert r.returncode == 0, r.stdout + r.stderr
    events = _events(d / "journal.jsonl")
    spills = [e for e in events if e["kind"] == "serve_spill"]
    assert [(e["reason"], e["from_worker"], e["to_worker"])
            for e in spills] == [("wedged", home, sib)]
    routes = [e for e in events if e["kind"] == "serve_route"]
    assert [(e["ok"], e["worker"], e["spilled_from"]) for e in routes] == [
        (True, sib, home), (True, sib, None)]
    served = [e for e in events if e.get("kind") == "serve_request"
              and e.get("kernel") == "scan"]
    assert [(e["ok"], e["mesh_shape"], e["worker_id"]) for e in served] == [
        (False, [2], str(home)), (True, [2], str(sib)),
        (True, [2], str(sib))], served
    assert sum(e["kind"] == "serve_request_requeued" for e in events) == 1
    ups = [e for e in events if e.get("kind") == "serve_mesh_up"]
    _gone([p for e in ups for p in e["followers"]])


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
