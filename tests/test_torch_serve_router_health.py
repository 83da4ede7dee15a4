"""The port's router crash recovery against the reference, on the CPU.

Here:

- the write-ahead log both ways: the same appends and acks written by
  the reference's ``Wal`` and by the port's give the same bytes, and
  each package's ``read_pending`` reads the other's log to the same
  map, through a compaction and with a torn last line;
- the guardian's knob parsers fail as the reference's do;
- with the guardian running, ``kill_router`` (the router SIGKILLs itself
  after its third accepted request is durable in the log, before the
  forward): ``router_dead``, ``router_respawned`` on the original front
  socket, the log replayed (``serve_request_replayed`` via ``wal``), no
  failed request, and exactly one ``serve_request`` a request_id across
  the crash, a request the dead router had already forwarded included
  (the daemon answers its replay from its replay memo:
  ``serve_request_deduped``);
- ``ctl fsck`` reaps the crash residue the reference's ``fsck`` reaps,
  with the same counts.

The port's fleet runs with ``TPKT_SERVE_DEVICE=cpu``
(``tests/test_torch_serve_fleet.py``'s helpers); every wait has its own
deadline.
"""

import json
import os
import random
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from test_torch_serve import _daemon
from test_torch_serve_fleet import (
    FAST_HEALTH,
    ROOT,
    _ctl,
    _events,
    _fleet,
    _wait_events,
)
from tpukernels.serve import guardian as ref_guardian
from tpukernels.serve import wal as ref_wal
from tpukernels_torch.serve import client, guardian, health, protocol, wal


def _ops(seed, n=150):
    """A seeded sequence of appends and acks that leaves a few entries
    pending and crosses the compaction threshold."""
    rng = random.Random(seed)
    pending, ops = [], []
    for i in range(n):
        if pending and rng.random() < 0.55:
            ops.append(("ack", pending.pop(rng.randrange(len(pending)))))
        else:
            key = f"{1000 + seed}-{i}"
            entry = {"header": {"v": 1, "op": "dispatch", "id": i,
                                "kernel": "scan", "request_id": f"r-{i}"},
                     "kernel": "scan", "bucket": "scan|4096|-",
                     "t_wal": 1700000000.0 + i, "p64": ["AAAA" * (i % 5)]}
            ops.append(("append", key, entry))
            pending.append(key)
    return ops


def _play(mod, path, ops):
    w = mod.Wal(path)
    for op in ops:
        if op[0] == "append":
            w.append(op[1], op[2])
        else:
            w.ack(op[1])
    return w


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wal_is_the_references_both_ways(tmp_path, seed):
    ops = _ops(seed)
    mine, ref = str(tmp_path / "port.wal"), str(tmp_path / "ref.wal")
    wm, wr = _play(wal, mine, ops), _play(ref_wal, ref, ops)
    assert wal.COMPACT_SLACK == ref_wal.COMPACT_SLACK
    with open(mine, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()
    want = ref_wal.read_pending(ref)
    assert want and len(want) < len(ops) // 2
    for path in (mine, ref):
        assert wal.read_pending(path) == ref_wal.read_pending(path) == want
    assert wm.take_pending() == wr.take_pending() == want
    wm.close()
    wr.close()
    # a torn last line is skipped by both, in either's log
    for path in (mine, ref):
        with open(path, "ab") as f:
            f.write(b'{"op": "req", "key": "torn", "e": {"hal')
        assert wal.read_pending(path) == ref_wal.read_pending(path) == want
    # a respawned router of either package recovers the other's debt,
    # and appends after the torn line
    w = wal.Wal(ref)
    assert w.take_pending() == want
    for key in want:
        w.ack(key)
    w.append("after", {"n": 1})
    assert ref_wal.read_pending(ref) == {"after": {"n": 1}}
    w.ack("after")
    w.close()
    assert not os.path.exists(ref)  # nothing pending: no file left
    r = ref_wal.Wal(mine)
    assert wal.read_pending(mine) == r.take_pending() == want
    r.close()


def test_wal_stays_bounded(tmp_path):
    path = str(tmp_path / "router.wal")
    w = wal.Wal(path)
    for i in range(300):
        w.append(f"k{i}", {"n": i})
        w.ack(f"k{i}")
    w.append("tail", {"n": -1})
    with open(path, "rb") as f:
        lines = [ln for ln in f.read().split(b"\n") if ln.strip()]
    assert len(lines) < 2 * wal.COMPACT_SLACK + 4
    assert list(ref_wal.read_pending(path)) == ["tail"]
    w.close()
    assert os.path.exists(path)  # still something to replay


@pytest.mark.parametrize("knob,raw", [("ROUTER_RESTART_MAX", "banana"),
                                      ("ROUTER_RESTART_MAX", "0"),
                                      ("ROUTER_RESTART_BACKOFF_S", "nope"),
                                      ("ROUTER_RESTART_BACKOFF_S", "0.01")])
def test_guardian_knobs_fail_as_the_references(monkeypatch, knob, raw):
    monkeypatch.setenv(f"TPKT_{knob}", raw)
    monkeypatch.setenv(f"TPK_{knob}", raw)
    with pytest.raises(ValueError) as mine:
        guardian.Guardian(repo=str(ROOT))
    with pytest.raises(ValueError) as ref:
        ref_guardian.Guardian(repo=str(ROOT))
    assert str(mine.value) == str(ref.value).replace("TPK_", "TPKT_")
    assert f"TPKT_{knob}" in str(mine.value)


def test_guardian_defaults_are_the_references(monkeypatch):
    for var in ("ROUTER_RESTART_MAX", "ROUTER_RESTART_BACKOFF_S",
                "FLEET_PROBE_S"):
        monkeypatch.delenv(f"TPKT_{var}", raising=False)
        monkeypatch.delenv(f"TPK_{var}", raising=False)
    g, r = guardian.Guardian(repo=str(ROOT)), ref_guardian.Guardian(
        repo=str(ROOT))
    assert (g.restart_max, g.backoff_s, g.probe_s) == (
        r.restart_max, r.backoff_s, r.probe_s)


# compressed windows, the inline lane (the log keeps inline payloads), a
# client reconnect budget wider than the respawn window
GUARDIAN_ENV = dict(FAST_HEALTH, TPKT_ROUTER_RESTART_BACKOFF_S="0.2",
                    TPKT_SERVE_SHM="0", TPKT_CLIENT_RECONNECT_S="60")


def _burst(front, tid, n, ok, fail, step_s=0.1):
    jit = random.Random(1000 + tid)
    x = (np.arange(256) % 11).astype(np.int32)
    want = np.cumsum(x, dtype=np.int64).astype(np.int32)
    with client.ServeClient(front, timeout_s=120, tenant=f"t{tid}") as cli:
        for k in range(n):
            try:
                cli.next_request_id = f"rk-{tid}-{k}"
                out = client.dispatch_with_backpressure(
                    cli, "scan", (x,), {}, jitter=jit)
                assert np.array_equal(out, want), "wrong result"
                ok.append((tid, k))
            except Exception as e:  # noqa: BLE001 - collected, asserted
                fail.append((tid, k, repr(e)))
            time.sleep(step_s)


def test_kill_router_replays_the_log_exactly_once(tmp_path, monkeypatch):
    once = tmp_path / "kill_router.once"
    plan = json.dumps({"kill_router": {"on_call": 3,
                                       "once_file": str(once)}})
    for k, v in GUARDIAN_ENV.items():
        monkeypatch.setenv(k, v)  # the test's own client reads them
    with _fleet(tmp_path, n=2, tag="wal", TPKT_FAULT_PLAN=plan,
                **GUARDIAN_ENV) as (front, jpath, env):
        r = _ctl(env, "guardian", "--wait", "30")
        assert r.returncode == 0, r.stdout + r.stderr
        r = _ctl(env, "guardian", "--wait", "5")
        assert r.returncode == 3, r.stdout + r.stderr
        rpid = health.pidfile_state(os.path.join(
            env["TPKT_SERVE_DIR"], "fleet", "router.pid"))[1]
        ok, fail = [], []
        threads = [threading.Thread(target=_burst,
                                    args=(front, tid, 6, ok, fail))
                   for tid in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(240)
        assert not any(t.is_alive() for t in threads)
        assert once.exists(), "the fault never fired"
        assert not fail, fail
        assert len(ok) == 12
        events, resp = _wait_events(
            jpath, lambda e: e["kind"] == "router_respawned", timeout=60,
            msg="router_respawned")
        r = _ctl(env, "health", "--wait", "30")
        assert r.returncode == 0, r.stdout + r.stderr
    (dead,) = [e for e in events if e["kind"] == "router_dead"]
    assert dead["router_pid"] == rpid
    assert resp[0]["down_s"] is not None and resp[0]["router_pid"] != rpid
    (fired,) = [e for e in events if e["kind"] == "fault_injected"
                and e.get("fault") == "kill_router"]
    assert fired["site"] == "route" and fired["call"] == 3
    replays = [e for e in events if e["kind"] == "serve_request_replayed"
               and e.get("via") == "wal"]
    assert replays, "the durable entry must be replayed"
    assert all(e["request_id"].startswith("rk-") and e.get("ok", True)
               for e in replays)
    # exactly one delivery to a worker per request_id, replays included
    per = {}
    for e in events:
        if (e["kind"] == "serve_request"
                and str(e.get("request_id")).startswith("rk-")):
            per[e["request_id"]] = per.get(e["request_id"], 0) + 1
    assert per == {f"rk-{t}-{k}": 1 for t in range(2) for k in range(6)}
    # a replay of a request the worker had already run was answered
    # from its memo, on the worker that ran it
    for e in events:
        if e["kind"] == "serve_request_deduped":
            (ran,) = [s for s in events if s["kind"] == "serve_request"
                      and s.get("request_id") == e["request_id"]]
            assert ran["worker_id"] == e["worker_id"]


def _scan_frame(x, rid, **extra):
    specs, payloads = protocol.pack_arrays([x])
    return dict({"v": protocol.VERSION, "op": "dispatch", "id": 1,
                 "kernel": "scan", "args": specs, "statics": {},
                 "request_id": rid}, **extra), payloads


def test_a_replay_of_an_answered_request_runs_once(tmp_path):
    """The daemon's replay memo: a request_id it already answered comes
    back as a replay (``replay`` > 0) and is answered from the memo,
    bit for bit, without a second ``serve_request``; a replay of another
    bucket, or one that never ran here, runs."""
    x = (np.arange(3000) % 13).astype(np.int32)
    want = np.cumsum(x, dtype=np.int64).astype(np.int32)
    with _daemon(tmp_path) as d, client.ServeClient(d.sock,
                                                    timeout_s=60) as c:
        def send(arr, rid, **extra):
            h, p, _ = c._roundtrip(*_scan_frame(arr, rid, **extra))
            assert h["ok"], h
            (out,) = protocol.unpack_arrays(h["outputs"], p)
            return h, np.asarray(out)

        h, first = send(x, "m-1")
        np.testing.assert_array_equal(first, want)
        h, again = send(x, "m-1", replay=1)
        assert h.get("deduped") is True
        assert again.tobytes() == first.tobytes()
        # not a replay: the same id runs again (the memo serves replays)
        h, _ = send(x, "m-1")
        assert "deduped" not in h
        # a replay of another bucket under the same id runs
        y = np.arange(5000, dtype=np.int32)
        h, got = send(y, "m-1", replay=1)
        assert "deduped" not in h
        np.testing.assert_array_equal(got, np.cumsum(y, dtype=np.int32))
        # a replay this daemon never ran runs
        h, _ = send(x, "m-2", replay=1)
        assert "deduped" not in h
        stats = c.stats()
    assert stats["deduped"] == 1
    served = [e["request_id"] for e in d.events("serve_request")]
    assert served == ["m-1", "m-1", "m-1", "m-2"]
    (dd,) = d.events("serve_request_deduped")
    assert (dd["request_id"], dd["bucket"]) == ("m-1", "scan|4096|-")


def _residue(root, dead_pid, name):
    fdir = root / "fleet"
    (fdir / "worker0").mkdir(parents=True)
    for p in ("router.pid", "guardian.pid", "worker0/serve.pid"):
        (fdir / p).write_text(f"{dead_pid}\n")
    (fdir / "fleet.json").write_text('{"workers": [')
    with open(os.path.join(protocol.SHM_DIR, name), "wb") as f:
        f.write(b"\0" * 16)
    return fdir


def test_fsck_reaps_what_the_references_reaps(tmp_path):
    dead = int(subprocess.run(
        [sys.executable, "-c", "import os; print(os.getpid())"],
        capture_output=True, text=True).stdout)
    base = {k: v for k, v in os.environ.items()
            if not k.startswith(("TPKT_", "TPK_"))}
    base.update(PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu")
    out = {}
    for who in ("ref", "port"):
        root = tmp_path / who
        seg = f"tpkserve-{dead}-0-{'cafe' if who == 'ref' else 'f00d'}"
        fdir = _residue(root, dead, seg)
        try:
            if who == "ref":
                env = dict(base, TPK_SERVE_DIR=str(root),
                           TPK_HEALTH_JOURNAL=str(root / "j.jsonl"))
                r = subprocess.run(
                    [sys.executable, str(ROOT / "tools" / "serve_ctl.py"),
                     "fsck"], capture_output=True, text=True, timeout=120,
                    cwd=ROOT, env=env)
            else:
                env = dict(base, TPKT_SERVE_DIR=str(root),
                           TPKT_HEALTH_JOURNAL=str(root / "j.jsonl"))
                r = _ctl(env, "fsck")
            assert r.returncode == 0, r.stdout + r.stderr
            assert not os.path.exists(os.path.join(protocol.SHM_DIR, seg))
        finally:
            protocol.unlink_shm(seg)
        assert sorted(os.listdir(fdir)) == ["worker0"]
        assert os.listdir(fdir / "worker0") == []
        (ev,) = _events(root / "j.jsonl", "fleet_fsck")
        reaped = sorted(ln.split(" (")[0].replace(str(root), "ROOT")
                        for ln in r.stdout.splitlines() if "reaped" in ln)
        out[who] = ({k: ev[k] for k in ("stale_pidfiles", "torn_configs")},
                    ev["swept_segments"] >= 1,
                    [ln.replace("serve_ctl:", "ctl:") for ln in reaped])
    assert out["port"] == out["ref"]
    assert out["port"][0] == {"stale_pidfiles": 3, "torn_configs": 1}
    assert len(out["port"][2]) == 4
    # a clean tree: nothing to reap, rc 0
    r = _ctl(dict(base, TPKT_SERVE_DIR=str(tmp_path / "port"),
                  TPKT_HEALTH_JOURNAL=str(tmp_path / "j2.jsonl")), "fsck")
    assert r.returncode == 0 and "0 stale pidfile(s)" in r.stdout, r.stdout
