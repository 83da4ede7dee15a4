"""The port's serving daemon against the reference, on the CPU.

``python -m tpukernels_torch.serve`` runs with ``TPKT_SERVE_DEVICE=cpu``
(the wrappers' plain versions) and a small avatar a key
(``TPKT_SERVE_BUCKETS``). For each of the nine registry keys, seeded
numpy operands go through the reference's unchanged ``ServeClient`` to
the port's daemon, on the inline lane and on the shm lane, and through
the reference's ``registry.dispatch`` in process (its Pallas kernels in
interpret mode, as its own tests run them). Tolerances are those of
``tests/test_torch_<kernel>.py``: bitwise for the stencils, exact for the
int32 keys, rtol 1e-6 / atol 1e-7 for SAXPY, rtol 1e-4 / atol 1e-3 for
SGEMM ``high`` and rtol 1e-3 / atol 2e-4 for N-body; each output keeps
the wire's dtype. Then: the reference's ``tools/loadgen.py --serve``
against the port's daemon, the port's client against the reference's
daemon, the daemon's journal and spans, its ``stats`` op, bad requests,
a C driver through the port's shim routed to the daemon
(``TPKT_SERVE_SOCKET``), and a daemon with no card and no CPU setting,
which must refuse to start. One daemon serves the module; every state
path lies in a temporary directory.
"""

import contextlib
import json
import os
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_serve_protocol import SMALL
from tpukernels import registry as ref_registry
from tpukernels.serve import client as ref_client
from tpukernels_torch.resilience import journal
from tpukernels_torch.serve import client, protocol

ROOT = Path(__file__).resolve().parent.parent

# (rtol, atol), or None for bitwise
TOL = {"vector_add": (1e-6, 1e-7), "sgemm": (1e-4, 1e-3), "stencil2d": None,
       "stencil3d": None, "scan": None, "scan_exclusive": None,
       "histogram": None, "scan_histogram": None, "nbody": (1e-3, 2e-4)}
WIRE_DTYPES = ("float32", "int32")


def _f(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _i(rng, n, hi):
    return rng.integers(0, hi, n).astype(np.int32)


def _bodies(rng, n):
    pos = [rng.uniform(-1, 1, n).astype(np.float32) for _ in range(3)]
    vel = [0.1 * rng.uniform(-1, 1, n).astype(np.float32) for _ in range(3)]
    return [*pos, *vel, rng.uniform(0.5, 1.5, n).astype(np.float32)]


# key -> (operands from a seeded rng, statics): padded up to the small
# avatar where the key has a pad rule; the 2-D grid fits its avatar
# exactly, the 3-D one does not (it dispatches at its own shape)
CASES = {
    "vector_add": (lambda r: [np.float32(2.5), _f(r, 1000), _f(r, 1000)],
                   {}),
    "sgemm": (lambda r: [np.float32(1.5), _f(r, 60, 90), _f(r, 90, 70),
                         np.float32(0.5), _f(r, 60, 70)], {}),
    "stencil2d": (lambda r: [_f(r, 40, 72)], {"iters": 3}),
    "stencil3d": (lambda r: [_f(r, 8, 24, 36)], {"iters": 2}),
    "scan": (lambda r: [_i(r, 3000, 1 << 16)], {}),
    "scan_exclusive": (lambda r: [_i(r, 2500, 1 << 16)], {}),
    "histogram": (lambda r: [_i(r, 3500, 64)], {"nbins": 64}),
    "scan_histogram": (lambda r: [_i(r, 3100, 64)], {"nbins": 64}),
    "nbody": (lambda r: _bodies(r, 200),
              {"dt": 1e-3, "eps": 1e-2, "steps": 1}),
}


def _env(d, **extra):
    """A daemon's environment: no knob of either package from outside,
    every state path in ``d``."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPKT_", "TPK_"))}
    env.update(PYTHONPATH=str(ROOT), TPKT_SERVE_DIR=str(d),
               TPKT_HEALTH_JOURNAL=str(d / "journal.jsonl"),
               TPKT_INTEGRITY_DIR=str(d / "integrity"),
               TPKT_TUNING_CACHE_DIR=str(d / "tuning"), TPKT_TRACE="1",
               TPKT_SERVE_DEVICE="cpu", TPKT_SERVE_BUCKETS=json.dumps(SMALL),
               TPKT_SERVE_SHM_MIN_BYTES="1024")
    env.update({k: str(v) for k, v in extra.items() if v is not None})
    for k in [k for k, v in extra.items() if v is None]:
        env.pop(k, None)
    return env


class Daemon:
    def __init__(self, d, proc, sock):
        self.dir, self.proc, self.sock = d, proc, sock
        self.journal = d / "journal.jsonl"

    def events(self, kind=None):
        recs, _ = journal.load_events([self.journal])
        return [r for r in recs if kind is None or r.get("kind") == kind]

    def stop(self, timeout=30):
        """SIGTERM, and the daemon's exit code."""
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        try:
            return self.proc.wait(timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(10)
            raise

    def output(self):
        return ((self.dir / "stdout.txt").read_text(),
                (self.dir / "stderr.txt").read_text())


def _wait_ping(sock, proc, d, timeout=90):
    deadline = time.monotonic() + timeout
    while True:
        if proc.poll() is not None:
            raise AssertionError(f"daemon exited rc {proc.returncode}: "
                                 f"{(d / 'stderr.txt').read_text()}")
        try:
            with client.ServeClient(sock, timeout_s=10) as c:
                return c.ping()
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.1)


@contextlib.contextmanager
def _daemon(base, tag="d", args=(), **env_extra):
    """``python -m tpukernels_torch.serve`` on a socket in ``base/tag``;
    yields a :class:`Daemon` once it answers a ping, and stops it on
    exit."""
    d = base / tag
    d.mkdir()
    sock = str(d / "s.sock")
    with open(d / "stdout.txt", "w") as out, \
            open(d / "stderr.txt", "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "tpukernels_torch.serve", "--socket", sock,
             *args], cwd=ROOT, env=_env(d, **env_extra), stdout=out,
            stderr=err)
    daemon = Daemon(d, proc, sock)
    try:
        _wait_ping(sock, proc, d)
        yield daemon
    finally:
        if proc.poll() is None:
            daemon.stop()


@pytest.fixture(scope="module")
def daemon(tmp_path_factory):
    with _daemon(tmp_path_factory.mktemp("serve")) as d:
        yield d


@pytest.fixture(scope="module")
def reference_results():
    """The reference's ``registry.dispatch`` of every case, in process."""
    saved = {k: os.environ.get(k) for k in ("TPK_AOT_CACHE",
                                            "TPK_INTEGRITY")}
    os.environ["TPK_AOT_CACHE"] = "0"
    os.environ["TPK_INTEGRITY"] = "0"
    try:
        out = {}
        for key, (make, statics) in CASES.items():
            args = make(np.random.default_rng(7))
            res = ref_registry.dispatch(key, *(jnp.asarray(a) for a in args),
                                        **statics)
            res = res if isinstance(res, tuple) else (res,)
            out[key] = tuple(np.asarray(r) for r in res)
        return out
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _lane(monkeypatch, lane):
    """The reference client's lane: inline, or every operand through
    /dev/shm."""
    if lane == "shm":
        if not protocol.shm_available():
            pytest.skip("this host cannot map /dev/shm segments")
        monkeypatch.delenv("TPK_SERVE_SHM", raising=False)
        monkeypatch.setenv("TPK_SERVE_SHM_MIN_BYTES", "1")
    else:
        monkeypatch.setenv("TPK_SERVE_SHM", "0")


@pytest.mark.parametrize("lane", ["inline", "shm"])
@pytest.mark.parametrize("key", sorted(CASES))
def test_reference_client_gets_the_reference_answer(daemon,
                                                    reference_results,
                                                    monkeypatch, key, lane):
    _lane(monkeypatch, lane)
    make, statics = CASES[key]
    args = make(np.random.default_rng(7))
    with ref_client.ServeClient(daemon.sock, timeout_s=120) as c:
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


def test_journal_and_spans_of_a_request(daemon):
    with client.ServeClient(daemon.sock, timeout_s=60) as c:
        c.next_request_id = "trace-me-1"
        out = c.dispatch("scan", np.arange(3000, dtype=np.int32))
    np.testing.assert_array_equal(out, np.cumsum(np.arange(3000)))
    (req,) = [e for e in daemon.events("serve_request")
              if e.get("request_id") == "trace-me-1"]
    assert req["ok"] and req["bucketed"] and req["pid"] == daemon.proc.pid
    assert req["bucket"] == "scan|4096|-" and req["shapes"] == [[3000]]
    assert req["mesh_shape"] is None
    spans = {e["name"]: e for e in daemon.events("span")
             if e.get("request_id") == "trace-me-1"}
    assert {"serve/wait/queue", "serve/wait/lock", "serve/pad", "serve/scan",
            "serve/scan/dispatch/scan"} <= set(spans)
    assert spans["serve/scan"]["device"] == "cpu"
    (start,) = daemon.events("serve_start")
    assert start["lanes"][0] == "inline" and start["workers"] == 2


def test_stats_report_the_device_and_torch(daemon):
    with client.ServeClient(daemon.sock, timeout_s=60) as c:
        pong = c.ping()
        full = c.stats()
    assert pong["device"] == "cpu" and pong["device_kind"] == "cpu"
    assert pong["torch"] and "jax" not in pong
    assert pong["request_trace"] is True and pong["pid"] == daemon.proc.pid
    assert full["ok"] and full["role"] == "daemon"
    assert "counters" in full["metrics"]
    assert isinstance(full["pad_pool"], dict)
    # on the CPU the wrappers run their plain versions: no launch, and
    # no card memory
    assert full["launches"] and not any(full["launches"].values())
    assert full["device_memory"] is None and full["deduped"] == 0


def test_bad_requests_are_answered_and_the_connection_lives(daemon):
    with client.ServeClient(daemon.sock, timeout_s=60) as c:
        with pytest.raises(client.ServeError, match="unknown kernel"):
            c.dispatch("dgemm", np.ones(4, np.float32))
        h, _, _ = c._roundtrip({"v": 1, "op": "dispatch", "id": 99,
                                "args": []})  # no kernel
        assert not h["ok"] and "bad request" in h["error"]
        h, _, _ = c._roundtrip({"v": 1, "op": "nope"})
        assert not h["ok"] and "unknown op" in h["error"]
        assert c.dispatch("scan", np.ones(5, np.int32)).tolist() == \
            [1, 2, 3, 4, 5]


def test_loadgen_drives_the_port_daemon(daemon, tmp_path):
    """The reference's load generator, unchanged, against the port."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPKT_", "TPK_"))}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT),
               TPK_HEALTH_JOURNAL=str(tmp_path / "lg.jsonl"),
               TPK_SLO_DIR=str(tmp_path / "slo"))
    before = len(daemon.events("serve_request"))
    r = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "loadgen.py"), "--serve",
         daemon.sock, "--mix", "scan=1,vector_add=1", "--seed", "7",
         "--requests", "40"], capture_output=True, text=True, timeout=300,
        cwd=ROOT, env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "DROPPED" not in r.stdout and "(served)" in r.stdout
    served = daemon.events("serve_request")[before:]
    assert len(served) == 42 and all(e["ok"] for e in served)  # + 2 warms
    assert {e["kernel"] for e in served} == {"scan", "vector_add"}


def test_port_client_drives_the_reference_daemon(tmp_path):
    d = tmp_path / "ref"
    d.mkdir()
    sock = str(d / "s.sock")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPKT_", "TPK_"))}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT),
               TPK_SERVE_DIR=str(d), TPK_HEALTH_JOURNAL=str(d / "j.jsonl"),
               TPK_AOT_CACHE="0")
    with open(d / "err.txt", "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "tpukernels.serve", "--socket", sock],
            cwd=ROOT, env=env, stdout=subprocess.DEVNULL, stderr=err)
    try:
        _wait_ping(sock, proc, d)
        x = np.random.default_rng(3).integers(0, 99, 4093).astype(np.int32)
        with client.ServeClient(sock, timeout_s=120) as c:
            pong = c.ping()
            got = c.dispatch("scan", x)
        assert pong["pid"] == proc.pid and "torch" not in pong
        np.testing.assert_array_equal(got, np.cumsum(x, dtype=np.int32))
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            assert proc.wait(30) == 0
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(10)
            raise


def test_no_card_and_no_cpu_setting_refuses_to_start(tmp_path):
    d = tmp_path / "nocard"
    d.mkdir()
    sock = d / "s.sock"
    env = _env(d, TPKT_SERVE_DEVICE=None, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run(
        [sys.executable, "-m", "tpukernels_torch.serve", "--socket",
         str(sock)], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120)
    assert r.returncode != 0
    assert "TPKT_SERVE_DEVICE=cpu" in r.stderr and r.stdout == ""
    assert not sock.exists() and not (d / "serve.pid").exists()
    assert not (d / "journal.jsonl").exists()  # not even serve_start


@pytest.fixture(scope="module")
def c_built(tmp_path_factory):
    from tpukernels_torch import _build

    if not (shutil.which("gcc") or shutil.which("cc")):
        pytest.skip("no C compiler (gcc or cc) on PATH")
    try:
        _build.python_embed_flags()
    except RuntimeError as e:
        pytest.skip(f"python3-config --embed unavailable: {e}")
    d = tmp_path_factory.mktemp("c_serve")
    return _build.build_shim(d), _build.build_c_drivers(d / "cbin")


@pytest.mark.parametrize("driver,args", [
    ("vector_add", ["--n=1000"]),
    ("scan_histogram", ["--n=3000", "--nbins=64"]),
])
def test_c_driver_through_the_daemon(daemon, c_built, tmp_path, driver,
                                     args):
    """A C driver on the port's shim with ``TPKT_SERVE_SOCKET``: its own
    check passes, and its request lands in the daemon's journal under
    the daemon's pid (not the in-process path)."""
    shim, cbin = c_built
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPKT_", "TPK_")) and k != "PYTHONPATH"}
    env.update(TPU_KERNELS_SHIM=str(shim), TPKT_SERVE_SOCKET=daemon.sock,
               TPKT_CAPI_DEVICE="cpu", TPKT_TRACE="1",
               TPKT_HEALTH_JOURNAL=str(tmp_path / "c.jsonl"),
               TPKT_INTEGRITY_DIR=str(tmp_path / "integ"),
               TPKT_TUNING_CACHE_DIR=str(tmp_path / "tuning"))
    before = len(daemon.events("serve_request"))
    r = subprocess.run([str(cbin / driver), "--device=tpu", "--check",
                        "--reps=1", *args], env=env, capture_output=True,
                       text=True, timeout=300, cwd=tmp_path)
    assert r.returncode == 0, r.stdout + r.stderr
    assert f"kernel={driver} CHECK PASS" in r.stdout
    assert "falling back in-process" not in r.stderr
    served = daemon.events("serve_request")[before:]
    assert served and all(e["pid"] == daemon.proc.pid and e["ok"]
                          for e in served)
    assert {e["kernel"] for e in served} == {driver}
    # the C host dispatched nothing itself
    recs, _ = journal.load_events([tmp_path / "c.jsonl"])
    names = {e.get("name") for e in recs if e.get("kind") == "span"}
    assert f"capi/{driver}" in names
    assert not any(n and "dispatch/" in n for n in names)


def _c_params(bufs, **scalars):
    names = {np.dtype(np.float32): "f32", np.dtype(np.int32): "i32"}
    return json.dumps({**scalars, "buffers": [
        {"shape": list(b.shape), "dtype": names[b.dtype]} for b in bufs]})


def _c_run(kernel, bufs, **scalars):
    """``capi.run_from_c`` on copies of ``bufs``, as the shim calls it;
    returns the copies."""
    from tpukernels_torch import capi

    bufs = [np.ascontiguousarray(b).copy() for b in bufs]
    assert capi.run_from_c(kernel, _c_params(bufs, **scalars),
                           [b.ctypes.data for b in bufs]) == 0
    return bufs


@pytest.fixture
def capi_rig(monkeypatch, tmp_path):
    monkeypatch.setenv("TPKT_CAPI_DEVICE", "cpu")
    monkeypatch.setenv("TPKT_INTEGRITY_DIR", str(tmp_path / "integ"))
    monkeypatch.setenv("TPKT_HEALTH_JOURNAL", str(tmp_path / "c.jsonl"))
    monkeypatch.setenv("TPKT_TUNING_CACHE_DIR", str(tmp_path / "tuning"))
    for var in ("TPKT_FAULT_PLAN", "TPKT_TRACE", "TPKT_SERVE_SOCKET",
                "TPKT_SERVE_SHM", "TPKT_INTEGRITY"):
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


# (C kernel, buffers from a seeded rng, params): every adapter, both
# scan_histogram passes
C_CASES = {
    "vector_add": ("vector_add", lambda r: [_f(r, 1000), _f(r, 1000)],
                   {"alpha": 2.5}),
    "sgemm": ("sgemm", lambda r: [_f(r, 60, 90), _f(r, 90, 70),
                                  _f(r, 60, 70)], {"alpha": 1.5,
                                                   "beta": 0.5}),
    "stencil2d": ("stencil2d", lambda r: [_f(r, 40, 72)], {"iters": 3}),
    "scan exclusive": ("scan", lambda r: [_i(r, 3000, 99),
                                          np.zeros(3000, np.int32)],
                       {"exclusive": 1}),
    "histogram": ("histogram", lambda r: [_i(r, 3500, 64),
                                          np.zeros(64, np.int32)],
                  {"nbins": 64}),
    "scan_histogram": ("scan_histogram",
                       lambda r: [_i(r, 3100, 64), np.zeros(3100, np.int32),
                                  np.zeros(64, np.int32)], {"nbins": 64}),
    "scan_histogram exclusive": ("scan_histogram",
                                 lambda r: [_i(r, 3100, 64),
                                            np.zeros(3100, np.int32),
                                            np.zeros(64, np.int32)],
                                 {"nbins": 64, "exclusive": 1}),
    "nbody": ("nbody", lambda r: _bodies(r, 200),
              {"dt": 1e-3, "eps": 1e-2, "steps": 1}),
}


@pytest.mark.parametrize("case", sorted(C_CASES))
def test_capi_route_matches_the_in_process_path(daemon, capi_rig, case):
    """Each C adapter with ``TPKT_SERVE_SOCKET``: the daemon serves it,
    and the driver's buffers end bit for bit as on the in-process
    path."""
    kernel, make, params = C_CASES[case]
    bufs = make(np.random.default_rng(2))
    local = _c_run(kernel, bufs, **params)
    capi_rig.setenv("TPKT_SERVE_SOCKET", daemon.sock)
    before = len(daemon.events("serve_request"))
    served = _c_run(kernel, bufs, **params)
    for a, b in zip(served, local):
        np.testing.assert_array_equal(a, b)
    mine = daemon.events("serve_request")[before:]
    assert mine and all(e["ok"] for e in mine)


def test_capi_route_falls_back_once_and_reports_daemon_errors(daemon,
                                                              capi_rig,
                                                              capsys,
                                                              tmp_path):
    from tpukernels_torch import capi

    capi._SERVE_WARNED.clear()
    capi_rig.setenv("TPKT_SERVE_SOCKET", str(tmp_path / "none.sock"))
    capi_rig.setenv("TPKT_CLIENT_RECONNECT_S", "0")
    x, y = _f(np.random.default_rng(4), 500), np.zeros(500, np.float32)
    for _ in range(2):
        out = _c_run("vector_add", [x, y], alpha=2.0)
        np.testing.assert_array_equal(out[1], np.float32(2.0) * x)
    assert capsys.readouterr().err.count("unusable") == 1
    # a dispatch error the daemon reports is raised, not retried here
    capi_rig.setenv("TPKT_SERVE_SOCKET", daemon.sock)
    bad = [np.ones((4, 5), np.float32), np.ones((6, 3), np.float32),
           np.ones((4, 3), np.float32)]
    with pytest.raises(client.ServeError):
        _c_run("sgemm", bad, alpha=1.0, beta=0.0)
    capi._SERVE_WARNED.clear()
