"""The port's C entry (``tpukernels_torch.capi``) against the reference's
``tpukernels.capi`` on the CPU (``TPKT_CAPI_DEVICE=cpu``).

``run_from_c`` is called as the shim calls it: raw host pointers and a
JSON buffer description, the results written into the caller's buffers.
The same seeded numpy buffers and params go through both packages, each
on its own copies; the reference runs its Pallas kernels in interpret
mode, as ``tests/test_capi.py`` does. Tolerances are those of each
kernel's ``tests/test_torch_<kernel>.py``: bitwise for the Jacobi grids
and the int32 results, rtol 1e-6 / atol 1e-7 for SAXPY, rtol 1e-4 /
atol 1e-3 for SGEMM ``high``, rtol 1e-4 / atol 1e-2 for a float32 scan
and rtol 1e-3 / atol 2e-4 for N-body. Then the port's own contract: the
errors, the ``allreduce`` adapter at one rank, a ``TPKT_MESH`` above the
process group (the mesh rows themselves run as two driver processes in
``tests/test_torch_capi_mesh.py``), the guard at site
``capi`` over the caller's buffers, the ``fail_capi``/``wedge_capi``
faults, the device rule, the span, the counters and the profiler. Every
state path of both packages lies in ``tmp_path``.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from tpukernels import capi as ref_capi
from tpukernels.resilience import faults as ref_faults
from tpukernels.resilience import integrity as ref_integrity
from tpukernels_torch import capi
from tpukernels_torch.obs import metrics, trace
from tpukernels_torch.resilience import faults, integrity, journal

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPE_NAMES = {np.dtype(np.float32): "f32", np.dtype(np.int32): "i32"}


@pytest.fixture
def rig(monkeypatch, tmp_path):
    """Both packages' state in ``tmp_path``, no fault plan, the port's
    C entry on the CPU."""
    monkeypatch.setenv("TPKT_CAPI_DEVICE", "cpu")
    monkeypatch.setenv("TPKT_INTEGRITY_DIR", str(tmp_path / "tpkt_integ"))
    monkeypatch.setenv("TPKT_HEALTH_JOURNAL", str(tmp_path / "tpkt.jsonl"))
    monkeypatch.setenv("TPKT_TUNING_CACHE_DIR", str(tmp_path / "tuning"))
    monkeypatch.setenv("TPK_INTEGRITY_DIR", str(tmp_path / "tpk_integ"))
    monkeypatch.setenv("TPK_HEALTH_JOURNAL", str(tmp_path / "tpk.jsonl"))
    monkeypatch.setenv("TPK_AOT_CACHE", "0")
    for var in ("TPKT_FAULT_PLAN", "TPK_FAULT_PLAN", "TPKT_INTEGRITY",
                "TPKT_INTEGRITY_SAMPLE", "TPKT_MESH", "TPK_MESH",
                "TPKT_PROFILE", "TPU_KERNELS_PROFILE", "TPKT_TRACE",
                "TPKT_SGEMM_PRECISION", "TPK_SERVE_SOCKET",
                "TPKT_SERVE_SOCKET"):
        monkeypatch.delenv(var, raising=False)
    _reload()
    metrics.reset()
    yield tmp_path
    # module state outlives monkeypatch's restore of the env
    for var in ("TPKT_FAULT_PLAN", "TPK_FAULT_PLAN", "TPKT_TRACE"):
        monkeypatch.delenv(var, raising=False)
    _reload()


def _reload():
    faults.reload_plan()
    ref_faults.reload_plan()
    integrity.reset()
    ref_integrity.reset()
    trace.reload()


def _set_plan(monkeypatch, plan):
    monkeypatch.setenv("TPKT_FAULT_PLAN", json.dumps(plan))
    faults.reload_plan()


def _events(tmp_path, kind):
    recs, _ = journal.load_events([tmp_path / "tpkt.jsonl"])
    return [r for r in recs if r.get("kind") == kind]


def _params(bufs, **scalars):
    return json.dumps({**scalars, "buffers": [
        {"shape": list(b.shape), "dtype": DTYPE_NAMES[b.dtype]}
        for b in bufs]})


def _run(mod, kernel, bufs, **scalars):
    """``mod.run_from_c`` on copies of ``bufs``; returns the copies."""
    bufs = [np.ascontiguousarray(b).copy() for b in bufs]
    assert mod.run_from_c(kernel, _params(bufs, **scalars),
                          [b.ctypes.data for b in bufs]) == 0
    return bufs


def _f32(rng, *shape):
    return rng.standard_normal(shape, dtype=np.float32)


def _bins(rng, n, nbins):
    return rng.integers(0, nbins, n).astype(np.int32)


def _nbody_state(rng, n):
    pos = [rng.uniform(-1, 1, n).astype(np.float32) for _ in range(3)]
    vel = [0.1 * rng.uniform(-1, 1, n).astype(np.float32) for _ in range(3)]
    return [*pos, *vel, rng.uniform(0.5, 1.5, n).astype(np.float32)]


# (kernel, buffers from a seeded rng, params, (rtol, atol) or None for
# bitwise): every single-device adapter, scan both ways in both dtypes
CASES = {
    "vector_add": ("vector_add", lambda r: [_f32(r, 1003), _f32(r, 1003)],
                   {"alpha": 2.5}, (1e-6, 1e-7)),
    "sgemm": ("sgemm", lambda r: [_f32(r, 64, 96), _f32(r, 96, 80),
                                  _f32(r, 64, 80)],
              {"alpha": 1.5, "beta": 0.5}, (1e-4, 1e-3)),
    "stencil2d": ("stencil2d", lambda r: [_f32(r, 40, 72)], {"iters": 5},
                  None),
    "stencil3d": ("stencil3d", lambda r: [_f32(r, 12, 16, 20)],
                  {"iters": 3}, None),
    "scan_i32": ("scan", lambda r: [_bins(r, 5000, 64),
                                    np.zeros(5000, np.int32)], {}, None),
    "scan_exclusive_i32": ("scan", lambda r: [_bins(r, 5000, 64),
                                              np.zeros(5000, np.int32)],
                           {"exclusive": True}, None),
    "scan_f32": ("scan", lambda r: [_f32(r, 4096),
                                    np.zeros(4096, np.float32)], {},
                 (1e-4, 1e-2)),
    "scan_exclusive_f32": ("scan", lambda r: [_f32(r, 4096),
                                              np.zeros(4096, np.float32)],
                           {"exclusive": True}, (1e-4, 1e-2)),
    "histogram": ("histogram", lambda r: [_bins(r, 5000, 64),
                                          np.zeros(64, np.int32)],
                  {"nbins": 64}, None),
    "scan_histogram": ("scan_histogram",
                       lambda r: [_bins(r, 3000, 32),
                                  np.zeros(3000, np.int32),
                                  np.zeros(32, np.int32)],
                       {"nbins": 32}, None),
    "scan_histogram_exclusive": ("scan_histogram",
                                 lambda r: [_bins(r, 3000, 32),
                                            np.zeros(3000, np.int32),
                                            np.zeros(32, np.int32)],
                                 {"nbins": 32, "exclusive": True}, None),
    "nbody_2_steps": ("nbody", lambda r: _nbody_state(r, 256),
                      {"dt": 1e-3, "eps": 1e-2, "steps": 2}, (1e-3, 2e-4)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_from_c_matches_reference(rig, case):
    kernel, make, scalars, tol = CASES[case]
    bufs = make(np.random.default_rng(11))
    want = _run(ref_capi, kernel, bufs, **scalars)
    got = _run(capi, kernel, bufs, **scalars)
    for i, (g, w, orig) in enumerate(zip(got, want, bufs)):
        assert g.dtype == w.dtype and g.shape == w.shape
        if tol is None:
            np.testing.assert_array_equal(g, w, err_msg=f"buffer {i}")
        else:
            np.testing.assert_allclose(g, w, rtol=tol[0], atol=tol[1],
                                       err_msg=f"buffer {i}")
        if i not in capi._OUTPUT_BUFFERS[kernel]:  # inputs stay as given
            np.testing.assert_array_equal(g, orig)
    assert metrics.counter(f"capi.calls.{kernel}") == 1
    assert metrics.snapshot()["histograms"][f"capi.wall_s.{kernel}"][
        "count"] == 1


def test_output_buffers_match_reference():
    assert capi._OUTPUT_BUFFERS == ref_capi._OUTPUT_BUFFERS
    assert set(capi._ADAPTERS) == set(ref_capi._ADAPTERS)


# ------------------------------------------------------------------ #
# the error contract (tests/test_capi.py)                            #
# ------------------------------------------------------------------ #

def test_buffer_count_mismatch_raises(rig):
    x = np.zeros(8, dtype=np.float32)
    params = json.dumps({"buffers": [{"shape": [8], "dtype": "f32"}]})
    with pytest.raises(ValueError, match="pointers but"):
        capi.run_from_c("vector_add", params, [x.ctypes.data] * 2)


def test_unknown_kernel_raises(rig):
    with pytest.raises(KeyError, match="no C adapter"):
        capi.run_from_c("not_a_kernel", json.dumps({"buffers": []}), [])


def test_unknown_dtype_raises(rig):
    x = np.zeros(8, dtype=np.float64)
    params = json.dumps({"buffers": [{"shape": [8], "dtype": "f64"}] * 2})
    with pytest.raises(ValueError, match="unsupported buffer dtype"):
        capi.run_from_c("vector_add", params, [x.ctypes.data] * 2)


def test_allreduce_waits_for_the_distributed_slice(rig, monkeypatch):
    # the slice came: without a process group the adapter is one rank,
    # and out is x; the reference's, pinned to one device (TPK_MESH=1;
    # unset it spans this process's fake CPU devices), gives the same
    for var in ("TPKT_COORDINATOR_ADDRESS", "TPKT_BUSBW_SWEEP",
                "TPK_BUSBW_SWEEP"):
        monkeypatch.delenv(var, raising=False)
    x = np.random.default_rng(0).uniform(0.5, 1.5, 1000).astype(np.float32)
    got = _run(capi, "allreduce", [x, np.zeros_like(x)])
    assert metrics.counter("capi.calls.allreduce") == 1
    np.testing.assert_array_equal(got[0], x)
    np.testing.assert_array_equal(got[1], x)
    monkeypatch.setenv("TPK_MESH", "1")
    monkeypatch.setenv("TPKT_MESH", "1")
    want = _run(ref_capi, "allreduce", [x, np.zeros_like(x)])
    np.testing.assert_array_equal(want[1], x)
    np.testing.assert_array_equal(
        _run(capi, "allreduce", [x, np.zeros_like(x)])[1], want[1])


@pytest.mark.parametrize("case", ["stencil2d", "scan_i32", "histogram",
                                  "scan_histogram", "nbody_2_steps"])
def test_mesh_above_one_raises(rig, monkeypatch, case):
    # above the process group's size: here no group, one rank
    kernel, make, scalars, _ = CASES[case]
    monkeypatch.delenv("TPKT_COORDINATOR_ADDRESS", raising=False)
    monkeypatch.setenv("TPKT_MESH", "2")
    with pytest.raises(RuntimeError,
                       match="TPKT_MESH=2 but the process group has 1"):
        _run(capi, kernel, make(np.random.default_rng(0)), **scalars)
    assert metrics.counter(f"capi.errors.{kernel}") == 1
    monkeypatch.setenv("TPKT_MESH", "0")
    with pytest.raises(ValueError, match="must be >= 1"):
        _run(capi, kernel, make(np.random.default_rng(0)), **scalars)


# ------------------------------------------------------------------ #
# the guard at site capi, over the caller's buffers                  #
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("fault,case,tier", [
    ("corrupt_output", "sgemm", 3),
    ("nan_output", "stencil2d", 1),
    ("corrupt_output", "histogram", 3),
])
def test_output_fault_at_capi_reaches_the_callers_buffer(rig, monkeypatch,
                                                         fault, case, tier):
    kernel, make, scalars, _ = CASES[case]
    bufs = make(np.random.default_rng(3))
    clean = _run(capi, kernel, bufs, **scalars)
    integrity.reset()
    _set_plan(monkeypatch, {fault: {"kernel": kernel, "site": "capi"}})
    got = _run(capi, kernel, bufs, **scalars)
    out = capi._OUTPUT_BUFFERS[kernel][0]
    first = got[out].reshape(-1)[0]
    if fault == "nan_output":
        assert np.isnan(first)
    else:
        assert first != clean[out].reshape(-1)[0]
    # only the first element was touched
    np.testing.assert_array_equal(got[out].reshape(-1)[1:],
                                  clean[out].reshape(-1)[1:])
    failed = _events(rig, "output_integrity_failed")
    assert [(e["site"], e["kernel"], e["tier"]) for e in failed] == [
        ("capi", kernel, tier)]
    injected = _events(rig, "fault_injected")
    assert injected and all(e["site"] == "output:capi" for e in injected)


def test_fail_capi_raises_and_journals(rig, monkeypatch):
    _set_plan(monkeypatch, {"fail_capi": "vector_add"})
    kernel, make, scalars, _ = CASES["vector_add"]
    with pytest.raises(RuntimeError, match="injected fault: fail_capi"):
        _run(capi, kernel, make(np.random.default_rng(0)), **scalars)
    (inj,) = _events(rig, "fault_injected")
    assert (inj["site"], inj["kernel"], inj["fault"]) == (
        "capi", "vector_add", "fail_capi")
    (err,) = _events(rig, "capi_error")
    assert err["kernel"] == "vector_add" and "fail_capi" in err["error"]
    assert metrics.counter("capi.errors.vector_add") == 1
    assert metrics.counter("capi.calls.vector_add") == 0
    # another kernel is untouched by the plan
    kernel, make, scalars, _ = CASES["scan_i32"]
    _run(capi, kernel, make(np.random.default_rng(0)), **scalars)


def test_wedge_capi_hangs(tmp_path):
    """``wedge_capi`` hangs the call, immune to SIGALRM; the child is
    killed once it says so."""
    body = textwrap.dedent("""
        import json, numpy as np
        from tpukernels_torch import capi
        x = np.zeros(4, np.float32)
        p = json.dumps({"buffers": [{"shape": [4], "dtype": "f32"}] * 2})
        capi.run_from_c("vector_add", p, [x.ctypes.data] * 2)
        print("returned", flush=True)
    """)
    env = dict(os.environ, PYTHONPATH=ROOT, TPKT_CAPI_DEVICE="cpu",
               TPKT_FAULT_PLAN=json.dumps({"wedge_capi": "vector_add"}),
               TPKT_HEALTH_JOURNAL=str(tmp_path / "j.jsonl"),
               TPKT_INTEGRITY_DIR=str(tmp_path))
    proc = subprocess.Popen([sys.executable, "-c", body], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        line = proc.stderr.readline()
        assert "wedging (wedge_capi vector_add)" in line, line
        with pytest.raises(subprocess.TimeoutExpired):
            proc.wait(timeout=2)
    finally:
        proc.kill()
        out, _ = proc.communicate(timeout=30)
    assert "returned" not in out
    recs, _ = journal.load_events([tmp_path / "j.jsonl"])
    assert [(r["site"], r["fault"]) for r in recs
            if r["kind"] == "fault_injected"] == [("capi", "wedge_capi")]


# ------------------------------------------------------------------ #
# the device rule, the span, the counters, the profiler              #
# ------------------------------------------------------------------ #

def test_no_card_and_no_cpu_setting_raises(rig, monkeypatch):
    monkeypatch.delenv("TPKT_CAPI_DEVICE")
    monkeypatch.setattr(capi, "_DEVICES", {})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kernel, make, scalars, _ = CASES["vector_add"]
    bufs = make(np.random.default_rng(0))
    before = [b.copy() for b in bufs]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        assert capi.run_from_c(kernel, _params(bufs, **scalars),
                               [b.ctypes.data for b in bufs])
    for b, b0 in zip(bufs, before):  # nothing ran on the CPU instead
        np.testing.assert_array_equal(b, b0)
    (err,) = _events(rig, "capi_error")
    assert "no CUDA device" in err["error"]


def test_span_names_the_device_and_nests_dispatch(rig, monkeypatch):
    monkeypatch.setenv("TPKT_TRACE", "1")
    trace.reload()
    kernel, make, scalars, _ = CASES["scan_histogram"]
    _run(capi, kernel, make(np.random.default_rng(0)), **scalars)
    spans = {e["name"]: e for e in _events(rig, "span")}
    assert spans["capi/scan_histogram"]["device"] == "cpu"
    assert spans["capi/scan_histogram"]["ok"] is True
    assert "capi/scan_histogram/dispatch/scan_histogram" in spans
    # the capi site's first-trust canary runs after the span closed
    assert spans["integrity/canary/scan_histogram"]["site"] == "capi"


LEAVE_AT_SHUTDOWN = """
import torch.distributed as dist
from tpukernels_torch import capi
from tpukernels_torch.parallel import make_mesh
from tpukernels_torch.parallel import mesh as M
mesh = make_mesh(device="cpu")
assert dist.is_initialized() and mesh.size == 1 and mesh.group is not None
assert capi.shutdown_from_c() == 0
# the mesh let go of its group: marked left, never None (None is the
# default group, which a later join would make another one)
assert not dist.is_initialized() and mesh.group is M.LEFT
assert capi.shutdown_from_c() == 0  # nothing left to leave
print("left")
"""


def test_shutdown_leaves_the_process_group(tmp_path):
    """A C host never runs the interpreter's exit hooks, so the shim's
    exit flush is where its rank leaves the group."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPK_", "TPKT_"))}
    env.update(PYTHONPATH=str(ROOT), TPKT_NUM_PROCESSES="1",
               TPKT_PROCESS_ID="0",
               TPKT_COORDINATOR_ADDRESS=f"file://{tmp_path / 'rdv'}")
    p = subprocess.run([sys.executable, "-c", LEAVE_AT_SHUTDOWN], env=env,
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "left"


def test_shutdown_emits_the_metrics_snapshot(rig, monkeypatch):
    kernel, make, scalars, _ = CASES["vector_add"]
    _run(capi, kernel, make(np.random.default_rng(0)), **scalars)
    assert capi.shutdown_from_c() == 0
    (snap,) = _events(rig, "metrics")
    assert snap["site"] == "capi.shutdown"
    assert snap["counters"]["capi.calls.vector_add"] == 1
    assert snap["histograms"]["capi.wall_s.vector_add"]["count"] == 1
    # journaling off, or nothing recorded: no event and no file
    monkeypatch.setenv("TPKT_HEALTH_JOURNAL", "off")
    metrics.emit_snapshot(site="x")
    metrics.reset()
    monkeypatch.setenv("TPKT_HEALTH_JOURNAL", str(rig / "empty.jsonl"))
    metrics.emit_snapshot(site="x")
    assert not (rig / "empty.jsonl").exists()


def test_profiler_writes_one_trace_a_call(rig, monkeypatch):
    monkeypatch.setenv("TPKT_PROFILE", str(rig / "prof"))
    kernel, make, scalars, _ = CASES["vector_add"]
    for _ in range(2):
        _run(capi, kernel, make(np.random.default_rng(0)), **scalars)
    traces = sorted((rig / "prof").glob("capi_*_vector_add.json"))
    assert len(traces) == 2
    assert "traceEvents" in json.loads(traces[0].read_text())
    monkeypatch.delenv("TPKT_PROFILE")
    _run(capi, kernel, make(np.random.default_rng(0)), **scalars)
    assert len(list((rig / "prof").iterdir())) == 2
