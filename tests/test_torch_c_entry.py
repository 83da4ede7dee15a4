"""The unchanged C drivers on the port, through the port's shim (CPU).

Builds ``csrc/tpkt_shim.c`` (``_build.build_shim``) and the drivers of
``c/`` (``_build.build_c_drivers``) into ``tmp_path``, then runs them
with ``--device=tpu`` and ``TPU_KERNELS_SHIM`` naming the port's shim:
``test_shim_abi``, every single-device row of ``c/run_all.sh`` with
``TPKT_CAPI_DEVICE=cpu`` (each must print the C program's own CHECK PASS),
a driver with no card and no CPU setting (it must exit non-zero), the
guard's injected corruption at site ``capi`` reaching the C program's own
check, ``fail_capi``, the profiler's traces in a C host, and the
shim's wedged-flush watchdog (the port of ``tests/test_shim_wedge.py``,
against a stub ``tpukernels_torch`` under ``TPKT_SHIM_ROOT``). Skips only
when ``gcc`` or ``python3-config --embed`` is missing.
"""

import json
import os
import re
import shutil
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest

from tpukernels_torch import _build
from tpukernels_torch.resilience import journal

ROOT = Path(__file__).resolve().parent.parent


def _run_all_rows():
    """The single-device ``run <driver> <args>`` rows of c/run_all.sh."""
    rows = []
    for line in (ROOT / "c" / "run_all.sh").read_text().splitlines():
        m = re.match(r"run (\w+) (.*?)\s*(#.*)?$", line)
        if m and m.group(1) != "allreduce_bench":
            rows.append((m.group(1), m.group(2).split()))
    return rows


ROWS = _run_all_rows()


def _key(driver, args):
    """The registry key a driver's row sends."""
    if driver == "stencil":
        return "stencil3d" if any(a.startswith("--z=") for a in args) \
            else "stencil2d"
    return driver


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    if not (shutil.which("gcc") or shutil.which("cc")):
        pytest.skip("no C compiler (gcc or cc) on PATH")
    try:
        _build.python_embed_flags()
    except RuntimeError as e:
        pytest.skip(f"python3-config --embed unavailable: {e}")
    d = tmp_path_factory.mktemp("c_entry")
    return _build.build_shim(d), _build.build_c_drivers(d / "cbin")


def _env(tmp_path, shim, **extra):
    env = dict(os.environ)
    for var in ("TPKT_FAULT_PLAN", "TPKT_INTEGRITY", "TPKT_MESH",
                "TPKT_PROFILE", "TPKT_SGEMM_PRECISION", "PYTHONPATH"):
        env.pop(var, None)
    env.update(TPU_KERNELS_SHIM=str(shim), TPKT_CAPI_DEVICE="cpu",
               TPKT_TRACE="1",
               TPKT_HEALTH_JOURNAL=str(tmp_path / "j.jsonl"),
               TPKT_INTEGRITY_DIR=str(tmp_path / "integ"),
               TPKT_TUNING_CACHE_DIR=str(tmp_path / "tuning"))
    env.update(extra)
    return {k: v for k, v in env.items() if v is not None}


def _drive(bin_dir, driver, args, env, timeout=300):
    return subprocess.run([str(bin_dir / driver), "--device=tpu", *args],
                          env=env, capture_output=True, text=True,
                          timeout=timeout, cwd=str(bin_dir))


def _events(tmp_path, kind):
    recs, _ = journal.load_events([tmp_path / "j.jsonl"])
    return [r for r in recs if r.get("kind") == kind]


def test_driver_compiler_has_openmp(monkeypatch, tmp_path):
    """A gcc without libgomp first on PATH is passed over for the
    drivers (they build with -fopenmp), not for the shim."""
    fake = tmp_path / "gcc"
    fake.write_text("#!/bin/sh\ncase \"$*\" in *-fopenmp*) exit 1;; esac\n"
                    "exit 0\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", f"{tmp_path}{os.pathsep}{os.environ['PATH']}")
    assert _build.c_compiler() == str(fake)
    picked = _build.c_compiler(openmp=True)
    assert picked != str(fake)
    assert subprocess.run([picked, "--version"],
                          capture_output=True).returncode == 0


def test_run_all_rows_found():
    assert [d for d, _ in ROWS] == [
        "vector_add", "sgemm", "sgemm", "sgemm", "stencil", "stencil",
        "stencil", "scan_histogram", "scan_histogram", "nbody"]


def test_shim_abi(built, tmp_path):
    shim, bin_dir = built
    p = subprocess.run([str(bin_dir / "test_shim_abi")],
                       env=_env(tmp_path, shim), capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "test_shim_abi: ALL PASS" in p.stdout


@pytest.mark.parametrize("driver,args", ROWS,
                         ids=[" ".join([d, *a]) for d, a in ROWS])
def test_run_all_row_passes_its_check(built, tmp_path, driver, args):
    shim, bin_dir = built
    p = _drive(bin_dir, driver, ["--check", "--reps=1", *args],
               _env(tmp_path, shim))
    assert p.returncode == 0, p.stdout + p.stderr
    assert f"kernel={driver} CHECK PASS" in p.stdout
    assert re.search(rf"kernel={driver} device=tpu .* time_ms=", p.stdout)
    key = _key(driver, args)
    names = [e["name"] for e in _events(tmp_path, "span")]
    # --check, the warm-up and one rep: three calls, each dispatched
    assert names.count(f"capi/{key}") == 3
    assert sum(n.startswith(f"capi/{key}/dispatch/") for n in names) >= 3
    assert {e["device"] for e in _events(tmp_path, "span")
            if e["name"] == f"capi/{key}"} == {"cpu"}
    (snap,) = _events(tmp_path, "metrics")
    assert snap["site"] == "capi.shutdown"
    assert snap["counters"][f"capi.calls.{key}"] == 3


def test_no_card_and_no_cpu_setting_exits_nonzero(built, tmp_path):
    shim, bin_dir = built
    env = _env(tmp_path, shim, TPKT_CAPI_DEVICE=None, CUDA_VISIBLE_DEVICES="")
    p = _drive(bin_dir, "vector_add", ["--check", "--reps=1", "--n=1000"],
               env)
    assert p.returncode != 0
    assert "CHECK PASS" not in p.stdout
    assert "no CUDA device" in p.stderr
    (err,) = _events(tmp_path, "capi_error")
    assert err["kernel"] == "vector_add"


def test_corrupt_output_at_capi_fails_the_drivers_check(built, tmp_path):
    shim, bin_dir = built
    plan = {"corrupt_output": {"kernel": "sgemm", "site": "capi"}}
    p = _drive(bin_dir, "sgemm", ["--check", "--reps=1", "--n=64"],
               _env(tmp_path, shim, TPKT_FAULT_PLAN=json.dumps(plan)))
    assert p.returncode != 0
    assert "kernel=sgemm CHECK FAIL (1/4096 mismatches" in p.stdout
    assert "output-integrity FAILED: sgemm at capi" in p.stderr
    failed = _events(tmp_path, "output_integrity_failed")
    assert [(e["site"], e["kernel"]) for e in failed] == [("capi", "sgemm")]


def test_fail_capi_exits_nonzero(built, tmp_path):
    shim, bin_dir = built
    p = _drive(bin_dir, "vector_add", ["--check", "--reps=1", "--n=1000"],
               _env(tmp_path, shim,
                    TPKT_FAULT_PLAN=json.dumps({"fail_capi": "vector_add"})))
    assert p.returncode != 0
    assert "injected fault: fail_capi vector_add" in p.stderr
    (err,) = _events(tmp_path, "capi_error")
    assert err["kernel"] == "vector_add"


def test_profiler_writes_a_trace_a_call_in_a_c_host(built, tmp_path):
    shim, bin_dir = built
    p = _drive(bin_dir, "vector_add", ["--check", "--reps=1", "--n=10000"],
               _env(tmp_path, shim, TPKT_PROFILE=str(tmp_path / "prof")))
    assert p.returncode == 0, p.stdout + p.stderr
    # the --check call, the warm-up and one rep
    traces = sorted((tmp_path / "prof").glob("capi_*_vector_add.json"))
    assert len(traces) == 3
    assert "traceEvents" in json.loads(traces[0].read_text())


# ------------------------------------------------------------------ #
# the wedged-flush watchdog (tests/test_shim_wedge.py, ported)       #
# ------------------------------------------------------------------ #

def _write_stub(tmp_path, shutdown_body: str, run_body: str = "return 0"):
    """A stand-in tpukernels_torch package the shim imports instead of
    the port (TPKT_SHIM_ROOT comes first on sys.path)."""
    pkg = tmp_path / "stub" / "tpukernels_torch"
    pkg.mkdir(parents=True)
    (pkg / "__init__.py").write_text("")
    (pkg / "capi.py").write_text(textwrap.dedent(f"""
        def run_from_c(kernel, params_json, addrs):
            {run_body}

        def shutdown_from_c():
            {shutdown_body}
            return 0
    """))
    return str(tmp_path / "stub")


def _python_host(tmp_path, shim, stub_root, timeout_s):
    """A Python host that loads the shim, inits and calls tpu_shutdown
    (ctypes releases the GIL around it: the worker-thread flush path)."""
    host = textwrap.dedent(f"""
        import ctypes
        lib = ctypes.CDLL({str(shim)!r})
        assert lib.tpu_init() == 0
        lib.tpu_shutdown()
        print("after-shutdown", flush=True)
    """)
    env = _env(tmp_path, shim, TPKT_SHIM_ROOT=stub_root,
               TPKT_FLUSH_TIMEOUT=str(timeout_s))
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-c", host], env=env,
                          capture_output=True, text=True, timeout=60,
                          cwd=str(tmp_path))
    return proc, time.monotonic() - t0


def test_wedged_flush_forces_exit(built, tmp_path):
    shim, _ = built
    stub = _write_stub(tmp_path, "import time; time.sleep(120)")
    proc, elapsed = _python_host(tmp_path, shim, stub, timeout_s=1)
    assert proc.returncode == 86, proc.stdout + proc.stderr
    assert "wedged" in proc.stderr
    assert "after-shutdown" not in proc.stdout
    assert elapsed < 30


def test_healthy_flush_exits_normally(built, tmp_path):
    shim, _ = built
    stub = _write_stub(tmp_path, "pass")
    proc, _ = _python_host(tmp_path, shim, stub, timeout_s=1)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "after-shutdown" in proc.stdout
    assert "wedged" not in proc.stderr


def test_wedged_flush_keeps_a_c_hosts_exit_status(built, tmp_path):
    """A C host flushes inline at exit; when that flush wedges the
    watchdog exits with the host's own status: here the C program's failed
    check (the stub computes nothing), never 0."""
    shim, bin_dir = built
    stub = _write_stub(tmp_path, "import time; time.sleep(120)")
    t0 = time.monotonic()
    p = _drive(bin_dir, "vector_add", ["--check", "--reps=1", "--n=100"],
               _env(tmp_path, shim, TPKT_SHIM_ROOT=stub,
                    TPKT_FLUSH_TIMEOUT="1"), timeout=60)
    assert p.returncode == 1, p.stdout + p.stderr
    assert "CHECK FAIL" in p.stdout and "wedged" in p.stderr
    assert time.monotonic() - t0 < 30
