"""``python -m tpukernels_torch.cgate --fuzz`` on the CPU: the port's copy
of ``tools/fuzz_c.sh`` through the port's shim.

- The ranges parsed from ``tools/fuzz_c.sh`` are the reference's six
  drivers and extents; a seed reproduces its draws, which stay in them.
- One round at seed 42 passes on the CPU (``TPKT_CAPI_DEVICE=cpu``):
  every draw at ``--device=omp`` and through the port's shim, the shim
  and the drivers built into ``tmp_path``; at full extents.
- An injected corruption of the C output (the guard's ``corrupt_output``
  at site ``capi``) fails the driver's own check: the fuzz prints
  ``FUZZ FAIL`` with a replay command that fails again, and exits 1.
- A C host adds its kernel launches to its exit ``metrics`` event.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from tpukernels_torch import _build, cgate
from tpukernels_torch.resilience import journal

ROOT = Path(__file__).resolve().parent.parent

# tools/fuzz_c.sh's round: each flag drawn uniform in 1..n, plus add
REFERENCE_RANGES = [
    ("vector_add", [("n", 200000, 0)]),
    ("sgemm", [("m", 317, 0), ("n", 317, 0), ("k", 413, 0)]),
    ("stencil", [("n", 200, 2), ("m", 200, 2), ("iters", 8, 0)]),
    ("stencil", [("n", 40, 2), ("m", 60, 2), ("z", 40, 2), ("iters", 5, 0)]),
    ("scan_histogram", [("n", 100000, 0), ("nbins", 300, 0)]),
    ("nbody", [("n", 400, 0), ("iters", 3, 0)]),
]


def test_the_ranges_are_the_references():
    assert cgate.fuzz_ranges() == REFERENCE_RANGES
    assert {d for d, _ in REFERENCE_RANGES} <= set(_build.C_DRIVERS)


@pytest.mark.parametrize("seed", [42, 0, 7])
def test_a_seed_reproduces_its_draws(seed):
    draws = cgate.fuzz_draws(3, seed)
    assert draws == cgate.fuzz_draws(3, seed)
    assert draws != cgate.fuzz_draws(3, seed + 1)
    assert [d for d, _ in draws] == [d for d, _ in REFERENCE_RANGES] * 3
    for i, (driver, argv) in enumerate(draws):
        ranges = REFERENCE_RANGES[i % len(REFERENCE_RANGES)][1]
        assert [a.split("=")[0] for a in argv] == [f"--{f}" for f, _, _ in
                                                   ranges]
        for a, (_f, n, add) in zip(argv, ranges):
            assert 1 + add <= int(a.split("=")[1]) <= n + add, (driver, a)


def test_the_seed_comes_from_its_knob(monkeypatch):
    monkeypatch.delenv("TPKT_FUZZ_SEED", raising=False)
    assert cgate.fuzz_seed() == 42
    monkeypatch.setenv("TPKT_FUZZ_SEED", "9")
    assert cgate.fuzz_seed() == 9


@pytest.mark.parametrize("argv", [["--fuzz", "0"], ["--fuzz", "x"],
                                  ["--fuzz", "1", "2"]])
def test_bad_rounds_are_a_usage_error(argv, capsys):
    assert cgate.main(argv) == 64
    assert "--fuzz takes one ROUNDS >= 1" in capsys.readouterr().err


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    if not (shutil.which("gcc") or shutil.which("cc")):
        pytest.skip("no C compiler (gcc or cc) on PATH")
    try:
        _build.python_embed_flags()
    except RuntimeError as e:
        pytest.skip(f"python3-config --embed unavailable: {e}")
    d = tmp_path_factory.mktemp("cfuzz")
    return _build.build_shim(d), _build.build_c_drivers(d / "cbin")


@pytest.fixture
def fuzz_env(built, tmp_path, monkeypatch):
    """The CLI's builds are the module's; the C hosts run the port on the
    CPU with their state and journal in ``tmp_path``."""
    shim, cbin = built
    monkeypatch.setattr(cgate._build, "build_shim", lambda *a, **k: shim)
    monkeypatch.setattr(cgate._build, "build_c_drivers",
                        lambda *a, **k: cbin)
    for var in list(os.environ):
        if var.startswith(("TPKT_", "TPK_")) or var == "PYTHONPATH":
            monkeypatch.delenv(var)
    monkeypatch.setenv("TPKT_CAPI_DEVICE", "cpu")
    monkeypatch.setenv("TPKT_HEALTH_JOURNAL", str(tmp_path / "j.jsonl"))
    for var in ("TPKT_INTEGRITY_DIR", "TPKT_AOT_DIR",
                "TPKT_TUNING_CACHE_DIR"):
        monkeypatch.setenv(var, str(tmp_path / "state"))
    return shim, cbin


def test_one_round_passes_on_the_cpu(fuzz_env, capsys):
    assert cgate.main(["--fuzz", "1"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == "FUZZ: PASS (1 rounds x 6 drivers x 2 devices, seed 42)"
    rows = [ln for ln in out if ln.startswith("fuzz round ")]
    want = [f"fuzz round 1/1: bin/{d} {' '.join(a)} --device={dev}: rc 0, "
            for d, a in cgate.fuzz_draws(1, 42) for dev in ("omp", "tpu")]
    assert [r[:len(w)] for r, w in zip(rows, want)] == want
    assert len(rows) == 12 and not [ln for ln in out if "FUZZ FAIL" in ln]
    # one C host a tpu row, each journaling its exit metrics
    events, _ = journal.load_events([os.environ["TPKT_HEALTH_JOURNAL"]])
    assert [e["site"] for e in events if e["kind"] == "metrics"] == \
        ["capi.shutdown"] * 6


def test_a_corrupted_c_output_fails_the_fuzz(fuzz_env, monkeypatch, capsys):
    shim, cbin = fuzz_env
    one = REFERENCE_RANGES[:1]
    monkeypatch.setattr(cgate, "fuzz_ranges", lambda: one)
    monkeypatch.setenv("TPKT_FAULT_PLAN", json.dumps(
        {"corrupt_output": {"kernel": "vector_add", "site": "capi"}}))
    assert cgate.main(["--fuzz", "1"]) == 1
    out = capsys.readouterr().out
    lines = out.splitlines()
    assert lines[-1] == "FUZZ: FAIL"
    # the omp row exercises no port code and passes
    assert ": rc 0, " in lines[0] and "--device=omp" in lines[0]
    (fail,) = [ln for ln in lines if ln.startswith("FUZZ FAIL: ")]
    (_d, argv), = cgate.fuzz_draws(1, 42, one)
    assert fail.startswith(f"FUZZ FAIL: TPU_KERNELS_SHIM={shim} "
                           "TPKT_CAPI_DEVICE=cpu TPKT_FAULT_PLAN=")
    assert fail.endswith(f"{cbin / 'vector_add'} {' '.join(argv)} "
                         "--device=tpu --check --reps=1")
    assert "CHECK FAIL" in out  # the driver's own output
    # the replay command fails again, as printed
    replay = subprocess.run(["bash", "-c", fail[len("FUZZ FAIL: "):]],
                            capture_output=True, text=True, timeout=300,
                            env=dict(os.environ))
    assert replay.returncode != 0 and "CHECK FAIL" in replay.stdout


LAUNCH_AT_SHUTDOWN = """
import os
from tpukernels_torch import capi, kernels
kernels.count_launch("saxpy")
kernels.count_launch("saxpy")
capi.shutdown_from_c()
kernels.count_launch("scan")
capi.shutdown_from_c()
os._exit(0)  # a C host never runs the interpreter's exit hooks
"""


def test_a_c_host_publishes_its_launches_at_shutdown(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPKT_", "TPK_"))}
    env.update(PYTHONPATH=str(ROOT),
               TPKT_HEALTH_JOURNAL=str(tmp_path / "j.jsonl"))
    p = subprocess.run([sys.executable, "-c", LAUNCH_AT_SHUTDOWN], env=env,
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    events, _ = journal.load_events([str(tmp_path / "j.jsonl")])
    got = [{k: v for k, v in e["counters"].items()
            if k.startswith("kernel.launches.")}
           for e in events if e["kind"] == "metrics"]
    # each snapshot holds the process's launches so far, each counted once
    assert got == [{"kernel.launches.saxpy": 2},
                   {"kernel.launches.saxpy": 2, "kernel.launches.scan": 1}]
