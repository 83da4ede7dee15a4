"""Machine checks of the port's ground rules.

- The port (``tpukernels_torch`` and ``chip_smoke.py``) imports no JAX
  and nothing of the JAX package.
- Entry points that allocate run on the card unless the caller asks for
  the CPU, and raise when there is no card.
- Every Pallas kernel of the reference has a row in the port's kernel
  table, ported or pending, and every row names a Pallas kernel.
- Pending registry keys raise KeyError.
- The port's knobs use the ``TPKT_`` prefix, never ``TPK_``.
- The C entry (``capi.py`` and the shim) names no module of the JAX
  package and no JAX, and every knob it reads starts with ``TPKT_``.
- The serving fleet's router, WAL, health manager, guardian, layout and
  ctl import no torch, and every knob they read starts with ``TPKT_``.
- The compile discipline (``aot``, ``prewarm``) and the device inventory
  (``obs/scaling``) import no torch when they are imported.
- The rest of the distributed layer (``parallel/overlap``,
  ``parallel/weak_scaling``, ``dryrun``, ``obs/scaling``'s artifacts and
  ``registry.dispatch_mesh``) names no JAX and nothing of the JAX
  package and reads only ``TPKT_`` knobs; the artifacts' analyzers run
  without loading torch.
- The serving control loop (``loadgen``, ``obs/slo``, ``obs/reqtrace``,
  ``serve/adapt``, ``serve/optimize``, ``resilience/canary``) reads only
  ``TPKT_`` knobs, and ``loadgen --simulate``, ``loadgen --serve`` and
  ``serve.optimize propose`` run without loading torch.
- The fleet's operations layer (``obs/rollup``, ``obs/trend``,
  ``obs/report``, ``obs/trace_report``, ``serve/top``, ``serve/chaos``)
  names no JAX, nothing of the JAX package and no torch, reads only
  ``TPKT_`` knobs (``TPKT_ROLLUP_DIR`` and ``TPKT_ADAPT_WINDOW_DAYS``
  among them), and its CLIs run without loading torch.
- The revalidation supervisor (``resilience/supervisor``, ``revalidate``,
  ``obs/health_report``) and the C gate its steps run (``cgate``) name
  no JAX and nothing of the JAX package, read only ``TPKT_`` knobs, and
  the first three import no torch; its state is a ``_cachedir`` state
  directory under the gitignored ``.tpkt_cache``.
- The bench and the tuning loop (``bench``, ``tuning/runner``,
  ``autotune``, ``sgemm_tune``) name no JAX and nothing of the JAX
  package, read only ``TPKT_`` knobs, spawn the port's bench, and the
  tuning CLI imports no torch.
"""

import ast
import contextlib
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from tpukernels_torch import _build, registry
from tpukernels_torch.kernels import TPU_KERNELS
from tpukernels_torch.utils import pick_device

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "tpukernels_torch"
CHIP_SMOKE = ROOT / "chip_smoke.py"


def _port_modules():
    mods = []
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts.pop()
        mods.append(".".join(parts))
    return mods


def _port_files():
    return [p for p in sorted(PORT.rglob("*"))
            if p.suffix in (".py", ".cu", ".cuh", ".c", ".h")
            and "_build" not in p.parts]


# the C entry: the module the shim imports, and the shim
C_ENTRY = (PORT / "capi.py", PORT / "csrc" / "tpkt_shim.c",
           PORT / "csrc" / "tpkt_shim.h")


def test_port_imports_no_jax_and_no_reference():
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'tpukernels'))\n"
        "print(','.join(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, env=env, timeout=120)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == ""


def test_package_import_is_lazy():
    code = ("import sys, tpukernels_torch\n"
            "print(sorted(m for m in sys.modules "
            "if m.startswith('tpukernels_torch.')))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, timeout=120)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"


def test_chip_smoke_imports_no_jax_and_no_reference():
    src = CHIP_SMOKE.read_text()
    assert not re.search(r"\btpukernels\b(?!_torch)", src)
    assert not re.search(r"^\s*(import|from)\s+jax", src, re.M)
    assert "import jax" not in src


@pytest.mark.parametrize("path", C_ENTRY, ids=lambda p: p.name)
def test_c_entry_names_no_jax_and_no_reference_module(path):
    src = path.read_text()
    assert not re.search(r"\btpukernels\.", src), path
    assert not re.search(r"\bjax", src, re.I), path
    # the shim imports the port's C entry and nothing else
    imported = re.findall(r"PyImport_ImportModule\((\w+|\"[^\"]*\")\)", src)
    assert all(m == "CAPI_MODULE" for m in imported), imported
    if path.suffix == ".c":
        assert '#define CAPI_MODULE "tpukernels_torch.capi"' in src


@pytest.mark.parametrize("path", C_ENTRY, ids=lambda p: p.name)
def test_c_entry_knobs_use_the_port_prefix(path):
    src = path.read_text()
    read = re.findall(r"getenv\(\"(\w+)\"\)", src) + re.findall(
        r"environ\.get\(\"(\w+)\"", src)
    assert all(k.startswith("TPKT_") for k in read), read
    assert path.suffix == ".h" or read


def test_no_tpk_knob_prefix_in_port():
    for p in _port_files() + [CHIP_SMOKE]:
        assert not re.search(r"\bTPK_", p.read_text()), p


def test_distributed_layer_is_under_the_rules():
    # the distributed layer is among the modules the no-JAX rule
    # imports and the files the knob rule reads, and every knob it
    # reads starts with TPKT_
    parallel = {"tpukernels_torch.parallel", "tpukernels_torch.parallel.mesh",
                "tpukernels_torch.parallel.collectives",
                "tpukernels_torch.parallel.busbw"}
    assert parallel <= set(_port_modules())
    files = [p for p in _port_files() if "parallel" in p.parts]
    assert {p.name for p in files} == {"__init__.py", "mesh.py",
                                       "collectives.py", "busbw.py",
                                       "overlap.py", "weak_scaling.py"}
    read = []
    for p in files + [PORT / "capi.py"]:
        src = p.read_text()
        read += re.findall(r"environ(?:\.get)?\(\s*\"(\w+)\"", src)
        read += re.findall(r"environ\[\"(\w+)\"\]", src)
        read += re.findall(r"\"(\w+)\" in os\.environ", src)
    assert read and all(k.startswith("TPKT_") for k in read), read
    assert {"TPKT_COORDINATOR_ADDRESS", "TPKT_DIST_DEPTH", "TPKT_MESH",
            "TPKT_NBODY_DIST", "TPKT_BUSBW_SWEEP"} <= set(read)


# the rest of the distributed layer: the overlap probe, the weak sweep,
# the dry run, the scaling artifacts and the mesh dispatch
SCALING_LAYER = ("tpukernels_torch.parallel.overlap",
                 "tpukernels_torch.parallel.weak_scaling",
                 "tpukernels_torch.dryrun", "tpukernels_torch.obs.scaling",
                 "tpukernels_torch._cachedir", "tpukernels_torch.registry")


def test_scaling_layer_is_under_the_rules():
    # each module is among those the no-JAX rule imports; none names JAX
    # or the JAX package (not even its stdlib-only obs/scaling.py), and
    # every knob it reads starts with TPKT_ (or is CUDA's own)
    assert set(SCALING_LAYER) <= set(_port_modules())
    read = []
    for m in SCALING_LAYER:
        src = (ROOT / (m.replace(".", "/") + ".py")).read_text()
        assert not re.search(r"^\s*(import|from)\s+(jax|tpukernels\b(?!_))",
                             src, re.M), m
        assert not re.search(r"\btpukernels\.(?!_torch)", src.replace(
            "``tpukernels/", "")), m
        read += re.findall(r"environ(?:\.get)?\(\s*\"(\w+)\"", src)
        read += re.findall(r"environ\[\"(\w+)\"\]", src)
        read += re.findall(r"target\.get\(\"(\w+)\"", src)
        read += re.findall(r"_state_dir\(\"(\w+)\"", src)
        read += re.findall(r"_fraction_knob\(\"(\w+)\"", src)
    # the inventory's env fallback reads CUDA_VISIBLE_DEVICES
    assert read and all(k.startswith(("TPKT_", "CUDA_")) for k in read), read
    assert {"TPKT_SCALING_DIR", "TPKT_SCALING_MIN_EFF",
            "TPKT_OVERLAP_MIN_FRAC", "TPKT_DRYRUN_TIMEOUT",
            "TPKT_MULTICHIP_ARTIFACT"} <= set(read)


def test_scaling_artifacts_import_no_torch():
    """The artifacts' readers and writers stay standard library at
    import, as the reference's are, so a report reads them without
    torch."""
    code = ("import sys\n"
            "from tpukernels_torch.obs import scaling\n"
            "scaling.analyze_repo(sys.argv[1])\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'tpukernels')))\n")
    p = subprocess.run([sys.executable, "-c", code, str(ROOT / "no-such")],
                       capture_output=True, text=True, cwd=ROOT, timeout=120,
                       env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"


def test_pick_device_never_falls_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pick_device()
    with pytest.raises(RuntimeError):
        pick_device("cuda")
    assert pick_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        pick_device("meta")


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()


def test_library_path_keys_on_sources():
    paths = [_build.library_path(n) for n in _build.SOURCES]
    assert len(set(paths)) == len(paths)
    for n, p in zip(_build.SOURCES, paths):
        assert p.parent == _build.BUILD_DIR and p.name.startswith(n + "-")
        assert (_build.CSRC / f"{n}.cu").is_file()


def test_library_path_keys_on_every_header(monkeypatch, tmp_path):
    # an edited shared header (scan.cuh, bins.cuh, common.cuh) must
    # rebuild every library, or a stale one would be loaded
    for p in _build.CSRC.iterdir():
        (tmp_path / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    for header in sorted(p.name for p in tmp_path.glob("*.cuh")):
        before = {n: _build.library_path(n) for n in _build.SOURCES}
        with open(tmp_path / header, "a") as f:
            f.write("\n// edited\n")
        after = {n: _build.library_path(n) for n in _build.SOURCES}
        assert all(before[n] != after[n] for n in _build.SOURCES), header


def _pallas_kernels():
    """{(file, function): def line} for every function the reference
    hands to pl.pallas_call (directly or through functools.partial)."""
    found = {}
    for path in sorted((ROOT / "tpukernels" / "kernels").glob("*.py")):
        tree = ast.parse(path.read_text())
        defs = {n.name: n.lineno for n in ast.walk(tree)
                if isinstance(n, ast.FunctionDef)}
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "pallas_call"):
                continue
            target = node.args[0]
            if isinstance(target, ast.Call):  # functools.partial(fn, ...)
                target = target.args[0]
            assert isinstance(target, ast.Name), ast.dump(target)
            rel = f"tpukernels/kernels/{path.name}"
            found[(rel, target.id)] = defs[target.id]
    return found


def test_kernel_table_covers_every_pallas_kernel():
    pallas = _pallas_kernels()
    table = {(r.file, r.function): r for r in TPU_KERNELS}
    assert len(pallas) == 12
    assert set(pallas) == set(table)
    for key, line in pallas.items():
        assert table[key].line == line, key
    assert len({r.id for r in TPU_KERNELS}) == len(TPU_KERNELS)


def test_kernel_table_rows_are_consistent():
    from tpukernels_torch.kernels import HELPER_KERNELS, LAUNCHES

    ported = [r for r in TPU_KERNELS if r.status == "ported"]
    # every TPU kernel has its counterpart
    assert {r.id for r in ported} == {f"B{i}" for i in range(1, 13)}
    counted = set()
    for r in TPU_KERNELS:
        assert r.status in ("ported", "pending")
        if r.status == "ported":
            src = ROOT / r.port_source
            assert src.is_file() and r.port_entry in src.read_text()
            assert r.launches and set(r.launches) <= set(LAUNCHES)
            counted |= set(r.launches)
        else:
            assert r.port_entry is None and not r.launches
    # a helper kernel (work the reference leaves to XLA) has a counter
    # and a source, but no row
    assert not counted & set(HELPER_KERNELS)
    for name, helper in HELPER_KERNELS.items():
        src = ROOT / helper.source
        assert src.is_file() and helper.port_entry in src.read_text()
        assert src.stem in _build.SOURCES
        assert helper.replaces.startswith("tpukernels/kernels/")
    assert counted | set(HELPER_KERNELS) == set(LAUNCHES)


# every key is ported: the mechanism is held on keys put back as pending
@pytest.mark.parametrize("name", ["scan", "scan_exclusive", "histogram",
                                  "scan_histogram"])
def test_pending_keys_raise(name, monkeypatch):
    monkeypatch.setitem(registry.PENDING, name, "Queue B, for this test")
    with pytest.raises(KeyError, match="ROADMAP.md"):
        registry.lookup(name)
    with pytest.raises(KeyError, match="pending"):
        registry.dispatch(name)


def test_unknown_key_raises():
    with pytest.raises(KeyError, match="unknown kernel"):
        registry.lookup("dgemm")


def test_registry_keys_match_reference():
    from tpukernels import registry as ref

    assert set(registry.names()) | set(registry.PENDING) == set(ref.names())


class _OnCard:
    """A stand-in for a tensor on CUDA device ``index``."""

    def __init__(self, index):
        self.index = index

    def get_device(self):
        return self.index


@pytest.mark.parametrize("current,target", [(0, 0), (0, 1), (1, 1)])
def test_launch_enters_the_device_only_when_it_is_not_current(monkeypatch,
                                                              current,
                                                              target):
    """_build.launch passes the raw current stream of the tensor's
    device and makes that device current around the call only when it is
    not current already."""
    entered = []

    @contextlib.contextmanager
    def device(idx):
        entered.append(idx)
        yield

    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: current,
                        raising=False)
    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda idx: 1000 + idx, raising=False)
    calls = []
    rc = _build.launch(lambda *a: calls.append(a) or 7, _OnCard(target), 3,
                       4)
    assert rc == 7 and calls == [(3, 4, 1000 + target)]
    assert entered == ([] if current == target else [target])
    assert _build.stream_of(_OnCard(target)) == 1000 + target


FAKE_NVCC = """#!/bin/sh
if [ "$1" = "--version" ]; then
  echo "Cuda compilation tools, release 0.0, V0.0.0"
  exit 0
fi
echo $$ >> "{log}"
sleep 1
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; fi
  shift
done
echo built > "$out"
"""

BUILD_ONE = """
import sys
from pathlib import Path
from tpukernels_torch import _build
_build.BUILD_DIR = Path(sys.argv[1])
print(sorted(_build.build(("saxpy",))))
"""


def test_build_lock_holds_across_processes(tmp_path):
    # two processes that miss the same library at once (ranks starting
    # together): one compiles it, the other waits and finds it built
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    log = tmp_path / "nvcc.log"
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(log=log))
    nvcc.chmod(0o755)
    env = dict(os.environ, PYTHONPATH=str(ROOT),
               PATH=f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    out = tmp_path / "build"
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_ONE, str(out)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    results = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), results
    assert sorted(r[0].strip() for r in results) == ["['saxpy']", "[]"]
    assert len(log.read_text().split()) == 1
    (lib,) = out.glob("saxpy-*.so")
    assert lib.read_text() == "built\n"


# the serving fleet's processes that never touch the card, and the
# daemon's shared helpers they use
FLEET = ("router", "wal", "health", "guardian", "fleet", "ctl", "proc")


def test_fleet_is_under_the_rules():
    # every fleet module is among the modules the no-JAX rule imports
    # and the files the knob rule reads; every knob it reads (through
    # os.environ or the fail-loud parsers) starts with TPKT_, and it
    # names no module of the JAX package
    mods = {f"tpukernels_torch.serve.{m}" for m in FLEET}
    assert mods <= set(_port_modules())
    read = []
    for m in FLEET:
        src = (PORT / "serve" / f"{m}.py").read_text()
        assert not re.search(r"^\s*(import|from)\s+(jax|tpukernels\b(?!_))",
                             src, re.M), m
        read += re.findall(r"environ(?:\.get)?\(\s*\"(\w+)\"", src)
        read += re.findall(r"_knob\(\s*\"(\w+)\"", src)
        read += re.findall(r"\"(\w+)\" in os\.environ", src)
        read += re.findall(r"\.get\(\s*\"(TPK\w*)\"", src)
    assert read and all(k.startswith("TPKT_") for k in read), read
    assert {"TPKT_ROUTE_TENANT_RATE", "TPKT_ROUTE_HEDGE_PCTL",
            "TPKT_FLEET_PROBE_S", "TPKT_FLEET_RESTART_MAX",
            "TPKT_ROUTER_RESTART_MAX", "TPKT_SERVE_FLEET_DIR"} <= set(read)


def test_fleet_processes_import_no_torch():
    """The router, the WAL, the health manager, the guardian, the layout
    and ctl load no torch (they never open a CUDA context), checked in a
    fresh interpreter."""
    code = (
        "import importlib, sys\n"
        f"for m in {FLEET!r}:\n"
        "    importlib.import_module('tpukernels_torch.serve.' + m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'jaxlib', 'tpukernels'))\n"
        "print(','.join(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, env=env, timeout=120)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == ""


# the compile discipline and the device inventory: the fleet's router
# imports both, so they load no torch until a call needs it
NO_TORCH_AT_IMPORT = ("tpukernels_torch.aot", "tpukernels_torch.obs.scaling",
                      "tpukernels_torch.prewarm")


def test_compile_discipline_is_under_the_rules():
    mods = set(_port_modules())
    assert set(NO_TORCH_AT_IMPORT) <= mods
    for m in NO_TORCH_AT_IMPORT:
        src = (ROOT / (m.replace(".", "/") + ".py")).read_text()
        assert not re.search(r"^\s*(import|from)\s+(jax|tpukernels\b(?!_))",
                             src, re.M), m
        read = re.findall(r"environ(?:\.get)?\(\s*\"(\w+)\"", src)
        read += re.findall(r"env_raw\(\s*\"(\w+)\"", src)
        assert all(k.startswith(("TPKT_", "CUDA_")) for k in read), read


def test_compile_discipline_imports_no_torch():
    code = (
        "import importlib, sys\n"
        f"for m in {NO_TORCH_AT_IMPORT!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'jaxlib', 'tpukernels'))\n"
        "print(','.join(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, env=env, timeout=120)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == ""


# the serving control loop: the load generator, the SLO judge, the
# request timelines, the bucket optimizer and the torch-free canary table
CONTROL_LOOP = ("tpukernels_torch.loadgen", "tpukernels_torch.obs.slo",
                "tpukernels_torch.obs.reqtrace",
                "tpukernels_torch.serve.adapt",
                "tpukernels_torch.serve.optimize",
                "tpukernels_torch.resilience.canary")


def test_control_loop_is_under_the_rules():
    mods = set(_port_modules())
    assert set(CONTROL_LOOP) <= mods
    read = []
    for m in CONTROL_LOOP:
        src = (ROOT / (m.replace(".", "/") + ".py")).read_text()
        assert not re.search(r"^\s*(import|from)\s+(jax|tpukernels\b(?!_))",
                             src, re.M), m
        read += re.findall(r"environ(?:\.get)?\(\s*\"(\w+)\"", src)
        read += re.findall(r"\"(\w+)\" in os\.environ", src)
    assert read and all(k.startswith("TPKT_") for k in read), read
    assert {"TPKT_LOADGEN_SEED", "TPKT_SLO_SCALE", "TPKT_SLO_MIN_REQUESTS",
            "TPKT_TRACE_COVERAGE_MIN", "TPKT_ADAPT_PAD_TARGET",
            "TPKT_ADAPT_MIN_REQUESTS", "TPKT_HEALTH_JOURNAL"} <= set(read)


def _run_cli(module, argv, env, timeout=180):
    """``python -m <module> <argv>`` in a fresh interpreter: its exit code
    and the torch, JAX and reference modules it loaded."""
    code = (
        "import runpy, sys\n"
        f"sys.argv = [{module!r}] + {list(argv)!r}\n"
        "rc = 0\n"
        "try:\n"
        f"    runpy.run_module({module!r}, run_name='__main__',"
        " alter_sys=True)\n"
        "except SystemExit as e:\n"
        "    rc = e.code\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'jaxlib', 'tpukernels'))\n"
        "print('RESULT', rc, ','.join(bad))\n"
    )
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, env=env, timeout=timeout)
    assert p.returncode == 0, p.stdout + p.stderr
    line = p.stdout.strip().splitlines()[-1].split(" ")
    assert line[0] == "RESULT", p.stdout
    return int(line[1]), (line[2] if len(line) > 2 else ""), p


def _clean_env(tmp_path, **extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPKT_", "TPK_"))}
    env.update(PYTHONPATH=str(ROOT), TPKT_SLO_DIR=str(tmp_path / "slo"),
               TPKT_ADAPT_DIR=str(tmp_path / "adapt"),
               TPKT_HEALTH_JOURNAL=str(tmp_path / "j.jsonl"))
    env.update({k: str(v) for k, v in extra.items()})
    return env


def test_load_clients_import_no_torch(tmp_path):
    """``loadgen --simulate``, ``loadgen --serve`` against a port daemon
    and ``serve.optimize propose`` with traffic to mine run to their end
    without loading torch (the daemon holds the device)."""
    import json

    env = _clean_env(tmp_path)
    rc, bad, p = _run_cli("tpukernels_torch.loadgen",
                          ["--kernel", "scan", "--requests", "30",
                           "--simulate", "2"], env)
    assert (rc, bad) == (0, ""), p.stdout + p.stderr
    # a coarse table and a journal of traffic that pads 99.6 % into it
    table = tmp_path / "buckets.json"
    table.write_text(json.dumps({"vector_add": {
        "args": [["f32", []], ["f32", [1 << 20]], ["f32", [1 << 20]]],
        "statics": {}}}))
    mined = tmp_path / "traffic.jsonl"
    mined.write_text("".join(json.dumps({
        "kind": "serve_request", "kernel": "vector_add", "ok": True,
        "shapes": [[], [4096], [4096]], "dtypes": ["float32"] * 3,
        "pad_frac": 0.996, "bucketed": True}) + "\n" for _ in range(60)))
    rc, bad, p = _run_cli("tpukernels_torch.serve.optimize",
                          ["propose", "--journal", str(mined)],
                          _clean_env(tmp_path, TPKT_SERVE_BUCKETS=table,
                                     TPKT_SERVE_MAX_PAD_FRAC="1.0"))
    assert (rc, bad) == (0, ""), p.stdout + p.stderr
    cand = json.loads((tmp_path / "adapt" / "adapt.json").read_text())
    assert cand["status"] == "proposed"
    assert (cand["torch"], cand["cuda"]) == (torch.__version__,
                                             torch.version.cuda)
    # a daemon on the CPU for the served run
    d = tmp_path / "serve"
    d.mkdir()
    sock = str(d / "s.sock")
    denv = _clean_env(tmp_path, TPKT_SERVE_DEVICE="cpu", TPKT_SERVE_DIR=d,
                      TPKT_HEALTH_JOURNAL=d / "j.jsonl")
    with open(d / "stderr.txt", "w") as err:
        proc = subprocess.Popen([sys.executable, "-m",
                                 "tpukernels_torch.serve", "--socket", sock],
                                cwd=ROOT, env=denv,
                                stdout=subprocess.DEVNULL, stderr=err)
    try:
        from tpukernels_torch.serve import client

        deadline = time.monotonic() + 90
        while True:
            assert proc.poll() is None, (d / "stderr.txt").read_text()
            try:
                with client.ServeClient(sock, timeout_s=10) as c:
                    c.ping()
                break
            except OSError:
                assert time.monotonic() < deadline
                time.sleep(0.1)
        rc, bad, p = _run_cli("tpukernels_torch.loadgen",
                              ["--serve", sock, "--kernel", "scan",
                               "--requests", "10", "--rate", "100",
                               "--verify"],
                              _clean_env(tmp_path,
                                         TPKT_HEALTH_JOURNAL=d / "j.jsonl"))
        assert (rc, bad) == (0, ""), p.stdout + p.stderr
        assert "(SERVED)" in p.stdout
    finally:
        proc.terminate()
        proc.wait(30)


# the fleet's operations layer: the daily rollups, the journal
# analyzers, the gate, the timeline report, the dashboard and the chaos
# campaign, all readers or clients of the fleet
OPERATIONS = ("tpukernels_torch.obs.rollup", "tpukernels_torch.obs.trend",
              "tpukernels_torch.obs.report",
              "tpukernels_torch.obs.trace_report",
              "tpukernels_torch.serve.top", "tpukernels_torch.serve.chaos")


def test_operations_layer_is_under_the_rules():
    mods = set(_port_modules())
    assert set(OPERATIONS) <= mods
    read = []
    for m in OPERATIONS + ("tpukernels_torch._cachedir",
                           "tpukernels_torch.serve.adapt"):
        src = (ROOT / (m.replace(".", "/") + ".py")).read_text()
        assert not re.search(r"^\s*(import|from)\s+(jax|tpukernels\b(?!_))",
                             src, re.M), m
        assert not re.search(r"^\s*(import|from)\s+torch", src, re.M), m
        read += re.findall(r"environ(?:\.get|\.setdefault)?\(\s*\"(\w+)\"",
                           src)
        read += re.findall(r"\.get\(\s*\"(TPK\w*)\"", src)
        read += re.findall(r"\"(TPK_?\w+_DIR)\"", src)
    assert read and all(k.startswith("TPKT_") for k in read), read
    # the knobs this layer adds, in the TPKT_ catalog
    assert {"TPKT_ROLLUP_DIR", "TPKT_ADAPT_WINDOW_DAYS",
            "TPKT_HEALTH_JOURNAL", "TPKT_SERVE_REQUEST_TIMEOUT_S",
            "TPKT_CLIENT_RECONNECT_S"} <= set(read)


def test_operations_layer_imports_no_torch():
    code = (
        "import importlib, sys\n"
        f"for m in {OPERATIONS!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'jaxlib', 'tpukernels'))\n"
        "print(','.join(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, env=env, timeout=120)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == ""


def test_operations_clis_run_without_torch(tmp_path):
    """The gate, the timeline report and the rollup run to their end
    over a journal without loading torch."""
    import json

    jd = tmp_path / "journals"
    jd.mkdir()
    (jd / "health_2026-08-01.jsonl").write_text("".join(json.dumps(e) + "\n"
                                                        for e in (
        {"kind": "serve_request", "request_id": "r1", "kernel": "scan",
         "ok": True, "wall_s": 0.01, "shapes": [[64]], "dtypes": ["int32"],
         "pad_frac": 0.0, "pid": 3, "t": 1.0},
        {"kind": "serve_client_request", "request_id": "r1",
         "kernel": "scan", "wall_s": 0.02, "ok": True, "pid": 2, "t": 1.0})))
    env = _clean_env(tmp_path, TPKT_HEALTH_JOURNAL=jd,
                     TPKT_ROLLUP_DIR=tmp_path / "roll",
                     TPKT_SCALING_DIR=tmp_path / "scaling",
                     TPKT_INTEGRITY_DIR=tmp_path / "integrity")
    for module, argv, want in (
            ("tpukernels_torch.obs.report", ["--check"], 0),
            ("tpukernels_torch.obs.report", [], 0),
            ("tpukernels_torch.obs.trace_report", ["--slowest", "1"], 0),
            ("tpukernels_torch.obs.rollup", [], 0),
            ("tpukernels_torch.serve.chaos", ["--events", "0"], 2)):
        rc, bad, p = _run_cli(module, argv, env)
        assert (rc, bad) == (want, ""), (module, p.stdout + p.stderr)
    assert (tmp_path / "roll" / "rollup_2026-08-01.json").exists()


# the revalidation supervisor: the queue, its CLI and the session report,
# none of which may open a CUDA context; and the C gate its steps run
SUPERVISOR = ("tpukernels_torch.resilience.supervisor",
              "tpukernels_torch.revalidate",
              "tpukernels_torch.obs.health_report")


def test_supervisor_layer_is_under_the_rules():
    mods = set(_port_modules())
    assert set(SUPERVISOR) | {"tpukernels_torch.cgate"} <= mods
    read = []
    for m in SUPERVISOR + ("tpukernels_torch.cgate",):
        src = (ROOT / (m.replace(".", "/") + ".py")).read_text()
        assert not re.search(r"^\s*(import|from)\s+(jax|tpukernels\b(?!_))",
                             src, re.M), m
        assert not re.search(r"\bjax\b", src), m
        if m in SUPERVISOR:
            assert not re.search(r"^\s*(import|from)\s+torch", src,
                                 re.M), m
        read += re.findall(r"environ(?:\.get|\.setdefault)?\(\s*\"(\w+)\"",
                           src)
        read += re.findall(r"env\[\"(\w+)\"\]", src)
    assert read and all(k.startswith("TPKT_") or k in ("HOME",
                                                       "ASAN_OPTIONS",
                                                       "TPU_KERNELS_SHIM")
                        for k in read), read
    assert {"TPKT_REVALIDATE_STAMP_DIR", "TPKT_REVALIDATE_FORCE",
            "TPKT_SUPERVISOR_CHECKPOINT", "TPKT_SUPERVISOR_WINDOW_MIN",
            "TPKT_SUPERVISOR_PROBE_BASE_S", "TPKT_SUPERVISOR_PROBE_CAP_S",
            "TPKT_REVALIDATE_LOCK", "TPKT_REVALIDATE_LOCK_WAIT_S",
            "TPKT_SUPERVISOR_QUEUE", "TPKT_HEALTH_JOURNAL"} <= set(read)


def test_supervisor_state_is_a_state_dir():
    from tpukernels_torch import _cachedir

    assert _cachedir.STATE_DIRS["TPKT_SUPERVISOR_DIR"] == "supervisor"
    assert _cachedir.supervisor_dir({}) == str(ROOT / ".tpkt_cache" /
                                               "supervisor")
    assert _cachedir.supervisor_dir({"TPKT_SUPERVISOR_DIR": "/x"}) == "/x"
    ignored = (ROOT / ".gitignore").read_text().split()
    assert ".tpkt_cache/" in ignored


def test_supervisor_layer_imports_no_torch():
    code = (
        "import importlib, sys\n"
        f"for m in {SUPERVISOR!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'jaxlib', 'tpukernels'))\n"
        "print(','.join(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, env=env, timeout=120)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == ""


BENCH_LAYER = ("tpukernels_torch.bench", "tpukernels_torch.tuning.runner",
               "tpukernels_torch.autotune", "tpukernels_torch.sgemm_tune")


def test_bench_layer_is_under_the_rules():
    """The bench and the tuning loop name no JAX and nothing of the JAX
    package, read and set only ``TPKT_`` knobs (and, for the children,
    the variable that hides the card from a smoke sweep's and the
    repository on their path), and spawn the port's own bench, never the
    reference's ``bench.py``."""
    mods = set(_port_modules())
    assert set(BENCH_LAYER) <= mods
    read = []
    for m in BENCH_LAYER:
        src = (ROOT / (m.replace(".", "/") + ".py")).read_text()
        assert not re.search(r"^\s*(import|from)\s+(jax|tpukernels\b(?!_))",
                             src, re.M), m
        assert not re.search(r"\bjax\b", src), m
        assert not re.search(r"[\"']bench\.py[\"']", src), m
        read += re.findall(r"environ(?:\.get|\.setdefault)?\(\s*\"(\w+)\"",
                           src)
        read += re.findall(r"env\w*\[\"(\w+)\"\]", src)
        read += re.findall(r"\"(\w+)\":", src.split("_SMOKE_ENV", 1)[-1]
                           .split("}", 1)[0]) if "_SMOKE_ENV =" in src else []
    assert read and all(k.startswith("TPKT_") or k in (
        "CUDA_VISIBLE_DEVICES", "PYTHONPATH") for k in read), read
    assert {"TPKT_BENCH_SMOKE", "TPKT_BENCH_DEADLINE_S", "TPKT_BENCH_ONLY",
            "TPKT_TUNE_TIMEOUT_S", "TPKT_TUNING_CACHE"} <= set(read)


def test_tuning_cli_imports_no_torch():
    """``autotune`` and the runner import no torch when imported: the
    sweep's parent makes no CUDA context, only its children do."""
    code = (
        "import importlib, sys\n"
        "for m in ('tpukernels_torch.autotune', "
        "'tpukernels_torch.tuning.runner', 'tpukernels_torch.sgemm_tune'):\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'jaxlib', 'tpukernels'))\n"
        "print(','.join(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, env=env, timeout=120)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == ""
