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
"""

import ast
import contextlib
import os
import re
import subprocess
import sys
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
                                       "collectives.py", "busbw.py"}
    read = []
    for p in files + [PORT / "capi.py"]:
        src = p.read_text()
        read += re.findall(r"environ(?:\.get)?\(\s*\"(\w+)\"", src)
        read += re.findall(r"environ\[\"(\w+)\"\]", src)
        read += re.findall(r"\"(\w+)\" in os\.environ", src)
    assert read and all(k.startswith("TPKT_") for k in read), read
    assert {"TPKT_COORDINATOR_ADDRESS", "TPKT_DIST_DEPTH", "TPKT_MESH",
            "TPKT_NBODY_DIST", "TPKT_BUSBW_SWEEP"} <= set(read)


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
