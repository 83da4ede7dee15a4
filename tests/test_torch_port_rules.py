"""Machine checks of the port's ground rules.

- The port (``tpukernels_torch`` and ``chip_smoke.py``) imports no JAX
  and nothing of the JAX package.
- Entry points that allocate run on the card unless the caller asks for
  the CPU, and raise when there is no card.
- Every Pallas kernel of the reference has a row in the port's kernel
  table, ported or pending, and every row names a Pallas kernel.
- Pending registry keys raise KeyError.
- The port's knobs use the ``TPKT_`` prefix, never ``TPK_``.
"""

import ast
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
            if p.suffix in (".py", ".cu", ".cuh") and "_build" not in p.parts]


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


def test_no_tpk_knob_prefix_in_port():
    for p in _port_files() + [CHIP_SMOKE]:
        assert not re.search(r"\bTPK_", p.read_text()), p


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
    from tpukernels_torch.kernels import LAUNCHES

    ported = [r for r in TPU_KERNELS if r.status == "ported"]
    assert {r.id for r in ported} == {"B1", "B3", "B4", "B5", "B6", "B7",
                                      "B8", "B9", "B10", "B11", "B12"}
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
    assert counted == set(LAUNCHES)


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
