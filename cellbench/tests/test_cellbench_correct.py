"""What decides ``correct``, at sizes a CPU test holds: the plain
reference agrees with the program, a run with its timed path broken
underneath comes out not correct, the control (the reference in
bfloat16) fails the limits, and ``run.py`` refuses where it must.

The tests import the program to drive it; ``reference/`` imports
nothing of it (``test_cellbench_spec.py``)."""

import os
import shutil
import subprocess
import sys
import types

import pytest
import torch

from cellbench import control, harness, spec
from cellbench import run as cb_run

ROOT = spec.ROOT
SMALL = {"jacobi2d-4096": {"shape": [40, 72]}, "nbody-65536": {"n": 256}}
CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
# the mesh mix is tested whether or not BENCHMARK.json has its cell yet
CELLS += [n for n in ("nbody-65536.mesh4",) if n not in CELLS]


def small_cell(name: str) -> spec.Cell:
    """The cell ``<config>.<traffic>`` with its configuration cut to a
    CPU test's size; its traffic and limits as they stand, on one
    process."""
    config, traffic = name.split(".", 1)
    c = spec.Cell(name=name, chips=1,
                  config=spec.load_json(spec.config_file(config)),
                  traffic=spec.load_json(spec.traffic_file(traffic)))
    c.config = {**c.config, **SMALL[config]}
    if is_mesh(name):
        c.traffic = {**c.traffic, "entry": "dispatch"}
    return c


def is_mesh(name: str) -> bool:
    traffic = spec.load_json(spec.traffic_file(name.split(".", 1)[1]))
    return traffic.get("entry") == "dispatch_mesh"


@pytest.fixture(scope="module")
def state_dirs(tmp_path_factory):
    saved = dict(os.environ)
    cb_run.program_env(str(tmp_path_factory.mktemp("state")), False)
    yield
    os.environ.clear()
    os.environ.update(saved)


def run(cell, entry=None, seed=2**31 + 99, keep=False):
    return harness.run_cell(cell, seed, 0.3, False, torch.device("cpu"),
                            harness.Clock.start(), entry=entry, keep=keep)


def test_the_reference_agrees_with_the_program(state_dirs):
    from tpukernels_torch import registry

    gen = torch.Generator().manual_seed(5)
    for name in ("jacobi2d-4096.solve1000", "nbody-65536.steps10"):
        c = small_cell(name)
        kin = spec.load_module("inputs", c.kernel)
        ref = spec.load_module("reference", c.kernel)
        st = {**c.statics, "steps": 3, "iters": 24}
        if c.kernel == "nbody":
            st.pop("iters")
        else:
            st.pop("steps")
        for ops in kin.make(c.config, 2, gen, "cpu"):
            got = harness.leaves(registry.dispatch(c.kernel, *ops, **st))
            nums = ref.compare(got, ref.reference(ops, st), ops, st)
            assert all(v <= 1e-4 for v in nums.values()), (name, nums)


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(state_dirs, name):
    rec = run(small_cell(name))
    assert rec["correct"] and rec["compared"] > 0 and rec["failed"] == 0
    assert set(rec["checks"]) == set(small_cell(name).traffic["limits"])


def _unchanged(kernel):
    n = 1 if kernel == "stencil2d" else 6
    return lambda ops: tuple(t.clone() for t in ops[:n])


def _altered(call):
    def f(ops):
        out = tuple(t.clone() for t in call(ops))
        out[0].view(-1)[out[0].numel() // 2 + 3] += 1e-2
        return out
    return f


def _half_left_out(cell, statics):
    """stencil2d: half the sweeps; nbody: the forces of half the bodies,
    their mass taken over the rest (twice as heavy)."""
    from tpukernels_torch import registry

    if cell.kernel == "stencil2d":
        half = {**statics, "iters": statics["iters"] // 2}
        return lambda ops: harness.leaves(
            registry.dispatch("stencil2d", *ops, **half))

    def f(ops):
        m = ops[6].clone()
        m[::2] = 0
        m[1::2] *= 2
        return harness.leaves(registry.dispatch(
            "nbody", *ops[:6], m, **statics))
    return f


def _exchange_left_out(statics, ranks=4):
    """Each rank's i-block moved by the forces of its own j-block alone:
    the ring's hops left out."""
    from tpukernels_torch import registry

    def f(ops):
        parts = [harness.leaves(registry.dispatch(
            "nbody", *(t.chunk(ranks)[r].contiguous() for t in ops),
            **statics)) for r in range(ranks)]
        return tuple(torch.cat(p) for p in zip(*parts))
    return f


def faults(name):
    c = small_cell(name)
    statics = c.statics
    sound = harness.make_entry(c, statics)
    out = {"unchanged": _unchanged(c.kernel), "altered": _altered(sound),
           "half_left_out": _half_left_out(c, statics)}
    if is_mesh(name):
        out["exchange_left_out"] = _exchange_left_out(statics)
    return [(name, f, fn) for f, fn in out.items()]


@pytest.mark.parametrize("name,fault,entry",
                         [x for n in CELLS for x in faults(n)],
                         ids=lambda v: v if isinstance(v, str) else "")
def test_a_broken_timed_path_is_not_correct(state_dirs, name, fault, entry):
    rec = run(small_cell(name), entry=entry)
    assert rec["compared"] > 0
    assert not rec["correct"], (fault, rec["checks"])


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_the_limits(state_dirs, name):
    """The reference in bfloat16, in the program's place: at least one
    compared number over its limit on every sample set."""
    c = small_cell(name)
    for seed in (11, 12, 13):
        rec = run(c, seed=seed, keep=True)
        got = control.control_reading(c, rec)
        assert any(got[k] > lim for k, lim in c.traffic["limits"].items()), \
            (seed, got)


def _run_py(cwd, env_extra=None):
    env = {k: v for k, v in os.environ.items() if not k.startswith("TPKT_")}
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, "cellbench/run.py", "--workload", CELLS[0],
         "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=120)


def test_run_without_a_card_fails_and_prints_no_result():
    p = _run_py(ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0
    assert "metrics" not in p.stdout and p.stdout.strip() == ""
    assert "CUDA card" in p.stderr


def test_run_from_the_benchmarks_files_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "cellbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run_py(str(tmp_path), {"PYTHONPATH": ""})
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "no tpukernels_torch" in p.stderr


def test_forbidden_modules_are_named_by_whole_top_level_name(monkeypatch):
    for name in [m for m in sys.modules
                 if m.split(".")[0] in cb_run.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    assert cb_run.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "tpukernels_torchlike",
                        types.ModuleType("tpukernels_torchlike"))
    assert cb_run.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "tpukernels.registry",
                        types.ModuleType("tpukernels.registry"))
    monkeypatch.setitem(sys.modules, "jaxlib",
                        types.ModuleType("jaxlib"))
    assert cb_run.forbidden_loaded() == ["jaxlib", "tpukernels"]
