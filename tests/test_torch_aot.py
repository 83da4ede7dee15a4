"""The port's compile discipline (``tpukernels_torch/aot.py``) on the CPU,
case by case against ``tests/test_aot.py``: keys in the reference's
scheme (field for field the reference's ``aot.cache_key``), one ensure a
key a process across precompile and dispatch, the layer off, loud
rejection of a stale or foreign manifest row, invalidation by the
integrity guard, the toolkit in the libraries' key, one knob fingerprint
for the manifest and the quarantine, and the device inventory.
"""

import datetime
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tpukernels import aot as ref_aot
from tpukernels import registry as ref_registry
from tpukernels.obs import scaling as ref_scaling
from tpukernels_torch import _build, aot, registry
from tpukernels_torch.obs import metrics
from tpukernels_torch.obs import scaling
from tpukernels_torch.resilience import faults, integrity
from tpukernels_torch.tuning import cache as tcache

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


def _events(path, kind=None):
    if not os.path.exists(path):
        return []
    recs = [json.loads(line) for line in open(path) if line.strip()]
    return [r for r in recs if kind is None or r.get("kind") == kind]


@pytest.fixture
def aot_env(monkeypatch, tmp_path):
    """The manifest, journal, integrity state and tuning cache in a tmp
    dir, every knob unset, the per-process state dropped."""
    for var in list(os.environ):
        if var.startswith(("TPKT_", "TPK_")):
            monkeypatch.delenv(var)
    monkeypatch.setenv("TPKT_AOT_DIR", str(tmp_path))
    monkeypatch.setenv("TPKT_HEALTH_JOURNAL", str(tmp_path / "j.jsonl"))
    monkeypatch.setenv("TPKT_INTEGRITY_DIR", str(tmp_path / "integrity"))
    monkeypatch.setenv("TPKT_TUNING_CACHE_DIR", str(tmp_path / "tuning"))
    for reset in (aot.reset, metrics.reset, integrity.reset, tcache.forget,
                  faults.reload_plan):
        reset()
    yield tmp_path
    monkeypatch.delenv("TPKT_FAULT_PLAN", raising=False)
    for reset in (aot.reset, metrics.reset, integrity.reset, tcache.forget,
                  faults.reload_plan):
        reset()


def _journal(tmp):
    return str(tmp / "j.jsonl")


def _manifest(tmp):
    p = tmp / "aot.json"
    return json.loads(p.read_text())["entries"] if p.exists() else {}


def _ints(n, hi=256, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, hi, n).astype(np.int32))


def _floats(*shape, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


# ---------------------------------------------------------------- keys

@pytest.mark.parametrize("name", sorted(aot.BENCH_CONFIGS))
def test_cache_key_equals_the_references(aot_env, monkeypatch, name):
    # the same avatar, the same statics, no knob set: field for field
    # the reference's key (its tuning cache off, as the port's is empty)
    monkeypatch.setenv("TPK_TUNING_CACHE", "0")
    ref_aot.reset()
    spec = ref_aot.BENCH_CONFIGS[name]
    assert aot.BENCH_CONFIGS[name] == spec
    want = ref_aot.cache_key(name, ref_aot._avatar_args(spec),
                             spec["statics"], kind="cpu")
    got = aot.cache_key(name, aot.avatar_args(name, CPU), spec["statics"],
                        kind="cpu")
    assert got.split("|") == want.split("|")


def test_cache_key_format(aot_env):
    x = torch.zeros(64, 128)
    assert aot.cache_key("sgemm", (x, x), kind="cpu") == \
        "sgemm|64x128+64x128|float32|cpu"
    assert aot.cache_key("histogram", (torch.zeros(16, dtype=torch.int32),),
                         statics={"nbins": 256}) == \
        "histogram@nbins=256|16|int32|cpu"
    assert aot.cache_key("vector_add", (0.5, x.view(-1), x.view(-1)),
                         kind="k") == "vector_add|-+8192+8192|float32|k"


def test_tuning_promotion_and_a_knob_change_the_key(aot_env, monkeypatch):
    x = torch.zeros(16)
    before = aot.cache_key("vector_add", (x,))
    (aot_env / "tuning").mkdir()
    (aot_env / "tuning" / "tuning.json").write_text('{"entries": {"k": 1}}')
    tcache.forget()
    promoted = aot.cache_key("vector_add", (x,))
    assert promoted != before and "tuned=" in promoted
    aot.reset()  # the same content gives the same key in a new process
    assert aot.cache_key("vector_add", (x,)) == promoted
    monkeypatch.setenv("TPKT_TUNING_CACHE", "0")
    assert aot.cache_key("vector_add", (x,)) == before
    monkeypatch.setenv("TPKT_SGEMM_DEPTH", "3")
    knob = aot.cache_key("vector_add", (x,))
    assert knob == "vector_add@TPKT_SGEMM_DEPTH=3|16|float32|cpu"


def test_every_key_has_sources_and_libraries():
    for name in aot.BENCH_CONFIGS:
        assert aot.KERNEL_SOURCES.get(name), name
        libs = aot.KERNEL_LIBRARIES.get(name)
        assert libs and {lib for lib, _ in libs} <= set(_build.SOURCES), name
        for src in aot.KERNEL_SOURCES[name]:
            assert (ROOT / src).is_file(), src
    # every library and header a key's libraries are keyed on
    assert {s for s in aot.KERNEL_SOURCES["sgemm"] if s.endswith(".cuh")} \
        == {f"tpukernels_torch/csrc/{p.name}"
            for p in _build.CSRC.glob("*.cuh")}


def test_precompilable_kernels_cover_the_registry():
    assert registry.precompilable_kernels() == registry.names()
    assert registry.precompilable_kernels() == \
        ref_registry.precompilable_kernels()


@pytest.mark.parametrize("name,knobs,want", [
    ("sgemm", {"depth": 1}, ("sgemm_prep", "sgemm")),
    ("sgemm", {"depth": 2}, ("sgemm_prep", "sgemm_pipelined")),
    ("sgemm", {"depth": 3}, ("sgemm_prep", "sgemm_pipelined")),
    ("scan_histogram", {"fuse": "on"}, ("scan_histogram",)),
    ("scan_histogram", {"fuse": "off"}, ("scan", "histogram")),
    ("nbody", {}, ("nbody",)),
    ("stencil3d", {"k": 4}, ("jacobi3d",)),
])
def test_libraries_follow_the_knobs(name, knobs, want):
    assert aot.libraries(name, knobs) == want


def test_libraries_are_those_the_wrappers_launch():
    # the libraries a wrapper module names in its _build.function calls
    # (SGEMM's through its entry table) are those of the keys it serves
    import re

    from tpukernels_torch.kernels import sgemm

    def named(w):
        src = (ROOT / f"tpukernels_torch/kernels/{w}.py").read_text()
        out = set(re.findall(r'_build\.function\(\s*"(\w+)"', src))
        if w == "sgemm":
            out |= {lib for lib, _, _ in sgemm._ENTRIES.values()}
        return out

    def libs(k):
        return {lib for lib, _ in aot.KERNEL_LIBRARIES[k]}

    for k, ws in aot._WRAPPERS.items():
        assert libs(k) <= set().union(*map(named, ws)), k
    for w in {ws[0] for ws in aot._WRAPPERS.values()}:
        keys = [k for k, ws in aot._WRAPPERS.items() if ws[0] == w]
        assert named(w) <= set().union(*map(libs, keys)), w


# ------------------------------------------------- one ensure a process

def test_precompile_then_dispatch_ensures_once(aot_env):
    row = registry.precompile("vector_add", device="cpu")
    assert row["expected"] == "miss" and row["libraries"] == []
    assert metrics.counter("aot.ensures") == 1
    x, y = _floats(1 << 20), _floats(1 << 20, seed=1)
    out = registry.dispatch("vector_add", 2.0, x, y)
    torch.testing.assert_close(out, 2.0 * x + y)
    registry.dispatch("vector_add", 0.5, x, y)
    registry.precompile("vector_add", device="cpu")
    assert metrics.counter("aot.ensures") == 1
    assert [e["key"] for e in _events(_journal(aot_env), "aot_miss")] == \
        [row["key"]]
    assert list(_manifest(aot_env)) == [row["key"]]


def test_each_distinct_nbins_is_one_ensure(aot_env):
    x = _ints(1 << 12)
    h1 = registry.dispatch("histogram", x, nbins=256)
    h2 = registry.dispatch("histogram", x, nbins=256)
    assert metrics.counter("aot.ensures") == 1
    assert torch.equal(h1, h2)
    assert torch.equal(h1, torch.bincount(x.long(), minlength=256).int())
    registry.dispatch("histogram", x, nbins=64)
    registry.dispatch("histogram", x, nbins=64)
    assert metrics.counter("aot.ensures") == 2
    assert sorted(_manifest(aot_env)) == [
        "histogram@nbins=256|4096|int32|cpu",
        "histogram@nbins=64|4096|int32|cpu"]


def test_a_knob_set_mid_process_is_a_new_ensure(aot_env, monkeypatch):
    x = _ints(1 << 12, hi=1000)
    registry.dispatch("scan", x)
    monkeypatch.setenv("TPKT_SCAN_TILE", "4096")
    got = registry.dispatch("scan", x)
    assert metrics.counter("aot.ensures") == 2
    assert torch.equal(got, torch.cumsum(x, 0, dtype=torch.int32))
    assert any("@TPKT_SCAN_TILE=4096|" in k for k in _manifest(aot_env))


def test_threads_missing_one_key_together_ensure_it_once(aot_env):
    # the serving daemon's workers dispatch from threads of their own
    import threading

    x = _ints(1 << 10)
    start, errors = threading.Barrier(16), []

    def work():
        try:
            start.wait(timeout=30)
            for _ in range(20):
                registry.dispatch("scan", x)
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in threads)
    assert metrics.counter("aot.ensures") == 1
    assert len(_events(_journal(aot_env), "aot_miss")) == 1


def test_a_call_the_wrapper_refuses_raises_its_error(aot_env):
    with pytest.raises(ValueError, match="sizes differ"):
        registry.dispatch("vector_add", 1.0, torch.zeros(8), torch.zeros(9))
    with pytest.raises(TypeError):
        registry.dispatch("stencil2d", torch.zeros(8, 8))  # no iters
    assert metrics.counter("aot.ensures") == 0


# --------------------------------------------------------- the layer off

@pytest.mark.parametrize("name", sorted(aot.BENCH_CONFIGS))
def test_layer_off_is_bitwise_the_same_and_silent(aot_env, monkeypatch,
                                                  name):
    args = tuple(a if isinstance(a, float) else a.clone()
                 for a in _canary(name))
    st = integrity.CANARY_CONFIGS[name]["statics"]
    on = registry.dispatch(name, *args, **st)
    assert _events(_journal(aot_env), "aot_miss")
    aot.reset()
    os.remove(aot_env / "aot.json")
    os.remove(_journal(aot_env))
    monkeypatch.setenv("TPKT_AOT_CACHE", "0")
    off = registry.dispatch(name, *args, **st)
    for a, b in zip(_leaves(on), _leaves(off)):
        assert torch.equal(a, b)
    assert not (aot_env / "aot.json").exists()
    assert not [e for e in _events(_journal(aot_env))
                if e["kind"].startswith("aot_")]
    with pytest.raises(RuntimeError, match="TPKT_AOT_CACHE"):
        aot.precompile(name, device="cpu")


def _canary(name):
    from tpukernels_torch import interop

    return interop.to_port(name, integrity.build_args(name), "cpu")


def _leaves(out):
    return out if isinstance(out, tuple) else (out,)


# ------------------------------------------------- manifest validation

def test_stale_source_sha_rejects_exactly_that_kernel(aot_env, capfd,
                                                      monkeypatch):
    # the sources' sha as in a git checkout, whether or not this is one
    monkeypatch.setattr(tcache, "source_sha",
                        lambda sources, root=None: "1" * 40)
    x, s = _floats(1 << 10), _ints(1 << 10)
    registry.dispatch("vector_add", 1.0, x, x)
    registry.dispatch("scan", s)
    path = aot_env / "aot.json"
    data = json.loads(path.read_text())
    scan_keys = [k for k in data["entries"] if k.startswith("scan|")]
    va_keys = [k for k in data["entries"] if k.startswith("vector_add|")]
    assert scan_keys and va_keys
    assert {data["entries"][k]["source_sha"] for k in scan_keys} == {"1" * 40}
    for k in scan_keys:
        data["entries"][k]["source_sha"] = "0" * 40
    path.write_text(json.dumps(data))
    aot.reset()  # a new process, the same manifest
    capfd.readouterr()
    registry.dispatch("vector_add", 1.0, x, x)
    registry.dispatch("scan", s)
    registry.dispatch("scan", s + 1)
    rejected = {e["key"] for e in _events(_journal(aot_env), "aot_rejected")}
    hits = {e["key"] for e in _events(_journal(aot_env), "aot_hit")}
    assert rejected == set(scan_keys)
    assert set(va_keys) <= hits and not set(scan_keys) & hits
    assert metrics.counter("aot.rejections") == 1
    err = capfd.readouterr().err
    assert err.count("# aot-cache rejected: scan|") == 1 and "stale" in err


@pytest.mark.parametrize("field", ["torch", "cuda", "nvcc"])
def test_a_row_from_another_toolkit_is_rejected(aot_env, capfd, field):
    x = _floats(64)
    registry.dispatch("vector_add", 1.0, x, x)
    path = aot_env / "aot.json"
    data = json.loads(path.read_text())
    (key,) = data["entries"]
    data["entries"][key][field] = "0.0-other"
    path.write_text(json.dumps(data))
    aot.reset()
    capfd.readouterr()
    registry.dispatch("vector_add", 1.0, x, x)
    (ev,) = _events(_journal(aot_env), "aot_rejected")
    assert ev["key"] == key and f"made under {field} 0.0-other" in \
        ev["reason"]
    assert f"# aot-cache rejected: {key}" in capfd.readouterr().err
    assert len(_events(_journal(aot_env), "aot_miss")) == 2
    assert _manifest(aot_env)[key][field] != "0.0-other"  # re-recorded


def test_a_torn_manifest_reads_as_empty(aot_env):
    (aot_env / "aot.json").write_text('{"entries": {"vector_add|')
    x = _floats(64)
    out = registry.dispatch("vector_add", 1.0, x, x)
    torch.testing.assert_close(out, x + x)
    assert _events(_journal(aot_env), "aot_miss")
    assert _events(_journal(aot_env), "artifact_rejected")
    assert list(_manifest(aot_env)) == ["vector_add|-+64+64|float32|cpu"]


# ------------------------------------------ invalidation by the guard

def test_an_integrity_failure_invalidates_exactly_its_kernel(aot_env,
                                                             monkeypatch):
    monkeypatch.setenv("TPKT_INTEGRITY_SAMPLE", "1")  # a canary a call
    x, s = _floats(1 << 10), _ints(1 << 12)
    registry.dispatch("vector_add", 1.0, x, x)
    registry.dispatch("histogram", s, nbins=256)
    registry.dispatch("histogram", s, nbins=64)
    rows = set(_manifest(aot_env))
    hist = {k for k in rows if k.startswith("histogram@")}
    assert len(hist) == 2
    monkeypatch.setenv("TPKT_FAULT_PLAN", json.dumps(
        {"corrupt_output": {"kernel": "histogram", "site": "registry"}}))
    faults.reload_plan()
    registry.dispatch("histogram", s, nbins=256)
    (ev,) = _events(_journal(aot_env), "output_integrity_failed")
    assert ev["kernel"] == "histogram"
    assert sorted(ev["aot_manifest_dropped"]) == sorted(hist)
    assert ev["aot_memo_dropped"] == 2 and ev["plan_memo_dropped"] >= 1
    (inv,) = _events(_journal(aot_env), "aot_invalidated")
    assert inv["kernel"] == "histogram"
    assert set(_manifest(aot_env)) == rows - hist
    monkeypatch.delenv("TPKT_FAULT_PLAN")
    faults.reload_plan()
    misses = len(_events(_journal(aot_env), "aot_miss"))
    got = registry.dispatch("histogram", s, nbins=256)
    assert torch.equal(got, torch.bincount(s.long(), minlength=256).int())
    assert len(_events(_journal(aot_env), "aot_miss")) == misses + 1
    assert "histogram@nbins=256|4096|int32|cpu" in _manifest(aot_env)


def test_aot_smoke_runs_once_a_process(aot_env):
    registry.precompile("sgemm", device="cpu")
    registry.precompile("sgemm", device="cpu")
    integrity.aot_smoke("sgemm", device="cpu")
    assert metrics.counter("integrity.deep_checks") == 1
    assert metrics.counter("integrity.tier3.sgemm") == 1


def test_a_failed_aot_smoke_invalidates_what_it_blessed(aot_env,
                                                       monkeypatch):
    monkeypatch.setenv("TPKT_FAULT_PLAN", json.dumps(
        {"corrupt_output": {"kernel": "scan", "site": "aot"}}))
    faults.reload_plan()
    row = registry.precompile("scan", device="cpu")
    (ev,) = _events(_journal(aot_env), "output_integrity_failed")
    assert ev["site"] == "aot" and ev["aot_manifest_dropped"] == [row["key"]]
    assert row["key"] not in _manifest(aot_env)
    assert "scan" in integrity._SUSPECT


# ------------------------------------------------- the toolkit in the key

def test_the_toolkit_is_in_the_library_key(monkeypatch):
    before = {n: _build.library_path(n) for n in _build.SOURCES}
    monkeypatch.setitem(_build._TOOLKIT, "nvcc", "release 99.9, V99.9.1")
    nvcc = {n: _build.library_path(n) for n in _build.SOURCES}
    assert all(nvcc[n] != before[n] for n in _build.SOURCES)
    monkeypatch.setattr(torch.version, "cuda", "99.9")
    cuda = {n: _build.library_path(n) for n in _build.SOURCES}
    assert all(cuda[n] != nvcc[n] for n in _build.SOURCES)
    assert "nvcc=release 99.9, V99.9.1;torch.cuda=99.9" == _build.toolkit()


def test_nvcc_is_asked_once_a_process(monkeypatch):
    asked = []
    monkeypatch.setattr(_build, "_TOOLKIT", {})
    monkeypatch.setattr(_build, "_ask_nvcc",
                        lambda: asked.append(1) or "release 1.0")
    for name in _build.SOURCES:
        _build.library_path(name)
    assert _build.nvcc_release() == "release 1.0" and asked == [1]


def test_no_nvcc_keys_as_none_and_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "_TOOLKIT", {})
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    assert _build.toolkit().startswith("nvcc=none;")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(("saxpy",))


def test_ptxas_report_reads_the_build_log(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    assert _build.ptxas_report("nbody") is None
    _build.library_path("nbody").with_suffix(".log").write_text(
        "ptxas info    : Used 64 registers, used 1 barriers, 16384 bytes "
        "smem, 400 bytes cmem[0]\n"
        "ptxas info    : Used 40 registers, 8 bytes spill stores, 12 "
        "bytes spill loads, 2048 bytes smem\n"
        "ptxas warning : wgmma.mma_async instructions are serialized\n")
    assert _build.ptxas_report("nbody") == {
        "kernels": 2, "registers_min": 40, "registers": 64,
        "smem_bytes": 16384, "spill_stores": 8, "spill_loads": 12,
        "wgmma_serialisation": 1}


# ------------------------------------------------------ one fingerprint

def _old_config_token():
    """The quarantine key's config as the guard computed it before the
    fingerprint moved into aot.py, line for line."""
    import hashlib

    names = {"TPKT_SGEMM_PRECISION"}
    for k in registry.tunable_kernels():
        names.update(registry.tunables(k).envs)
    parts = sorted(f"{n}={os.environ[n]}" for n in names if n in os.environ)
    state = tcache.state()
    if state:
        blob = json.dumps(state, sort_keys=True, default=repr).encode()
        parts.append("tuned=" + hashlib.md5(blob).hexdigest()[:10])
    return ",".join(parts) or "default"


@pytest.mark.parametrize("env", [{}, {"TPKT_SCAN_TILE": "4096",
                                      "TPKT_SGEMM_PRECISION": "float32"}])
@pytest.mark.parametrize("tuned", [False, True])
def test_an_old_quarantine_entry_still_matches(aot_env, monkeypatch, env,
                                               tuned):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if tuned:
        (aot_env / "tuning").mkdir()
        (aot_env / "tuning" / "tuning.json").write_text(
            '{"entries": {"scan|64|int32|cpu": {"params": {"tile": 1024}}}}')
        tcache.forget()
    old = _old_config_token()
    assert integrity.config_token() == old
    assert integrity.config_token() == (aot.tunable_env_fingerprint()
                                        or "default")
    (aot_env / "integrity").mkdir()
    (aot_env / "integrity" / "integrity_quarantine.json").write_text(
        json.dumps({"entries": {f"scan|{old}": {
            "day": datetime.date.today().isoformat(), "failures": 2,
            "quarantined": True}}}))
    integrity.reset()
    assert integrity.is_quarantined("scan")


# ----------------------------------------------------------- inventory

def test_inventory_has_the_references_keys(monkeypatch):
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    want = set(ref_scaling.inventory())
    assert set(scaling.inventory()) == want
    assert set(scaling.inventory(probe=True)) == want


@pytest.mark.parametrize("visible,platform,n,fake,basis", [
    (None, None, None, True, "unknown-platform"),
    ("", "cpu", 0, True, "declared-platform"),
    ("-1", "cpu", 0, True, "declared-platform"),
    ("0", "cuda", 1, False, "declared-platform"),
    ("0,1,2,3", "cuda", 4, False, "declared-platform"),
    ("1,-1,2", "cuda", 1, False, "declared-platform"),
])
def test_inventory_from_the_env(monkeypatch, visible, platform, n, fake,
                                basis):
    if visible is None:
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    else:
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
    inv = scaling.inventory()
    assert (inv["source"], inv["platform"], inv["n_devices"], inv["fake"],
            inv["fake_basis"]) == ("env", platform, n, fake, basis)


def test_inventory_probed_on_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    j = tmp_path / "j.jsonl"
    monkeypatch.setenv("TPKT_HEALTH_JOURNAL", str(j))
    inv = scaling.emit_inventory("test-site", probe=True)
    assert (inv["source"], inv["platform"], inv["device_kind"],
            inv["process_index"], inv["process_count"], inv["fake"],
            inv["fake_basis"]) == ("torch", "cpu", "cpu", 0, 1, True,
                                   "probe")
    (ev,) = _events(j, "device_inventory")
    assert ev["site"] == "test-site" and ev["platform"] == "cpu"


def test_a_failed_probe_is_fake_whatever_the_env_says(monkeypatch):
    def boom():
        raise RuntimeError("no runtime")

    monkeypatch.setattr(torch.cuda, "is_available", boom)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    inv = scaling.inventory(probe=True)
    assert inv["source"] == "env" and inv["platform"] == "cuda"
    assert inv["fake"] is True and inv["fake_basis"] == "unprobed-fallback"


def test_the_env_inventory_imports_no_torch():
    code = ("import sys\n"
            "from tpukernels_torch.obs import scaling\n"
            "scaling.emit_inventory('x')\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] == "
            "'torch'))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, timeout=120,
                       env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"


def test_jax_is_on_the_cpu():
    # the reference side of these tests runs on the CPU
    assert jax.default_backend() == "cpu"
