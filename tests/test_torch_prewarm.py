"""``python -m tpukernels_torch.prewarm`` on the CPU: a second process
finds every key warm, the reference's exit codes, the spill gate, and two
prewarms writing one manifest at once (mirrors ``tests/test_aot.py``'s
prewarm cases)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from tpukernels_torch import aot, prewarm
from tpukernels_torch.obs import metrics

ROOT = Path(__file__).resolve().parent.parent


def _env(tmp_path, **extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPKT_", "TPK_"))}
    env.update(PYTHONPATH=str(ROOT), TPKT_AOT_DIR=str(tmp_path / "aot"),
               TPKT_INTEGRITY_DIR=str(tmp_path / "integrity"),
               TPKT_TUNING_CACHE_DIR=str(tmp_path / "tuning"), **extra)
    return env


def _prewarm(tmp_path, *args, **extra):
    return subprocess.run(
        [sys.executable, "-m", "tpukernels_torch.prewarm", *args],
        env=_env(tmp_path, **extra), capture_output=True, text=True,
        cwd=ROOT, timeout=600)


def _events(path, kind):
    if not os.path.exists(path):
        return []
    return [e for e in map(json.loads, open(path)) if e.get("kind") == kind]


def test_a_second_process_finds_every_key_warm(tmp_path):
    journals = []
    for tag in ("cold", "warm"):
        j = tmp_path / f"{tag}.jsonl"
        journals.append(j)
        p = _prewarm(tmp_path, "--device", "cpu", TPKT_HEALTH_JOURNAL=str(j))
        assert p.returncode == 0, p.stdout + p.stderr
        assert f"{len(aot.BENCH_CONFIGS)} warmed, 0 failed" in p.stdout
    names = sorted(aot.BENCH_CONFIGS)
    cold, warm = (_events(j, "prewarm_kernel") for j in journals)
    assert [e["kernel"] for e in cold] == names
    assert {e["expected"] for e in cold} == {"miss"}
    assert [e["kernel"] for e in warm] == names
    assert {e["expected"] for e in warm} == {"hit"}
    assert {e["status"] for e in cold + warm} == {"ok"}
    assert len(_events(journals[1], "aot_hit")) == len(names)
    assert not _events(journals[1], "aot_miss")
    for j in journals:
        (start,) = _events(j, "prewarm_start")
        (end,) = _events(j, "prewarm_end")
        assert start["kernels"] == names and start["device"] == "cpu"
        assert end["warmed"] == len(names) and end["failed"] == []
    entries = json.loads((tmp_path / "aot" / "aot.json").read_text())
    assert len(entries["entries"]) == len(names)


def test_usage_errors_exit_2_and_the_layer_off_exits_1(tmp_path):
    bad = _prewarm(tmp_path, "--kernels", "not_a_kernel", "--device", "cpu")
    assert bad.returncode == 2 and "unknown" in bad.stderr
    flag = _prewarm(tmp_path, "--bench", "all")
    assert flag.returncode == 2
    off = _prewarm(tmp_path, "--device", "cpu", TPKT_AOT_CACHE="0")
    assert off.returncode == 1 and "TPKT_AOT_CACHE=0" in off.stderr
    assert not (tmp_path / "aot" / "aot.json").exists()


def test_the_default_is_the_card(tmp_path):
    # no card here: the default device refuses instead of falling back
    p = _prewarm(tmp_path, "--kernels", "scan", CUDA_VISIBLE_DEVICES="")
    assert p.returncode == 2 and "device='cpu'" in p.stderr


def test_check_prints_only_failures_and_the_summary(tmp_path):
    p = _prewarm(tmp_path, "--check", "--kernels", "scan,histogram",
                 "--device", "cpu")
    assert p.returncode == 0, p.stderr
    assert p.stdout.splitlines() == [
        p.stdout.splitlines()[-1]] and "--check: 2 warmed" in p.stdout
    # the journal defaults to a dated file beside the manifest
    assert list((tmp_path / "aot").glob("health_*.jsonl"))


def test_two_prewarms_share_one_manifest(tmp_path):
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tpukernels_torch.prewarm", "--check",
         "--device", "cpu", "--kernels", kernels], env=_env(tmp_path),
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for kernels in ("scan,histogram,nbody", "vector_add,sgemm,stencil2d")]
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, out + err
    entries = json.loads((tmp_path / "aot" / "aot.json").read_text())
    assert sorted(k.split("|")[0].split("@")[0]
                  for k in entries["entries"]) == sorted(
        ["scan", "histogram", "nbody", "vector_add", "sgemm", "stencil2d"])


@pytest.fixture
def isolated(monkeypatch, tmp_path):
    for var in list(os.environ):
        if var.startswith(("TPKT_", "TPK_")):
            monkeypatch.delenv(var)
    monkeypatch.setenv("TPKT_AOT_DIR", str(tmp_path))
    monkeypatch.setenv("TPKT_HEALTH_JOURNAL", str(tmp_path / "j.jsonl"))
    monkeypatch.setenv("TPKT_INTEGRITY_DIR", str(tmp_path / "integrity"))
    aot.reset()
    metrics.reset()
    yield tmp_path
    aot.reset()


@pytest.mark.parametrize("lib,stores,want", [
    ("nbody", 8, 1), ("jacobi2d", 4, 1), ("sgemm", 8, 0), ("nbody", 0, 0)])
def test_a_spill_where_the_design_allows_none_fails(isolated, monkeypatch,
                                                   lib, stores, want):
    from tpukernels_torch import _build

    monkeypatch.setattr(aot, "prewarm_all", lambda names, echo, device: [
        {"kernel": names[0], "key": "k", "expected": "miss", "wall_s": 0.1,
         "build_s": 0.0, "load_s": 0.0, "plan_s": 0.0, "libraries": [lib]}])
    monkeypatch.setattr(_build, "ptxas_report", lambda name: {
        "kernels": 1, "registers_min": 64, "registers": 64,
        "smem_bytes": 0, "spill_stores": stores, "spill_loads": 0,
        "wgmma_serialisation": 0})
    assert prewarm.main(["--kernels", "nbody", "--device", "cpu"]) == want
    (ev,) = _events(isolated / "j.jsonl", "prewarm_kernel")
    assert ev["libraries"][lib]["spill_stores"] == stores
    assert ev["status"] == ("error" if want else "ok")


def test_a_failed_canary_fails_the_prewarm(isolated, monkeypatch, capsys):
    monkeypatch.setenv("TPKT_FAULT_PLAN", json.dumps(
        {"corrupt_output": {"kernel": "scan", "site": "aot"}}))
    from tpukernels_torch.resilience import faults, integrity

    faults.reload_plan()
    integrity.reset()
    try:
        assert prewarm.main(["--kernels", "scan,histogram",
                             "--device", "cpu"]) == 1
    finally:
        monkeypatch.delenv("TPKT_FAULT_PLAN")
        faults.reload_plan()
        integrity.reset()
    assert "scan FAILED: its first-trust canary failed" in \
        capsys.readouterr().err
    (end,) = _events(isolated / "j.jsonl", "prewarm_end")
    assert end["failed"] == ["scan"] and end["warmed"] == 1


def test_order_traffic_ranks_by_the_journals_requests(tmp_path):
    """``--order traffic`` warms the keys in the order of the journal's
    ``serve_request`` counts (the reference's ``adapt.traffic_order``),
    untouched keys after in registry order; with no such evidence it says
    so and keeps registry order."""
    j = tmp_path / "traffic.jsonl"
    reqs = (["vector_add"] * 4 + ["scan"] * 2 + ["sgemm"] * 3
            + ["not_a_key"] * 9)
    j.write_text("".join(json.dumps({"kind": "serve_request", "kernel": k,
                                     "ok": True}) + "\n" for k in reqs))
    p = _prewarm(tmp_path, "--device", "cpu", "--check", "--order",
                 "traffic", "--kernels", "scan,stencil2d,sgemm,vector_add",
                 TPKT_HEALTH_JOURNAL=str(j))
    assert p.returncode == 0, p.stdout + p.stderr
    assert p.stdout.splitlines()[0] == (
        "prewarm: traffic order vector_add=4, sgemm=3, scan=2, stencil2d=0")
    assert [e["kernel"] for e in _events(j, "prewarm_kernel")] == [
        "vector_add", "sgemm", "scan", "stencil2d"]
    quiet = tmp_path / "quiet.jsonl"
    p = _prewarm(tmp_path, "--device", "cpu", "--check", "--order",
                 "traffic", "--kernels", "scan,sgemm",
                 TPKT_HEALTH_JOURNAL=str(quiet))
    assert p.returncode == 0, p.stdout + p.stderr
    assert "keeping registry order" in p.stderr
    assert [e["kernel"] for e in _events(quiet, "prewarm_kernel")] == [
        "scan", "sgemm"]
    p = _prewarm(tmp_path, "--device", "cpu", "--order", "hot")
    assert p.returncode == 2


def test_bench_warms_each_metric_in_a_child(tmp_path):
    """``--bench`` runs one ``bench --prewarm <metric>`` child a metric
    (here in smoke mode on the CPU): each journals a ``prewarm_kernel``
    row with mode bench; a child that refuses (the CPU without
    TPKT_BENCH_SMOKE) fails the prewarm; an unknown metric is usage."""
    j = tmp_path / "j.jsonl"
    p = _prewarm(tmp_path, "--kernels", "vector_add", "--device", "cpu",
                 "--bench", "saxpy_gb_s,scan_hist_melem_s",
                 TPKT_HEALTH_JOURNAL=str(j), TPKT_BENCH_SMOKE="1")
    assert p.returncode == 0, p.stdout + p.stderr
    assert "3 warmed, 0 failed" in p.stdout
    rows = [e for e in _events(j, "prewarm_kernel") if e.get("mode")]
    assert [(e["kernel"], e["mode"], e["status"]) for e in rows] == [
        ("saxpy_gb_s", "bench", "ok"), ("scan_hist_melem_s", "bench", "ok")]
    (start,) = _events(j, "prewarm_start")
    assert start["metrics"] == ["saxpy_gb_s", "scan_hist_melem_s"]
    assert "prewarm complete" in p.stderr and "# slope: timing" not in p.stderr

    p = _prewarm(tmp_path, "--kernels", "vector_add", "--device", "cpu",
                 "--bench", "saxpy_gb_s", TPKT_HEALTH_JOURNAL=str(j))
    assert p.returncode == 1, p.stdout + p.stderr
    assert "bench metric saxpy_gb_s FAILED (error)" in p.stderr

    p = _prewarm(tmp_path, "--device", "cpu", "--bench", "nope")
    assert p.returncode == 2 and "unknown bench metric" in p.stderr
