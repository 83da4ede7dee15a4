"""The port's tuning loop on the CPU: ``tuning/runner.py`` and ``python -m
tpukernels_torch.autotune``, after the reference's ``tests/test_tuning.py``
(its runner half).

- End to end: ``autotune --kernel sgemm --smoke`` writes a
  ``device_kind=cpu`` entry marked ``smoke``, and a later ``bench --one
  sgemm_gflops`` in smoke mode journals ``tuning_resolved`` from it; a set
  env knob beats the entry for its knob only; outside smoke mode the
  entry is rejected.
- Chaos: a wedged candidate (an env-narrowed ``wedge_metric`` plan) is
  killed after ``TPKT_TUNE_TIMEOUT_S`` and the sweep goes on.
- The rule: the 3 % margin over the control decides promotion; the
  identity the children report keys and stamps the entry; ``--quick`` is
  the control plus single-axis probes of the first knob; an empty sweep
  is rc 2; ``tune_table`` skips keys with no metric.
- The fault points ``enter_metric`` / ``phase_fault``, and each search
  space's metric (the reference's).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from tpukernels import registry as ref_registry
from tpukernels_torch import registry
from tpukernels_torch.resilience import faults
from tpukernels_torch.tuning import cache, runner

ROOT = Path(__file__).resolve().parent.parent


def _env(tmp_path, **extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPKT_", "TPK_"))}
    env.update(PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="",
               TPKT_HEALTH_JOURNAL=str(tmp_path / "health.jsonl"),
               TPKT_AOT_DIR=str(tmp_path / "aot"),
               TPKT_INTEGRITY_DIR=str(tmp_path / "integrity"),
               TPKT_TUNING_CACHE_DIR=str(tmp_path / "tcache"))
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _run(env, module, *args, timeout=420):
    return subprocess.run([sys.executable, "-m", module, *args], env=env,
                          capture_output=True, text=True, timeout=timeout,
                          cwd=ROOT)


def _events(path, kind):
    if not os.path.exists(path):
        return []
    return [r for r in map(json.loads, Path(path).read_text().splitlines())
            if r.get("kind") == kind]


# ------------------------------------------------------------ end to end

def test_autotune_smoke_writes_cache_and_bench_reads_it(tmp_path):
    env = _env(tmp_path)
    proc = _run(env, "tpukernels_torch.autotune", "--kernel", "sgemm",
                "--smoke", "--max-candidates", "2")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "promoted ->" in proc.stdout and "smoke entry" in proc.stdout

    data = json.loads((tmp_path / "tcache" / "tuning.json").read_text())
    key = "sgemm|1024x1024x1024|float32|cpu"
    assert list(data["entries"]) == [key]
    entry = data["entries"][key]
    assert entry["smoke"] is True and entry["cuda"] is None
    assert set(entry["params"]) == {"bm", "bn", "bk", "depth", "order"}

    journal = tmp_path / "health.jsonl"
    cand = _events(journal, "tuning_candidate")
    assert len(cand) == 2 and all(c["status"] == "ok" for c in cand)
    (start,) = _events(journal, "tuning_sweep_start")
    assert start["device_kind"] == "cpu" and start["smoke"] is True
    (promoted,) = _events(journal, "tuning_promoted")
    assert promoted["smoke"] is True and promoted["key"] == key
    (put,) = _events(journal, "tuning_cache_put")
    assert put["key"] == key and put["params"] == entry["params"]
    (end,) = _events(journal, "tuning_sweep_end")
    assert (end["measured"], end["failed"]) == (2, 0)
    # the candidates ran with the cache off: nothing resolved from it
    assert not _events(journal, "tuning_resolved")

    # the read side: bench --one in smoke mode on the same cache
    smoke = dict(env, TPKT_BENCH_SMOKE="1")
    proc = _run(smoke, "tpukernels_torch.bench", "--one", "sgemm_gflops",
                "--device", "cpu")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1])["value"] > 0
    last = _events(journal, "tuning_resolved")[-1]
    assert last["kernel"] == "sgemm"
    assert last["sources"] == dict.fromkeys(entry["params"], "cache")
    assert last["params"] == entry["params"]

    # env beats the cache, for its knob only
    proc = _run(dict(smoke, TPKT_SGEMM_BM="64"), "tpukernels_torch.bench",
                "--one", "sgemm_gflops", "--device", "cpu")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    last = _events(journal, "tuning_resolved")[-1]
    assert last["sources"]["bm"] == "env" and last["params"]["bm"] == 64
    assert last["sources"]["bn"] == "cache"


def test_smoke_entries_are_ignored_outside_smoke(tmp_path, monkeypatch):
    from tpukernels_torch.kernels.sgemm import TUNABLES

    monkeypatch.setenv("TPKT_TUNING_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("TPKT_HEALTH_JOURNAL", str(tmp_path / "j.jsonl"))
    monkeypatch.delenv("TPKT_BENCH_SMOKE", raising=False)
    cache.put(TUNABLES, {"bm": 64}, shape=(32, 32, 32), dtype="float32",
              kind="cpu", smoke=True)
    cache._REJECT_NOTED.clear()
    assert cache.get(TUNABLES, (32, 32, 32), "float32", "cpu") is None
    (rej,) = _events(tmp_path / "j.jsonl", "tuning_rejected")
    assert "smoke" in rej["reason"]
    monkeypatch.setenv("TPKT_BENCH_SMOKE", "1")
    assert cache.get(TUNABLES, (32, 32, 32), "float32", "cpu") == {"bm": 64}
    cache.forget()


# ------------------------------------------------------------------ chaos

def test_wedged_candidate_cannot_eat_the_sweep(tmp_path):
    """An env-narrowed plan wedges the fuse=on candidate at its operand
    phase (immune to SIGALRM); the runner's kill ends it after
    TPKT_TUNE_TIMEOUT_S and the sweep goes on to its decision."""
    plan = {"wedge_metric": {"metric": "scan_hist_melem_s",
                             "phase": "operand",
                             "env": {"TPKT_SCANHIST_FUSE": "on"}}}
    env = _env(tmp_path, TPKT_FAULT_PLAN=json.dumps(plan),
               TPKT_TUNE_TIMEOUT_S=25)
    proc = _run(env, "tpukernels_torch.autotune", "--kernel",
                "scan_histogram", "--smoke")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    journal = tmp_path / "health.jsonl"
    by_fuse = {c["params"]["fuse"]: c["status"]
               for c in _events(journal, "tuning_candidate")}
    assert by_fuse == {"off": "ok", "on": "timeout"}
    fires = _events(journal, "watchdog_fire")
    assert any(f["mechanism"] == "subprocess-kill" for f in fires)
    (wedge,) = [f for f in _events(journal, "fault_injected")
                if f["fault"] == "wedge_metric"]
    assert (wedge["metric"], wedge["phase"]) == ("scan_hist_melem_s",
                                                 "operand")
    (end,) = _events(journal, "tuning_sweep_end")
    assert (end["measured"], end["failed"]) == (1, 1)
    assert end["promoted"] == {"fuse": "off"}


# ------------------------------------------------------------- the rule

IDENT = {"device_kind": "nvidia_h100_80gb_hbm3", "torch": "9.9",
         "cuda": "13.0"}


def _fake_children(monkeypatch, values, seen=None):
    monkeypatch.setattr(runner, "probe_identity",
                        lambda env, timeout_s=240, device=None: dict(IDENT))

    def run_candidate(metric, env, timeout_s, device=None):
        params = {k: env[k] for k in env if k.startswith("TPKT_SCANHIST")}
        if seen is not None:
            seen.append(params)
        return values[env.get("TPKT_SCANHIST_FUSE")], "ok"

    monkeypatch.setattr(runner, "run_candidate", run_candidate)


@pytest.mark.parametrize("on,promoted", [(102.9, False), (103.1, True),
                                         (90.0, False)])
def test_margin_decides_promotion(tmp_path, monkeypatch, on, promoted):
    monkeypatch.setenv("TPKT_TUNING_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("TPKT_HEALTH_JOURNAL", str(tmp_path / "j.jsonl"))
    _fake_children(monkeypatch, {"off": 100.0, "on": on})
    s = runner.tune("scan_histogram")
    assert s["control"]["params"] == {"fuse": "off"}
    assert s["best"]["value"] == max(100.0, on)
    path = tmp_path / "tuning.json"
    if promoted:
        assert s["promoted"]["params"] == {"fuse": "on"}
        key = "scan_histogram|4194304x256|int32|nvidia_h100_80gb_hbm3"
        assert s["cache_key"] == key
        entry = json.loads(path.read_text())["entries"][key]
        assert (entry["value"], entry["control"]) == (on, 100.0)
        assert (entry["torch"], entry["cuda"], entry["smoke"]) == (
            "9.9", "13.0", False)
    else:
        assert s["promoted"] is None and s["cache_key"] is None
        assert not path.exists()
    (end,) = _events(tmp_path / "j.jsonl", "tuning_sweep_end")
    assert end["promoted"] == ({"fuse": "on"} if promoted else None)
    assert runner.PROMOTE_MARGIN == 0.03


def test_quick_is_the_control_and_probes_of_the_first_knob(tmp_path,
                                                           monkeypatch):
    monkeypatch.setenv("TPKT_TUNING_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("TPKT_HEALTH_JOURNAL", str(tmp_path / "j.jsonl"))
    seen = []
    monkeypatch.setattr(runner, "probe_identity",
                        lambda env, timeout_s=240, device=None: dict(IDENT))
    monkeypatch.setattr(runner, "run_candidate",
                        lambda metric, env, t, device=None: (
                            seen.append({k: env[k] for k in env
                                         if k.startswith("TPKT_SGEMM_")})
                            or (1.0, "ok")))
    s = runner.tune("sgemm", quick=True)
    space = registry.tunables("sgemm")
    quick = space.quick_candidates(shape=space.bench_shape)
    assert [r["params"] for r in s["rows"]] == quick
    assert quick[0] == space.defaults() and 1 < len(quick) <= 3
    assert all(c["bm"] != quick[0]["bm"] and
               {k: v for k, v in c.items() if k != "bm"} ==
               {k: v for k, v in quick[0].items() if k != "bm"}
               for c in quick[1:])
    assert seen == [space.env_for(c) for c in quick]
    # every child ran with the tuning cache off
    assert s["promoted"] is None  # equal values: no margin


def test_children_run_with_the_cache_off_and_the_smoke_env(tmp_path,
                                                           monkeypatch):
    monkeypatch.setenv("TPKT_TUNING_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("TPKT_HEALTH_JOURNAL", str(tmp_path / "j.jsonl"))
    envs, devices = [], []
    monkeypatch.setattr(runner, "probe_identity",
                        lambda env, timeout_s=240, device=None:
                        devices.append(device) or dict(IDENT, device_kind="cpu"))
    monkeypatch.setattr(runner, "run_candidate",
                        lambda metric, env, t, device=None: (
                            envs.append(env) or devices.append(device)
                            or (1.0, "ok")))
    runner.tune("scan_histogram", smoke=True)
    assert devices == ["cpu", "cpu", "cpu"]
    for env in envs:
        assert env["TPKT_TUNING_CACHE"] == "0"
        assert env["TPKT_BENCH_SMOKE"] == "1"
        assert env["CUDA_VISIBLE_DEVICES"] == ""
        assert env["TPKT_HEALTH_JOURNAL"] == str(tmp_path / "j.jsonl")


def test_empty_sweep_reports_not_crashes(tmp_path):
    proc = _run(_env(tmp_path), "tpukernels_torch.autotune", "--kernel",
                "vector_add", "--smoke", "--max-candidates", "0")
    assert proc.returncode == 2, proc.stdout + proc.stderr
    assert "no candidate produced a number" in proc.stdout


def test_no_card_is_rc_2_without_a_number(tmp_path):
    """Outside --smoke the identity probe asks for the card: none here,
    so no key can be written and the sweep never starts."""
    proc = _run(_env(tmp_path), "tpukernels_torch.autotune", "--kernel",
                "scan_histogram")
    assert proc.returncode == 2, proc.stdout + proc.stderr
    assert "identity probe failed" in proc.stdout
    assert not (tmp_path / "tcache" / "tuning.json").exists()
    assert not _events(tmp_path / "health.jsonl", "tuning_candidate")


def test_autotune_list_and_usage(tmp_path):
    proc = _run(_env(tmp_path), "tpukernels_torch.autotune", "--list")
    assert proc.returncode == 0, proc.stderr
    rows = {ln.split()[0]: ln for ln in proc.stdout.splitlines()}
    assert set(rows) == set(registry.tunable_kernels())
    assert "metric=sgemm_gflops" in rows["sgemm"]
    assert "TPKT_SCANHIST_FUSE" in rows["scan_histogram"]
    proc = _run(_env(tmp_path), "tpukernels_torch.autotune")
    assert proc.returncode == 2 and "--kernel is required" in proc.stderr


def test_sgemm_tune_forwards_to_autotune(monkeypatch, capsys):
    from tpukernels_torch import autotune, sgemm_tune

    got = []
    monkeypatch.setattr(autotune, "main", lambda argv: got.append(argv) or 0)
    assert sgemm_tune.main(["--quick"]) == 0
    assert got == [["--kernel", "sgemm", "--quick"]]
    assert "deprecated" in capsys.readouterr().err


def test_tune_table_skips_keys_without_a_space(monkeypatch):
    """A key with no search space is skipped loudly; a derived key
    (scan_exclusive) sweeps its base kernel's space, as the port's
    registry.tunables gives it."""
    monkeypatch.setattr(runner, "tune", lambda kernel, **kw: {"k": kernel})
    lines = []
    out = runner.tune_table({"scan_exclusive": {}, "nope": {},
                             "scan_histogram": {}}, echo=lines.append)
    assert out == {"nope": None, "scan_exclusive": {"k": "scan_exclusive"},
                   "scan_histogram": {"k": "scan_histogram"}}
    assert len(lines) == 1 and "'nope'" in lines[0]


def test_probe_identity_fails_without_a_card(tmp_path):
    env = _env(tmp_path)
    assert runner.probe_identity(env, timeout_s=120) is None
    ident = runner.probe_identity(env, timeout_s=120, device="cpu")
    assert ident["device_kind"] == "cpu" and ident["cuda"] is None


def test_integrity_failures_discard_only_the_sweeps_keys(tmp_path):
    path = tmp_path / "j.jsonl"
    lines = [{"kind": "output_integrity_failed", "kernel": k}
             for k in ("scan_histogram", "scan", "sgemm")]
    lines.insert(1, {"kind": "aot_hit"})
    path.write_text("".join(json.dumps(r) + "\n" for r in lines))
    guarded = runner._sweep_guard_kernels("scan", "scan_hist_melem_s")
    assert guarded == {"scan", "histogram", "scan_histogram"}
    assert runner._integrity_failures(str(path), 0, guarded) == 2
    assert runner._aot_hit_ratio(str(path), 0) == 1.0
    size = len(path.read_bytes())
    assert runner._integrity_failures(str(path), size, guarded) == 0
    assert runner._aot_hit_ratio(str(path), size) is None


# ------------------------------------------- fault points and metrics

def test_phase_fault_matches_metric_phase_and_env(monkeypatch, tmp_path):
    monkeypatch.setenv("TPKT_HEALTH_JOURNAL", str(tmp_path / "j.jsonl"))
    plan = {"fail_metric": {"metric": "saxpy_gb_s", "phase": "compile",
                            "env": {"TPKT_X_TEST": "yes"}}}
    monkeypatch.setenv("TPKT_FAULT_PLAN", json.dumps(plan))
    faults.reload_plan()
    try:
        faults.enter_metric("saxpy_gb_s")
        faults.phase_fault("compile")  # env clause unmet
        monkeypatch.setenv("TPKT_X_TEST", "yes")
        faults.phase_fault("execute")  # another phase
        faults.enter_metric("sgemm_gflops")
        faults.phase_fault("compile")  # another metric
        faults.enter_metric("saxpy_gb_s")
        with pytest.raises(RuntimeError, match="injected fault"):
            faults.phase_fault("compile")
        (ev,) = _events(tmp_path / "j.jsonl", "fault_injected")
        assert (ev["fault"], ev["metric"], ev["phase"]) == (
            "fail_metric", "saxpy_gb_s", "compile")
        # a reload forgets the metric: a plan naming one no longer fires
        faults.reload_plan()
        faults.phase_fault("compile")
    finally:
        monkeypatch.delenv("TPKT_FAULT_PLAN")
        faults.reload_plan()
    assert faults._CURRENT_METRIC is None


def test_each_space_measures_through_the_references_metric():
    for name in registry.tunable_kernels():
        assert registry.tunables(name).metric == \
            ref_registry.tunables(name).metric, name
    assert registry.tunables("stencil3d").metric == "stencil3d_mcells_s"
