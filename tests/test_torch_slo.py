"""The port's latency-SLO layer against the reference, on the CPU.

``tpukernels_torch/obs/slo.py`` judges the same histograms as the
reference's ``tpukernels/obs/slo.py`` with the same verdicts under the
``cpu|probe`` row (clean, breached, thin, goodput-low, per-tenant and
scaled runs). The port's own rules: an ``nvidia_h100_80gb_hbm3|record``
row and no ``tpu_*`` one; nothing borrowed across device kinds (an
unknown CUDA kind judges ``no_target``); ``slo.json`` validated when
read against the torch and CUDA versions and the kernel sources' sha,
stale entries rejected loudly; the knobs' fail-loud parses; and, on the
real dispatch path, a ``slow_dispatch`` fault that breaches p99 while
p50 stays clean.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tpukernels.obs import slo as ref_slo
from tpukernels_torch import aot
from tpukernels_torch.obs import metrics, slo
from tpukernels_torch.resilience import journal
from tpukernels_torch.tuning import cache as tcache

ROOT = Path(__file__).resolve().parent.parent
H100 = "nvidia_h100_80gb_hbm3"


def _hists(samples: dict) -> dict:
    """``slo.latency_s.<series>`` histogram rows of the port's metrics
    over ``{series: [seconds, ...]}``."""
    metrics.reset()
    for series, vals in samples.items():
        for v in vals:
            metrics.observe(f"slo.latency_s.{series}", v)
    rows = slo.histograms_by_kernel(metrics.snapshot()["histograms"])
    metrics.reset()
    return rows


def _spread(n, lo, hi):
    return [lo + (hi - lo) * i / max(1, n - 1) for i in range(n)]


CASES = {
    "clean": ({k: _spread(40, 1e-4, 2e-3) for k in aot.BENCH_CONFIGS},
              None),
    "breach": ({"scan": _spread(57, 1e-4, 1e-3) + [1.0, 1.0, 1.0],
                "vector_add": _spread(30, 1e-4, 1e-3)}, None),
    "thin": ({"sgemm": [0.9] * 5, "nbody": _spread(19, 1e-3, 0.5)}, None),
    "histogram_rows": ({"histogram": _spread(25, 0.5, 1.4),
                        "scan_histogram": _spread(25, 0.5, 1.6)}, None),
    "goodput": ({"scan@acme": _spread(40, 1e-3, 0.01),
                 "vector_add@acme": _spread(40, 1e-3, 0.01)},
                {"scan@acme": (30, 40), "vector_add@acme": (39, 40)}),
    "unknown": ({"not_a_kernel": _spread(30, 1e-3, 0.01)}, None),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("knobs", [{}, {"SLO_SCALE": "3"},
                                   {"SLO_MIN_REQUESTS": "5"}],
                         ids=["default", "scale3", "min5"])
def test_judge_equals_reference_under_the_cpu_probe_row(case, knobs, tmp_path,
                                                         monkeypatch):
    samples, goodput = CASES[case]
    for k, v in knobs.items():
        monkeypatch.setenv("TPKT_" + k, v)
        monkeypatch.setenv("TPK_" + k, v)
    monkeypatch.setenv("TPKT_HEALTH_JOURNAL", str(tmp_path / "port.jsonl"))
    monkeypatch.setenv("TPK_HEALTH_JOURNAL", str(tmp_path / "ref.jsonl"))
    hists = _hists(samples)
    mine = slo.judge(hists, "cpu", "probe", goodput=goodput)
    theirs = ref_slo.judge(hists, "cpu", "probe", goodput=goodput)
    if case == "unknown":
        # no row: the reference says no_data, the port no_target
        assert [r["verdict"] for r in theirs.values()] == ["no_data"]
        assert [r["verdict"] for r in mine.values()] == ["no_target"]
        return
    assert mine == theirs
    # the journal twin of a breach, one event a breached series each
    port_ev = [e for e in journal.load_events([tmp_path / "port.jsonl"])[0]
               if e["kind"] == "slo_breach"]
    assert [e["kernel"] for e in port_ev] == [
        k for k, r in mine.items() if r["verdict"] == "slo_breach"]
    if case == "breach" and not knobs:
        assert mine["scan"]["verdict"] == "slo_breach"
        assert mine["scan"]["p50_s"] < mine["scan"]["target_p99_s"] / 10
        assert mine["vector_add"]["verdict"] == "ok"
    if case == "goodput" and not knobs:
        assert mine["scan@acme"]["verdict"] == "goodput_low"
        assert mine["vector_add@acme"]["verdict"] == "ok"


def test_target_rows():
    # the reference's CPU row for every registry key; the H100 row for
    # the keys phase 11b measures open loop through the daemon; no TPU
    # row anywhere
    served = {"vector_add", "scan", "sgemm"}
    for name in aot.BENCH_CONFIGS:
        rows = slo.TARGETS[name]
        assert rows["cpu|probe"] == ref_slo.TARGETS[name]["cpu|probe"]
        assert set(rows) == ({"cpu|probe", f"{H100}|record"}
                             if name in served else {"cpu|probe"})
        if name not in served:
            assert slo.resolve_target_s(name, H100, "record") == (
                None, "no_target")
    assert not any("tpu" in row for rows in slo.TARGETS.values()
                   for row in rows)
    assert slo.resolve_target_s("scan", H100, "record") == (
        slo.TARGETS["scan"][f"{H100}|record"] / 1000, "exact")
    assert slo.resolve_target_s("scan@acme", "cpu", "probe") == (0.4,
                                                                 "exact")


@pytest.mark.parametrize("kind,shape_class", [
    ("nvidia_a100_sxm4_40gb", "record"), ("nvidia_a100_sxm4_40gb", "probe"),
    ("nvidia_h100_80gb_hbm3", "probe"), ("tpu_v5_lite", "record"),
    ("tpu_v4", "probe"), ("cpu", "record"), ("cpu", "replay"),
    (H100, "replay")])
def test_no_row_is_borrowed(kind, shape_class):
    assert slo.resolve_target_s("sgemm", kind, shape_class) == (None,
                                                                "no_target")
    (row,) = slo.judge(_hists({"sgemm": _spread(30, 1e-3, 1.0)}), kind,
                       shape_class).values()
    assert row["verdict"] == "no_target" and row["target_p99_s"] is None


def test_knobs_fail_loud(monkeypatch):
    monkeypatch.delenv("TPKT_SLO_SCALE", raising=False)
    monkeypatch.delenv("TPKT_SLO_MIN_REQUESTS", raising=False)
    assert slo.scale() == 1.0 and slo.min_requests() == 20
    for bad in ("0", "-1", "x"):
        monkeypatch.setenv("TPKT_SLO_SCALE", bad)
        with pytest.raises(ValueError, match="TPKT_SLO_SCALE"):
            slo.scale()
    for bad in ("0", "x"):
        monkeypatch.setenv("TPKT_SLO_MIN_REQUESTS", bad)
        with pytest.raises(ValueError, match="TPKT_SLO_MIN_REQUESTS"):
            slo.min_requests()


def test_installed_versions_read_without_torch():
    assert tcache.installed_versions() == (torch.__version__,
                                           torch.version.cuda)
    code = ("import sys\n"
            "from tpukernels_torch.tuning import cache\n"
            "v = cache.installed_versions()\n"
            "assert 'torch' not in sys.modules\n"
            "import torch\n"
            "print(v == (torch.__version__, torch.version.cuda))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, timeout=120,
                       env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "True"


def _row(verdict="slo_breach", simulated=False, kind="cpu"):
    (row,) = slo.judge(_hists({"scan": _spread(30, 1e-3, 1e-2)}), kind,
                       "probe", simulated=simulated).values()
    return dict(row, verdict=verdict)


def test_artifact_validation(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("TPKT_SLO_DIR", str(tmp_path))
    monkeypatch.setenv("TPKT_HEALTH_JOURNAL", str(tmp_path / "j.jsonl"))
    slo.reset()
    here = (torch.__version__, torch.version.cuda)
    p = slo.record({"scan": _row()}, {"seed": 7}, versions=here)
    assert p == str(tmp_path / "slo.json")
    entry = slo.load_entries()["scan|probe|cpu"]
    assert (entry["torch"], entry["cuda"]) == here
    assert entry["run"] == {"seed": 7}
    assert set(slo.breaches()) == {"scan|probe|cpu"}
    # a simulated run has its own key: it never overwrites (nor clears)
    # the real verdict, and never gates
    slo.record({"scan": _row("ok", simulated=True)})
    assert set(slo.load_entries()) == {"scan|probe|cpu",
                                       "scan|probe|cpu|sim"}
    assert set(slo.breaches()) == {"scan|probe|cpu"}
    # another torch, another CUDA: rejected loudly, dropped
    for versions, said in ((("0.0.0", here[1]), "torch 0.0.0"),
                           ((here[0], "0.0"), "CUDA 0.0")):
        slo.reset()
        slo.record({"scan": _row()}, versions=versions)
        assert "scan|probe|cpu" not in slo.load_entries()
        assert said in capsys.readouterr().err
        assert slo.breaches() == {}
    evs = [e for e in journal.load_events([tmp_path / "j.jsonl"])[0]
           if e["kind"] == "slo_rejected"]
    assert len(evs) == 2
    # stale: a commit touching the kernel's sources postdates the sha
    slo.reset()
    slo.record({"scan": _row()}, versions=here)
    if tcache.source_sha(tuple(aot.KERNEL_SOURCES["scan"])) is not None:
        data = json.loads((tmp_path / "slo.json").read_text())
        data["entries"]["scan|probe|cpu"]["source_sha"] = "0" * 40
        (tmp_path / "slo.json").write_text(json.dumps(data))
        assert "scan|probe|cpu" not in slo.load_entries()
        assert "stale" in capsys.readouterr().err
    # torn: reads as empty
    (tmp_path / "slo.json").write_text('{"entries": {"sc')
    slo.reset()
    assert slo.load_entries() == {} and slo.breaches() == {}


def _loadgen(args, env_extra, timeout=300):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPKT_", "TPK_"))}
    env.update(PYTHONPATH=str(ROOT), **env_extra)
    return subprocess.run([sys.executable, "-m", "tpukernels_torch.loadgen",
                           *args], capture_output=True, text=True,
                          timeout=timeout, cwd=ROOT, env=env)


def test_slow_dispatch_fault_breaches_p99_p50_clean(tmp_path):
    """1 s on every 20th scan dispatch breaches p99 while p50 stays two
    orders of magnitude under target; an unfaulted run of the same shape
    is ok. On the port's registry.dispatch path, on the CPU."""
    fault, clean = tmp_path / "faulted", tmp_path / "clean"
    plan = json.dumps({"slow_dispatch": {"kernel": "scan", "delay_s": 1.0,
                                         "every": 20}})
    r = _loadgen(["--kernel", "scan", "--arrivals", "poisson", "--seed", "7",
                  "--requests", "60", "--rate", "6", "--check", "--device",
                  "cpu"],
                 {"TPKT_SLO_DIR": str(fault), "TPKT_FAULT_PLAN": plan,
                  "TPKT_HEALTH_JOURNAL": str(fault / "health.jsonl")})
    assert r.returncode == 1, r.stdout + r.stderr
    assert "BREACH: scan" in r.stdout
    entry = json.loads((fault / "slo.json").read_text())["entries"][
        "scan|probe|cpu"]
    assert entry["verdict"] == "slo_breach"
    assert entry["p99_s"] > entry["target_p99_s"]
    assert entry["p50_s"] < entry["target_p99_s"] / 10
    assert (entry["torch"], entry["cuda"]) == (torch.__version__,
                                               torch.version.cuda)
    ev, _ = journal.load_events([fault / "health.jsonl"])
    assert sum(e["kind"] == "fault_injected"
               and e.get("fault") == "slow_dispatch" for e in ev) == 3
    assert any(e["kind"] == "slo_breach" for e in ev)
    (probe,) = [e for e in ev if e["kind"] == "slo_probe"]
    assert probe["verdicts"]["scan"]["verdict"] == "slo_breach"
    # the targets widened 3x for the clean run: a shared CPU host can
    # stall one request for most of a second, and p99 of 30 is the max
    r = _loadgen(["--kernel", "scan", "--arrivals", "poisson", "--seed", "7",
                  "--requests", "30", "--rate", "10", "--check", "--device",
                  "cpu"],
                 {"TPKT_SLO_DIR": str(clean), "TPKT_SLO_SCALE": "3",
                  "TPKT_HEALTH_JOURNAL": str(clean / "health.jsonl")})
    assert r.returncode == 0, r.stdout + r.stderr
    entries = json.loads((clean / "slo.json").read_text())["entries"]
    assert entries["scan|probe|cpu"]["verdict"] == "ok"
