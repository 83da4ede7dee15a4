"""The bench half of ``tpukernels_torch/obs/trend.py`` on the CPU, after
the trend part of the reference's ``tests/test_obs.py`` and the verdict
rules of its ``tests/test_roofline.py``: the series over the H100 lines
of the bench dir (nulls, invalidated raws, the nested pointer once), the
verdicts held against the reference's ``trend.analyze`` on the same
series, ``below_roofline`` only ever replacing ``ok``, the report's
``--check`` gating on ``regression`` and ``impossible`` alone."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from tpukernels.obs import trend as ref_trend
from tpukernels_torch import bench
from tpukernels_torch.obs import trend
from tpukernels_torch.tuning import roofline

ROOT = Path(__file__).resolve().parent.parent
SGEMM_CEILING = bench.ceilings()["sgemm_gflops"]


@pytest.fixture(autouse=True)
def bench_dir(tmp_path, monkeypatch):
    for k in [k for k in os.environ if k.startswith(("TPKT_", "TPK_"))]:
        monkeypatch.delenv(k)
    d = tmp_path / "bench"
    d.mkdir()
    monkeypatch.setenv("TPKT_BENCH_DIR", str(d))
    monkeypatch.setenv("TPKT_BENCH_BASELINE", str(tmp_path / "base.json"))
    return d


def _baseline(tmp_path, measured):
    (tmp_path / "base.json").write_text(json.dumps({"measured": measured}))


def _line(details, **extra):
    return {"metric": "sgemm_gflops_per_chip", "value": None,
            "unit": "GFLOPS", "details": details, "device": "h100",
            **extra}


def _logs(bench_dir, logs):
    for name, line in logs.items():
        (bench_dir / name).write_text(json.dumps(line))


def test_bands_mirror_bench_constants():
    assert trend.CEILING_EPS == bench._CEILING_EPS
    assert trend.REGRESSION_TOL == bench._REGRESSION_TOL


def test_load_baseline_is_the_ports_file_with_computed_ceilings(
        tmp_path, monkeypatch):
    _baseline(tmp_path, {"nbody_ginter_s": 2000.0})
    base = trend.load_baseline()
    assert base["measured"] == {"nbody_ginter_s": 2000.0}
    assert base["ceilings"] == bench.ceilings()
    monkeypatch.delenv("TPKT_BENCH_BASELINE")
    committed = json.loads((ROOT / "tpukernels_torch" /
                            "baseline_h100.json").read_text())
    assert trend.load_baseline()["measured"] == committed["measured"]
    monkeypatch.setenv("TPKT_BENCH_BASELINE", str(tmp_path / "none.json"))
    assert trend.load_baseline() == {"ceilings": bench.ceilings()}


def test_trend_flags_regression_beyond_eps_band(tmp_path, bench_dir):
    _baseline(tmp_path, {"m": 100.0})
    _logs(bench_dir, {"bench_2026-08-01_000000.json": _line({"m": 100.0}),
                      "bench_2026-08-02_000000.json": _line({"m": 97.0})})
    v = trend.analyze_repo()["m"]
    assert v["verdict"] == "regression"
    assert v["latest"] == 97.0 and v["best"] == 100.0
    assert any("REGRESSION" in f for f in v["flags"])


def test_trend_within_band_is_ok(tmp_path, bench_dir):
    _baseline(tmp_path, {"m": 100.0})
    _logs(bench_dir, {"bench_2026-08-01_000000.json": _line({"m": 100.0}),
                      "bench_2026-08-02_000000.json": _line({"m": 99.5})})
    assert trend.analyze_repo()["m"]["verdict"] == "ok"


def test_trend_flags_impossible_value_over_the_computed_ceiling(bench_dir):
    drift = round(SGEMM_CEILING * 1.2, 1)
    _logs(bench_dir, {"bench_2026-08-01_000000.json": _line(
        {"sgemm_gflops": drift})})
    v = trend.analyze_repo()["sgemm_gflops"]
    assert v["verdict"] == "impossible"
    assert any("IMPOSSIBLE" in f and str(drift) in f for f in v["flags"])


def test_trend_invalidated_at_source_is_not_impossible(bench_dir):
    _logs(bench_dir, {"bench_2026-08-01_000000.json": _line(
        {"sgemm_gflops": None},
        invalidated={"sgemm_gflops": [SGEMM_CEILING * 1.2, "drift"]})})
    v = trend.analyze_repo()["sgemm_gflops"]
    assert v["verdict"] == "no_data"
    assert any("already invalidated" in f for f in v["flags"])


def test_trend_unreachable_nulls_are_no_data(tmp_path, bench_dir):
    _baseline(tmp_path, {"sgemm_gflops": 95000.0})
    null = _line({"sgemm_gflops": None, "error": "card unreachable"})
    _logs(bench_dir, {"bench_2026-08-01_000000.json": null,
                      "bench_2026-08-02_000000.json": null})
    v = trend.analyze_repo()["sgemm_gflops"]
    assert v["verdict"] == "no_data" and v["valid_points"] == 0


def test_trend_nested_artifact_contributes_and_dedupes(tmp_path, bench_dir):
    """Unreachable lines pointing at one artifact, and the artifact
    itself: one point, at the artifact's own place."""
    _baseline(tmp_path, {"stencil2d_mcells_s": 2250000.0})
    art = _line({"stencil2d_mcells_s": 2253856.92})
    ptr = _line({"stencil2d_mcells_s": None, "error": "card unreachable",
                 "last_persisted_artifact": {
                     "path": "bench_2026-10-01_000000.json", "line": art}})
    _logs(bench_dir, {"bench_2026-10-01_000000.json": art,
                      "bench_2026-10-02_000000.json": ptr,
                      "bench_2026-10-03_000000.json": ptr})
    v = trend.analyze_repo()["stencil2d_mcells_s"]
    assert v["valid_points"] == 1 and v["latest"] == 2253856.92
    # 67 % of the passes' memory floor on the H100: ok
    assert v["verdict"] == "ok" and v["roofline"]["below"] is False


@pytest.mark.parametrize("line", [
    {"device": "tpu"}, {"device": None}, {"smoke": True}],
    ids=["tpu", "no device", "smoke"])
def test_trend_counts_only_h100_lines(bench_dir, tmp_path, line):
    rec = dict(_line({"nbody_ginter_s": 9999.0}), **line)
    _logs(bench_dir, {"bench_2026-08-01_000000.json": rec})
    (tmp_path / "docs" / "logs").mkdir(parents=True)
    (tmp_path / "docs" / "logs" / "bench_2026-08-02_000000.json").write_text(
        json.dumps(_line({"nbody_ginter_s": 1.0})))
    (tmp_path / "BENCH_r01.json").write_text(json.dumps(
        {"parsed": _line({"nbody_ginter_s": 1.0})}))
    assert trend.load_series() == {}


def test_host_twins_are_no_series_and_never_gate(tmp_path, bench_dir):
    """A ``<metric>_host`` twin moves with the host: a run whose host was
    slower (the skip-captured step's SGEMM child after a full suite on
    the card: 60 065.08 then 43 578.1 host-issued, the graph rate steady)
    gives no verdict and fails no report."""
    _baseline(tmp_path, {"sgemm_gflops": 94213.53})
    _logs(bench_dir, {
        "bench_2026-10-18_170953.json": _line(
            {"sgemm_gflops": 94213.53, "sgemm_gflops_host": 60065.08}),
        "bench_2026-10-18_171019.json": _line(
            {"sgemm_gflops": 94199.38, "sgemm_gflops_host": 43578.1})})
    verdicts = trend.analyze_repo()
    assert set(verdicts) == {"sgemm_gflops"}
    assert verdicts["sgemm_gflops"]["valid_points"] == 2
    assert verdicts["sgemm_gflops"]["verdict"] == "below_roofline"
    r = _report(tmp_path, bench_dir, "--check")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "_host" not in r.stdout


def _random_series(seed):
    """Seeded series over the seven metrics: measured points, nulls and
    invalidated raws, some over the ceilings."""
    rng = np.random.default_rng(seed)
    lim = bench.ceilings()
    series = {}
    for metric in [n for n, _f in bench.BENCH_METRICS]:
        top = lim.get(metric, 4000.0)
        pts = []
        for i in range(int(rng.integers(0, 5))):
            raw = float(round(top * rng.uniform(0.2, 1.1), 2))
            inval = bool(rng.random() < 0.2)
            pts.append({"value": None if inval else raw, "raw": raw,
                        "source": f"bench_{i}.json", "order": (0, i),
                        "invalidated": "drift" if inval else None})
        if pts:
            series[metric] = pts
    measured = {m: float(round(lim.get(m, 4000.0) * rng.uniform(0.2, 1.0),
                               2))
                for m in series if rng.random() < 0.6}
    return series, {"measured": measured, "ceilings": lim}


@pytest.mark.parametrize("seed", range(6))
def test_verdicts_equal_the_references(seed, monkeypatch):
    """The same series and baseline through both ``analyze``: the same
    verdict, latest, best and point count a metric. The two judge the
    roofline against other cards' peaks, so the threshold is 0 here
    (the roofline rules have tests of their own below)."""
    monkeypatch.setenv("TPKT_ROOFLINE_MIN_FRAC", "0")
    monkeypatch.setenv("TPK_ROOFLINE_MIN_FRAC", "0")
    series, baseline = _random_series(seed)
    mine = trend.analyze(series, baseline)
    ref = ref_trend.analyze(series, baseline)
    keys = ("verdict", "latest", "best", "valid_points", "baseline")
    assert {m: {k: v[k] for k in keys} for m, v in mine.items()} == \
        {m: {k: v[k] for k in keys} for m, v in ref.items()}


def test_below_roofline_fires_only_from_ok(tmp_path, bench_dir, monkeypatch):
    _baseline(tmp_path, {"stencil3d_mcells_s": 1030118.54})
    _logs(bench_dir, {"bench_2026-08-01_000000.json": _line(
        {"stencil3d_mcells_s": 1030118.54})})
    v = trend.analyze_repo()["stencil3d_mcells_s"]
    assert v["verdict"] == "below_roofline"
    assert v["roofline"]["frac"] == pytest.approx(1030118.54 / 3350000.0)
    assert v["roofline"]["device_kind"] == "h100"
    assert any("BELOW ROOFLINE" in f and "non-gating" in f
               for f in v["flags"])
    monkeypatch.setenv("TPKT_ROOFLINE_MIN_FRAC", "0.1")
    v = trend.analyze_repo()["stencil3d_mcells_s"]
    assert v["verdict"] == "ok" and v["roofline"]["below"] is False


def test_below_roofline_never_fires_on_no_data_or_invalidated(tmp_path,
                                                              bench_dir):
    _baseline(tmp_path, {"stencil3d_mcells_s": 1000000.0})
    _logs(bench_dir, {"bench_2026-08-01_000000.json": _line(
        {"sgemm_gflops": None},
        invalidated={"sgemm_gflops": [SGEMM_CEILING * 2, "drift"]})})
    verdicts = trend.analyze_repo()
    for m in ("stencil3d_mcells_s", "sgemm_gflops"):
        assert verdicts[m]["verdict"] == "no_data"
        assert "roofline" not in verdicts[m]


def test_below_roofline_never_masks_regression_or_impossible(tmp_path,
                                                             bench_dir):
    _baseline(tmp_path, {"stencil3d_mcells_s": 1000000.0})
    _logs(bench_dir, {
        "bench_2026-08-01_000000.json": _line(
            {"stencil3d_mcells_s": 1000000.0,
             "sgemm_gflops": SGEMM_CEILING * 1.1}),
        "bench_2026-08-02_000000.json": _line(
            {"stencil3d_mcells_s": 800000.0})})
    verdicts = trend.analyze_repo()
    assert verdicts["stencil3d_mcells_s"]["verdict"] == "regression"
    assert verdicts["sgemm_gflops"]["verdict"] == "impossible"


def _report(tmp_path, bench_dir, *args):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPKT_", "TPK_"))}
    state = tmp_path / "state"
    env.update(PYTHONPATH=str(ROOT), TPKT_BENCH_DIR=str(bench_dir),
               TPKT_BENCH_BASELINE=str(tmp_path / "base.json"),
               TPKT_HEALTH_JOURNAL="0",
               **{k: str(state / k) for k in (
                   "TPKT_SLO_DIR", "TPKT_SCALING_DIR", "TPKT_ROLLUP_DIR",
                   "TPKT_INTEGRITY_DIR", "TPKT_ADAPT_DIR")})
    return subprocess.run([sys.executable, "-m",
                           "tpukernels_torch.obs.report", *args],
                          capture_output=True, text=True, cwd=ROOT,
                          env=env, timeout=120)


def test_obs_report_check_rc0_on_below_roofline(tmp_path, bench_dir):
    _baseline(tmp_path, {"stencil3d_mcells_s": 1030118.54})
    _logs(bench_dir, {"bench_2026-08-01_000000.json": _line(
        {"stencil3d_mcells_s": 1030118.54})})
    r = _report(tmp_path, bench_dir, "--check")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "stencil3d_mcells_s: below_roofline (non-gating)" in r.stdout
    assert "0 bench failing, 0 bench ok, 1 below-roofline (non-gating)" \
        in r.stdout


@pytest.mark.parametrize("case", ["regression", "impossible"])
def test_obs_report_gates_a_bench_regression_or_impossible(tmp_path,
                                                           bench_dir, case):
    _baseline(tmp_path, {"nbody_ginter_s": 2060.0})
    value = 1500.0 if case == "regression" else 4000.0
    _logs(bench_dir, {"bench_2026-08-01_000000.json": _line(
        {"nbody_ginter_s": value})})
    for args in (["--check"], ["--roofline"], []):
        r = _report(tmp_path, bench_dir, *args)
        assert r.returncode == 1, (args, r.stdout + r.stderr)
    r = _report(tmp_path, bench_dir, "--check")
    assert f"nbody_ginter_s: {case}" in r.stdout
    # --eps widens both bands: the ceiling's and the trend's
    r = _report(tmp_path, bench_dir, "--check", "--eps", "0.5")
    assert r.returncode == 0, r.stdout
    full = _report(tmp_path, bench_dir).stdout
    assert "== bench trend (H100 lines in" in full
    assert f"VERDICT: nbody_ginter_s {case}" in full
    assert roofline.MODELS.keys() <= {ln.split()[0] for ln in
                                      full.splitlines() if ln.split()}
