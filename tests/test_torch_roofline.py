"""``tpukernels_torch/tuning/roofline.py`` on the CPU, after the
reference's ``tests/test_roofline.py``: the H100 row, each metric's
operations and bytes at its configuration of record (held to the
reference's formulas, the scan's operations aside), the two yardsticks
(the roofline and the bench's ceiling, each peak at or under its
ceiling), the knobs, the ``roofline_computed`` event and the report's
``--roofline`` table."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from tpukernels.tuning import roofline as ref_roofline
from tpukernels_torch import bench
from tpukernels_torch.obs import trend
from tpukernels_torch.tuning import roofline

ROOT = Path(__file__).resolve().parent.parent
H100 = roofline.PEAKS["h100"]


@pytest.fixture(autouse=True)
def clean_env(monkeypatch, tmp_path):
    for k in [k for k in os.environ if k.startswith(("TPKT_", "TPK_"))]:
        monkeypatch.delenv(k)
    monkeypatch.setenv("TPKT_HEALTH_JOURNAL", str(tmp_path / "health.jsonl"))


def test_the_h100_row_is_the_data_sheets():
    """NVIDIA's H100 SXM data sheet, dense: 3.35 TB/s, 989 TFLOP/s bf16
    tensor, 67 TFLOP/s fp32; int32 at half of fp32; ``high`` SGEMM as
    three bf16 products. The evidence kind is ``h100``."""
    assert H100 == {"tensor_flops": 989e12, "passes_f32": 3,
                    "fp32_ops": 67e12, "int32_ops": 33.5e12,
                    "hbm_gb_s": 3350.0}
    assert roofline.EVIDENCE_KIND == "h100"
    assert roofline.PRODUCTS == {"high": 3, "float32": 6, "default": 1}
    assert set(roofline.PEAKS) == {"h100", "cpu"}


def test_sgemm_formulas_and_peak():
    m = roofline.MODELS["sgemm_gflops"]
    assert m.config == (1024, 1024, 1024)
    assert m.flops(1024, 1024, 1024) == 2 * 1024**3
    assert m.hbm_bytes(1024, 1024, 1024) == 16 * 1024**2
    p = roofline.peak("sgemm_gflops")
    # 989 TF / 3 products over 2.147 GFLOP: the bench's ceiling
    assert p["bound"] == "compute" and p["device_kind"] == "h100"
    assert p["peak"] == pytest.approx(989e12 / 3 / 1e9)
    assert round(p["peak"], 1) == bench.ceilings()["sgemm_gflops"]
    # at a tiny k the byte leg binds: the model can say so
    t_ops = m.flops(1024, 1024, 8) / (H100["tensor_flops"] / 3)
    t_bytes = m.hbm_bytes(1024, 1024, 8) / (H100["hbm_gb_s"] * 1e9)
    assert t_bytes > t_ops


@pytest.mark.parametrize("metric,flops,hbm_bytes,peak_value,bound", [
    # 6 operations a cell a sweep over 1 B (8 B / k = 8): bytes bind
    ("stencil2d_mcells_s", 6.0 * 4096**2, 4096**2, 3350e9 / 1e6,
     "bandwidth"),
    ("stencil3d_mcells_s", 8.0 * 384**3, 384**3, 3350e9 / 1e6,
     "bandwidth"),
    # 20 fp32 operations a pair, 7 arrays
    ("nbody_ginter_s", 20.0 * 65536**2, 28.0 * 65536, 67e12 / 20 / 1e9,
     "compute"),
    # 3 int32 operations and 12 B an element
    ("scan_hist_melem_s", 3.0 * 2**22, 12.0 * 2**22, 3350e9 / 12 / 1e6,
     "bandwidth"),
    ("saxpy_stream_gb_s", 2.0 * 2**26, 12.0 * 2**26, 3350.0, "bandwidth"),
])
def test_metric_formulas_and_peaks(metric, flops, hbm_bytes, peak_value,
                                   bound):
    m = roofline.MODELS[metric]
    assert m.flops(*m.config) == flops
    assert m.hbm_bytes(*m.config) == hbm_bytes
    p = roofline.peak(metric)
    assert p["bound"] == bound
    assert p["peak"] == pytest.approx(peak_value, rel=1e-9)


@pytest.mark.parametrize("metric", sorted(ref_roofline.MODELS))
def test_bytes_and_work_equal_the_references(metric):
    """The reference's byte and work formulas at its configurations of
    record; its operations too, but the scan's: the TPU model counts
    1536 flops of MXU scan an element, the port's kernels 3 int32
    operations (the model's note says so)."""
    mine, ref = roofline.MODELS[metric], ref_roofline.MODELS[metric]
    assert mine.config == ref.config and mine.kernel == ref.kernel
    assert mine.hbm_bytes(*mine.config) == ref.hbm_bytes(*ref.config)
    assert mine.work(*mine.config) == ref.work(*ref.config)
    assert mine.artifact == ref.artifact
    if metric == "scan_hist_melem_s":
        assert ref.flops(*ref.config) == 1536.0 * 2**22
        assert mine.flops(*mine.config) == 3.0 * 2**22
        assert "1536" in mine.note and "3 int32" in mine.note
    else:
        assert mine.flops(*mine.config) == ref.flops(*ref.config)
    assert roofline.sgemm_hbm_bytes(300, 200, 100) == \
        ref_roofline.sgemm_hbm_bytes(300, 200, 100)
    assert roofline.KERNEL_METRIC == ref_roofline.KERNEL_METRIC


@pytest.mark.parametrize("metric", sorted(roofline.MODELS))
def test_each_peak_stays_at_or_under_its_ceiling(metric):
    """The roofline is a different yardstick from the bench's ceiling,
    never a higher one: a capture the bench keeps can sit above its
    roofline only where the roofline is the looser of the two. The
    ceilings are rounded to 0.1."""
    ceiling = bench.ceilings().get(metric)
    p = roofline.peak(metric)
    if ceiling is None:
        assert metric == "saxpy_gb_s" and p["artifact"]
        return
    assert p["peak"] <= ceiling + 0.05


def test_the_2d_roofline_is_the_passes_floor_and_its_ceiling_the_ops():
    """1000 sweeps of 4096²: the roofline's time is the passes' memory
    floor, 5.0081 ms; the ceiling's the operations' bound, 1.2508 ms."""
    cells = 4096**2 * 1000 / 1e6
    floor_ms = cells / roofline.peak("stencil2d_mcells_s")["peak"] * 1e3
    ops_ms = cells / bench.ceilings()["stencil2d_mcells_s"] * 1e3
    assert round(floor_ms, 4) == 5.0081 and round(ops_ms, 4) == 1.2508


def test_ceilings_are_the_rooflines_own():
    """One table of H100 peaks: the bench's ceilings come from it."""
    assert bench.ceilings is roofline.ceilings
    assert roofline.ceilings("float32")["sgemm_gflops"] == pytest.approx(
        roofline.ceilings("high")["sgemm_gflops"] / 2, rel=1e-6)


def test_saxpy_l2_resident_is_an_artifact_never_judged():
    p = roofline.peak("saxpy_gb_s")
    assert p["artifact"] is True and p["peak"] == pytest.approx(3350.0)
    for achieved in (4000.0, 10.0):
        assert trend._roofline_check("saxpy_gb_s", achieved)["below"] is \
            False


def test_every_registry_kernel_metric_is_modeled():
    from tpukernels_torch import registry

    for kernel, metric in roofline.KERNEL_METRIC.items():
        assert metric in roofline.MODELS, (kernel, metric)
    assert set(roofline.KERNEL_METRIC) <= set(registry.names())


def test_resolve_kind_fallbacks(monkeypatch):
    row, kind, basis = roofline.resolve_kind()
    assert (kind, basis) == ("h100", "exact") and row is H100
    row, kind, basis = roofline.resolve_kind("h100_sxm_80gb")
    assert row is H100 and basis == "assumed-h100"
    row, kind, basis = roofline.resolve_kind("tpu_v5_lite")
    assert row is roofline.PEAKS["cpu"] and basis == "cpu-fallback"
    monkeypatch.setenv("TPKT_ROOFLINE_DEVICE", "cpu")
    row, kind, basis = roofline.resolve_kind()
    assert (kind, basis) == ("cpu", "exact")
    assert roofline.peak("nbody_ginter_s")["device_kind"] == "cpu"


def test_min_frac_env_fail_loud(monkeypatch):
    assert roofline.min_frac() == 0.5
    monkeypatch.setenv("TPKT_ROOFLINE_MIN_FRAC", "0.25")
    assert roofline.min_frac() == 0.25
    for bad in ("abc", "-0.1", "1.5"):
        monkeypatch.setenv("TPKT_ROOFLINE_MIN_FRAC", bad)
        with pytest.raises(ValueError, match="TPKT_ROOFLINE_MIN_FRAC"):
            roofline.min_frac()


def test_report_rows_emit_roofline_computed(tmp_path):
    verdicts = {"nbody_ginter_s": {"latest": 2000.0, "verdict": "ok"}}
    rows = {r["metric"]: r for r in roofline.report_rows(verdicts)}
    assert set(rows) == set(roofline.MODELS)
    nb = rows["nbody_ginter_s"]
    assert nb["frac"] == pytest.approx(2000.0 / 3350.0)
    assert nb["ceiling"] == 3350.0
    assert nb["ceiling_frac"] == pytest.approx(2000.0 / 3350.0)
    assert rows["saxpy_gb_s"]["ceiling"] is None
    assert rows["sgemm_gflops"]["frac"] is None
    events = [json.loads(ln) for ln in
              (tmp_path / "health.jsonl").read_text().splitlines()]
    (ev,) = [e for e in events if e["kind"] == "roofline_computed"]
    assert ev["device_kind"] == "h100" and ev["basis"] == "exact"
    assert ev["min_frac"] == 0.5 and set(ev["metrics"]) == set(rows)
    assert ev["metrics"]["sgemm_gflops"]["peak"] == 329666.7
    assert ev["metrics"]["nbody_ginter_s"]["frac"] == round(2000 / 3350, 3)


def test_roofline_and_trend_import_no_torch():
    code = ("import sys; import tpukernels_torch.tuning.roofline, "
            "tpukernels_torch.obs.trend, tpukernels_torch.obs.report; "
            "print(sorted(m for m in ('torch', 'numpy', 'jax') "
            "if m in sys.modules))")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, timeout=60,
                       env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert r.returncode == 0 and r.stdout.strip() == "[]", r.stderr


def test_obs_report_roofline_prints_an_h100_row_a_metric(tmp_path):
    bdir = tmp_path / "bench"
    bdir.mkdir()
    (bdir / "bench_2026-10-18_000000.json").write_text(json.dumps(
        {"device": "h100", "value": 95000.0,
         "details": {"sgemm_gflops": 95000.0, "nbody_ginter_s": 2066.0}}))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPKT_", "TPK_"))}
    env.update(PYTHONPATH=str(ROOT), TPKT_BENCH_DIR=str(bdir),
               TPKT_HEALTH_JOURNAL=str(tmp_path / "h.jsonl"))
    r = subprocess.run([sys.executable, "-m", "tpukernels_torch.obs.report",
                        "--roofline"], capture_output=True, text=True,
                       cwd=ROOT, env=env, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "== roofline (h100 peaks, exact; threshold 50%) ==" in r.stdout
    assert "% roofline" in r.stdout and "% ceiling" in r.stdout
    rows = {ln.split()[0]: ln for ln in r.stdout.splitlines()
            if ln.split() and ln.split()[0] in roofline.MODELS}
    assert set(rows) == set(roofline.MODELS)
    assert "28.8%" in rows["sgemm_gflops"]
    assert "below_roofline" in rows["sgemm_gflops"]
    assert "61.7%" in rows["nbody_ginter_s"] and "ok" in rows[
        "nbody_ginter_s"]
    events = [json.loads(ln) for ln in
              (tmp_path / "h.jsonl").read_text().splitlines()]
    assert [e for e in events if e["kind"] == "roofline_computed"]
