"""The bench's evidence layer (``tpukernels_torch/bench.py``) on the CPU,
after the reference's ``tests/test_bench_utils.py``:

- the regression gate's 0/1/2 contract, single-run and over the
  persisted union, held against the reference's ``bench.check_regression``
  on the same lines and baseline (its ``_load_baseline`` patched);
- the scanners: newest first by the stamp in the name, the 24 h window,
  invalidated and error lines never counting, the unreachable line's
  pointer, the ``carried`` block, skip-captured in ``main``;
- the git-aware epochs in a temporary repository: a commit to a metric's
  ``.cu`` after an artifact rejects it, loudly;
- where the port differs by design: only an H100 line that is not smoke
  counts, the ``_host`` twins never gate, the baseline is the port's own
  ``baseline_h100.json`` and no TPU artifact is read.
"""

import datetime
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

import bench as ref_bench
from tpukernels_torch import bench
from tpukernels_torch.resilience import journal

ROOT = Path(__file__).resolve().parent.parent
NAMES = [n for n, _f in bench.BENCH_METRICS]
MEDIANS = {n: 1000.0 * (i + 1) for i, n in enumerate(NAMES)}
FMT = "%Y-%m-%d_%H%M%S"


@pytest.fixture(autouse=True)
def evidence(tmp_path, monkeypatch):
    """An empty bench dir and a baseline of :data:`MEDIANS`, both in
    ``tmp_path``; no knob from outside. Returns the bench dir."""
    for k in [k for k in os.environ if k.startswith(("TPKT_", "TPK_"))]:
        monkeypatch.delenv(k)
    bdir = tmp_path / "bench"
    bdir.mkdir()
    base = tmp_path / "baseline_h100.json"
    base.write_text(json.dumps({"measured": dict(MEDIANS,
                                                 measured_on="2026-10-01")}))
    monkeypatch.setenv("TPKT_BENCH_DIR", str(bdir))
    monkeypatch.setenv("TPKT_BENCH_BASELINE", str(base))
    monkeypatch.setenv("TPKT_HEALTH_JOURNAL", str(tmp_path / "health.jsonl"))
    monkeypatch.setenv("TPKT_AOT_DIR", str(tmp_path / "aot"))
    monkeypatch.setenv("TPKT_INTEGRITY_DIR", str(tmp_path / "integrity"))
    monkeypatch.setattr(ref_bench, "_load_baseline",
                        lambda: {"measured": dict(MEDIANS), "published": {}})
    # epochs from a folder outside any checkout unless a test names a
    # repository: this one's newest commit would date the evidence
    monkeypatch.setattr(bench, "_REPO", str(tmp_path))
    yield bdir


def _stamp(hours_ago=0.0):
    return (datetime.datetime.now()
            - datetime.timedelta(hours=hours_ago)).strftime(FMT)


def _line(details, **extra):
    return {"metric": "sgemm_gflops_per_chip",
            "value": details.get("sgemm_gflops"), "unit": "GFLOPS",
            "vs_baseline": None, "details": details, "device": "h100",
            **extra}


def _write(bdir, stamp, details, **extra):
    name = f"bench_{stamp}.json"
    (Path(bdir) / name).write_text(json.dumps(_line(details, **extra)))
    return name


def _full(scale=1.0, **override):
    details = {n: MEDIANS[n] * scale for n in NAMES}
    details.update(override)
    return details


def _judged(details, **extra):
    """A line as the suite prints it: ``vs_measured`` against MEDIANS."""
    return _line(details, vs_measured=bench._ratios_vs_baseline(
        details, {"measured": MEDIANS}), **extra)


def _events(tmp_path, kind):
    recs, _ = journal.load_events([str(tmp_path / "health.jsonl")])
    return [r for r in recs if r.get("kind") == kind]


# ----------------------------------------------------- the single gate

def test_check_regression_gates_on_measured_baseline():
    assert bench.check_regression(json.dumps(_judged(_full(0.99)))) == 0
    slow = _judged(_full(sgemm_gflops=MEDIANS["sgemm_gflops"] * 0.79))
    assert bench.check_regression(json.dumps(slow)) == 1
    assert bench.check_regression(json.dumps(slow), tolerance=0.25) == 0
    # a null headline and a metric without a value are coverage: rc 2
    assert bench.check_regression(json.dumps(_judged(
        _full(sgemm_gflops=None)))) == 2
    assert bench.check_regression(json.dumps(_judged(
        _full(nbody_ginter_s=None)))) == 2
    absent = _full()
    del absent["stencil3d_mcells_s"]
    assert bench.check_regression(json.dumps(_judged(absent))) == 2
    # a regression beside a hole is the more actionable fact: rc 1
    both = _full(sgemm_gflops=MEDIANS["sgemm_gflops"] * 0.79,
                 nbody_ginter_s=None)
    assert bench.check_regression(json.dumps(_judged(both))) == 1


SINGLE_CASES = {
    "ok": _full(0.99),
    "slow": _full(sgemm_gflops=MEDIANS["sgemm_gflops"] * 0.79),
    "at the tolerance": _full(stencil2d_mcells_s=MEDIANS[
        "stencil2d_mcells_s"] * 0.85),
    "under the tolerance": _full(saxpy_gb_s=MEDIANS["saxpy_gb_s"] * 0.849),
    "null headline": _full(sgemm_gflops=None),
    "one null": _full(nbody_ginter_s=None),
    "slow and null": _full(nbody_ginter_s=None,
                           scan_hist_melem_s=MEDIANS[
                               "scan_hist_melem_s"] * 0.5),
    "faster": _full(1.4),
    "zero": _full(saxpy_stream_gb_s=0.0),
}


@pytest.mark.parametrize("case", sorted(SINGLE_CASES))
def test_single_gate_rc_equals_the_references(case, capsys):
    line = _judged(SINGLE_CASES[case])
    ref_line = {k: v for k, v in line.items() if k != "device"}
    want = ref_bench.check_regression(json.dumps(ref_line))
    assert bench.check_regression(json.dumps(line)) == want
    capsys.readouterr()


def _union_case(name, ref_root, bdir):
    """Write one union case's persisted evidence in both layouts (the
    reference's ``docs/logs``, the port's bench dir) and return the line
    it judges."""
    logs = ref_root / "docs" / "logs"
    logs.mkdir(parents=True)

    def persist(hours_ago, details):
        stamp = _stamp(hours_ago)
        _write(bdir, stamp, details)
        (logs / f"bench_{stamp}.json").write_text(json.dumps(
            {"value": details.get("sgemm_gflops"), "details": details}))
        return stamp

    head = {"sgemm_gflops": MEDIANS["sgemm_gflops"]}
    if name == "fresh headline over the rest":
        persist(2, {n: MEDIANS[n] for n in NAMES[1:]})
        return _line(head)
    if name == "headline only carried":
        persist(2, _full())
        return _line({NAMES[-1]: MEDIANS[NAMES[-1]]}, value=None)
    if name == "slow fresh headline":
        persist(2, {n: MEDIANS[n] for n in NAMES[1:]})
        return _line({"sgemm_gflops": MEDIANS["sgemm_gflops"] * 0.5})
    if name == "carried block alone":
        return _line(head, carried={n: [MEDIANS[n], "bench_gone.json"]
                                    for n in NAMES[1:]})
    if name == "one metric absent":
        persist(2, {n: MEDIANS[n] for n in NAMES[1:-1]})
        return _line(head)
    if name == "aged out":
        persist(30, {n: MEDIANS[n] for n in NAMES[1:]})
        return _line(head)
    if name == "newest wins, and it is slow":
        persist(5, {n: MEDIANS[n] for n in NAMES[1:]})
        persist(1, {"nbody_ginter_s": MEDIANS["nbody_ginter_s"] * 0.7})
        return _line(head)
    raise KeyError(name)


UNION_CASES = ("fresh headline over the rest", "headline only carried",
               "slow fresh headline", "carried block alone",
               "one metric absent", "aged out",
               "newest wins, and it is slow")


@pytest.mark.parametrize("case", UNION_CASES)
def test_union_gate_rc_equals_the_references(case, tmp_path, evidence,
                                             capsys):
    line = _union_case(case, tmp_path / "ref", evidence)
    ref_line = {k: v for k, v in line.items() if k != "device"}
    want = ref_bench.check_regression(json.dumps(ref_line),
                                      union_persisted=True,
                                      root=str(tmp_path / "ref"))
    got = bench.check_regression(json.dumps(line), union_persisted=True,
                                 root=str(tmp_path / "ref"))
    assert got == want
    assert want == {"fresh headline over the rest": 0,
                    "headline only carried": 2, "slow fresh headline": 1,
                    "carried block alone": 0, "one metric absent": 2,
                    "aged out": 2, "newest wins, and it is slow": 1}[case]
    capsys.readouterr()


def test_check_regression_refuses_carried_line_without_union(capsys):
    line = _judged(_full(), carried={"nbody_ginter_s": [1.0, "x"]})
    assert bench.check_regression(json.dumps(line)) == 1
    assert "--union-persisted" in capsys.readouterr().out


def test_check_regression_cli(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPKT_", "TPK_"))}
    env.update(PYTHONPATH=str(ROOT), TPKT_HEALTH_JOURNAL="0",
               TPKT_BENCH_DIR=os.environ["TPKT_BENCH_DIR"],
               TPKT_BENCH_BASELINE=os.environ["TPKT_BENCH_BASELINE"])

    def run(line, *flags):
        return subprocess.run(
            [sys.executable, "-m", "tpukernels_torch.bench",
             "--check-regression", *flags], input=json.dumps(line),
            capture_output=True, text=True, cwd=ROOT, env=env, timeout=120)

    ok = run(_judged(_full()))
    assert ok.returncode == 0 and "regression check OK" in ok.stdout
    slow = run(_judged(_full(0.5)))
    assert slow.returncode == 1 and "REGRESSION" in slow.stdout
    hole = run(_judged(_full(nbody_ginter_s=None)))
    assert hole.returncode == 2 and "nbody_ginter_s: FAILED" in hole.stdout
    union = run(_line({"sgemm_gflops": MEDIANS["sgemm_gflops"]}),
                "--union-persisted")
    assert union.returncode == 2 and "persisted union" in union.stdout
    usage = run(_judged(_full()), "--bogus")
    assert usage.returncode == 64 and "usage" in usage.stderr


# --------------------------------------------- where the port differs

def test_host_twins_never_gate(evidence):
    """``<metric>_host`` moves with the host, not the kernel: a twin at a
    tenth of anything, or null, changes no verdict, and none is carried,
    promoted or ratioed."""
    details = _full(**{f"{n}_host": 0.1 for n in NAMES})
    line = _judged(details)
    line["vs_measured"].update({f"{n}_host": 0.1 for n in NAMES})
    assert bench.check_regression(json.dumps(line)) == 0
    nulls = _judged(_full(**{f"{n}_host": None for n in NAMES}))
    assert bench.check_regression(json.dumps(nulls)) == 0
    assert bench._ratios_vs_baseline(
        details, {"measured": {**MEDIANS, "sgemm_gflops_host": 1.0}}) == {
        n: 1.0 for n in NAMES}
    _write(evidence, _stamp(1), {f"{n}_host": 5.0 for n in NAMES})
    assert bench._recent_captured_metrics() == {}


@pytest.mark.parametrize("line", [
    {"device": "tpu"}, {}, {"device": "h100", "smoke": True},
    {"device": "cpu"}], ids=["tpu", "no device", "smoke", "cpu"])
def test_a_tpu_or_smoke_line_never_counts(evidence, line, capsys):
    rec = dict(_judged(_full()), **line)
    if "device" not in line:
        del rec["device"]
    (evidence / f"bench_{_stamp(1)}.json").write_text(json.dumps(rec))
    assert list(bench._iter_bench_artifacts()) == []
    assert bench._recent_captured_metrics() == {}
    assert bench._latest_persisted_artifact() is None
    assert bench.check_regression(json.dumps(rec)) == 2
    assert "not an H100 bench line" in capsys.readouterr().out


def test_no_tpu_artifact_is_read(tmp_path, evidence, monkeypatch):
    """``BENCH_r*.json``, ``docs/logs/`` and ``BASELINE.json`` beside the
    bench dir hold numbers; none reaches the scanners or the gate."""
    (tmp_path / "docs" / "logs").mkdir(parents=True)
    tpu = json.dumps({"value": 9.0, "details": _full()})
    (tmp_path / "docs" / "logs" / f"bench_{_stamp(1)}.json").write_text(tpu)
    (tmp_path / "BENCH_r01.json").write_text(json.dumps({"parsed": tpu}))
    (evidence / "BENCH_r02.json").write_text(tpu)
    (tmp_path / "BASELINE.json").write_text(json.dumps(
        {"measured": {n: 1.0 for n in NAMES}}))
    monkeypatch.chdir(tmp_path)
    assert bench._recent_captured_metrics(root=str(tmp_path)) == {}
    assert bench._latest_persisted_artifact() is None
    assert bench._load_baseline()["measured"]["sgemm_gflops"] == \
        MEDIANS["sgemm_gflops"]


def test_the_baseline_is_the_ports_file(monkeypatch, tmp_path):
    monkeypatch.delenv("TPKT_BENCH_BASELINE")
    from tpukernels_torch import _cachedir

    assert _cachedir.bench_baseline_path() == str(
        ROOT / "tpukernels_torch" / "baseline_h100.json")
    assert "measured" in bench._load_baseline()
    monkeypatch.setenv("TPKT_BENCH_BASELINE", str(tmp_path / "none.json"))
    assert bench._load_baseline() == {}
    (tmp_path / "torn.json").write_text("{")
    monkeypatch.setenv("TPKT_BENCH_BASELINE", str(tmp_path / "torn.json"))
    assert bench._load_baseline() == {}


def test_committed_baseline_holds_seven_h100_medians():
    """``baseline_h100.json``: seven medians promoted from one run on the
    card, each under its ceiling (but the L2-resident SAXPY's), with the
    run's tag, card, power limit and code."""
    data = json.loads((ROOT / "tpukernels_torch" /
                       "baseline_h100.json").read_text())
    measured = data["measured"]
    lim = bench.ceilings()
    for n in NAMES:
        assert bench._is_measurement(measured[n]) and measured[n] > 0, n
        if n in lim:
            assert measured[n] <= lim[n] * (1 + bench._CEILING_EPS), n
    assert re.fullmatch(r"\d{4}-\d{2}-\d{2}", measured["measured_on"])
    src = measured["measured_from"]
    assert src["name"] == "NVIDIA H100 80GB HBM3"
    assert bench._is_measurement(src["power_limit_w"])
    assert re.fullmatch(r"[0-9a-f]{40}", src["git_head"])
    assert src["run"] and src["artifact"].startswith("bench_")
    assert "_not_remeasured" not in measured
    assert "ceilings" not in data and "published" not in data


def test_ratios_vs_baseline_measured_only_and_zero():
    base = {"measured": {"sgemm_gflops": 100.0, "saxpy_gb_s": 50.0,
                         "nbody_ginter_s": 10.0, "measured_on": "x"}}
    got = bench._ratios_vs_baseline(
        {"sgemm_gflops": 100.0, "saxpy_gb_s": 0.0, "nbody_ginter_s": None,
         "stencil2d_mcells_s": 5.0, "bogus": 1.0}, base)
    assert got == {"sgemm_gflops": 1.0, "saxpy_gb_s": 0.0}
    line = _line({**_full(), "saxpy_gb_s": 0.0},
                 vs_measured={"saxpy_gb_s": 0.0})
    assert bench.check_regression(json.dumps(line)) == 1


def test_metric_kernel_sources_cover_all_metrics():
    for name in NAMES:
        srcs = bench._METRIC_KERNEL_SOURCES[name]
        assert "tpukernels_torch/bench.py" in srcs, name
        assert any(s.startswith("tpukernels_torch/kernels/") for s in srcs)
        assert any(s.endswith(".cu") for s in srcs), name
        for s in srcs:
            assert (ROOT / s).is_file(), s
    assert set(bench._METRIC_KERNEL_SOURCES) == set(NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_metric_sources_name_every_include(name):
    """Every header a metric's ``.cu`` files include, directly or through
    another header, is in its sources: a commit to it dates the
    metric's evidence too."""
    srcs = set(bench._METRIC_KERNEL_SOURCES[name])
    todo = [s for s in srcs if s.endswith(".cu")]
    seen = set()
    while todo:
        path = todo.pop()
        for inc in re.findall(r'#include "([^"]+)"',
                              (ROOT / path).read_text()):
            dep = f"tpukernels_torch/csrc/{inc}"
            assert dep in srcs, (name, path, dep)
            if dep not in seen:
                seen.add(dep)
                todo.append(dep)


def test_artifact_stamp_reads_the_name_only():
    stamp = _stamp(0)
    want = datetime.datetime.strptime(stamp, FMT).timestamp()
    assert bench._artifact_stamp(f"/x/y/bench_{stamp}.json") == want
    for bad in ("bench_x.json", "bench_2026-10-18.json", None, 3):
        assert bench._artifact_stamp(bad) is None


# ------------------------------------------------------- the scanners

def test_latest_persisted_artifact_picks_newest_nonnull(evidence):
    _write(evidence, "2026-07-31_080000", {"sgemm_gflops": 59000.0})
    good = _write(evidence, "2026-07-31_120000", {"sgemm_gflops": 60000.0})
    _write(evidence, "2026-07-31_180000", {"sgemm_gflops": None})
    ptr = bench._latest_persisted_artifact()
    assert ptr["path"] == good and ptr["line"]["value"] == 60000.0
    assert bench._latest_persisted_artifact(str(evidence / "nope")) is None


def test_invalidated_artifact_values_stay_dead(evidence):
    _write(evidence, _stamp(0), {"sgemm_gflops": None},
           invalidated={"sgemm_gflops": [400000.0, "exceeds ceiling"]})
    assert bench._recent_captured_metrics() == {}
    assert bench._latest_persisted_artifact() is None


def test_persisted_artifact_ignores_error_lines(evidence):
    _write(evidence, _stamp(1), {
        "sgemm_gflops": None, "error": "card unreachable",
        "last_persisted_artifact": {"path": "x"}})
    assert bench._latest_persisted_artifact() is None
    assert bench._recent_captured_metrics() == {}


def test_recent_captured_metrics_unions_newest_wins(evidence):
    _write(evidence, _stamp(30), {"sgemm_gflops": 1.0, "saxpy_gb_s": 1.0})
    older = _write(evidence, _stamp(3), {"sgemm_gflops": 2.0,
                                         "saxpy_gb_s": None,
                                         "nbody_ginter_s": 5.0})
    newer = _write(evidence, _stamp(1), {"sgemm_gflops": 3.0})
    _write(evidence, _stamp(-2), {"stencil2d_mcells_s": 9.0})  # future
    (evidence / "bench_garbagename.json").write_text(
        json.dumps(_line({"stencil3d_mcells_s": 4.0})))
    got = bench._recent_captured_metrics()
    assert {n: v for n, (v, _p) in got.items()} == {"sgemm_gflops": 3.0,
                                                     "nbody_ginter_s": 5.0}
    assert got["sgemm_gflops"][1] == newer
    assert got["nbody_ginter_s"][1] == older


def test_unreachable_line_points_at_persisted_artifact(monkeypatch, capsys):
    sentinel = {"path": "bench_x.json", "line": {"value": 1.0}}
    monkeypatch.setattr(bench, "_card_alive", lambda *a, **k: False)
    monkeypatch.setattr(bench, "_latest_persisted_artifact",
                        lambda bench_dir=None: sentinel)
    bench.main()
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["value"] is None and rec["vs_baseline"] is None
    assert rec["details"]["last_persisted_artifact"] == sentinel
    assert rec["vs_measured"] == {}


def _fake_suite(monkeypatch, ran, value=1.0):
    monkeypatch.setattr(bench, "_card_alive", lambda *a, **k: True)

    def child(name, _t):
        ran.append(name)
        return {"value": value, "host": value / 2}, "ok"

    monkeypatch.setattr(bench, "_run_one_subprocess", child)


def test_main_fills_vs_measured_against_the_port_baseline(monkeypatch,
                                                          capsys):
    ran = []
    _fake_suite(monkeypatch, ran, value=2000.0)
    bench.main()
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["vs_baseline"] is None
    assert rec["vs_measured"] == {n: round(2000.0 / MEDIANS[n], 3)
                                  for n in NAMES}
    assert "carried" not in rec and ran == NAMES


def test_main_skip_captured_measures_only_missing(monkeypatch, capsys,
                                                  tmp_path):
    ran = []
    _fake_suite(monkeypatch, ran)
    monkeypatch.setattr(bench, "_recent_captured_metrics", lambda *a, **k: {
        # healthy: carried
        "stencil2d_mcells_s": (MEDIANS["stencil2d_mcells_s"], "bench_x.json"),
        # the headline: re-measured whatever the evidence
        "sgemm_gflops": (MEDIANS["sgemm_gflops"], "bench_x.json"),
        # already under the tolerance: re-measured, never frozen
        "nbody_ginter_s": (0.5 * MEDIANS["nbody_ginter_s"], "bench_x.json"),
    })
    monkeypatch.setenv("TPKT_BENCH_SKIP_CAPTURED", "1")
    bench.main()
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["carried"] == {"stencil2d_mcells_s": [
        MEDIANS["stencil2d_mcells_s"], "bench_x.json"]}
    assert ran == [n for n in NAMES if n != "stencil2d_mcells_s"]
    assert "stencil2d_mcells_s" not in rec["details"]
    assert rec["details"]["sgemm_gflops"] == 1.0
    (ev,) = _events(tmp_path, "skip_captured")
    assert ev["carried"] == ["stencil2d_mcells_s"] and ev["measuring"] == ran
    (end,) = _events(tmp_path, "run_end")
    assert end["carried"] == ["stencil2d_mcells_s"]


def test_skip_captured_off_measures_everything(monkeypatch, capsys,
                                               evidence):
    ran = []
    _fake_suite(monkeypatch, ran)
    _write(evidence, _stamp(1), _full())
    bench.main()
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert ran == NAMES and "carried" not in rec


def test_main_points_wedge_nulls_at_prior_evidence(monkeypatch, capsys,
                                                   evidence):
    art = _write(evidence, _stamp(2), {"nbody_ginter_s": 7.0})
    monkeypatch.setattr(bench, "_card_alive", lambda *a, **k: True)
    monkeypatch.setattr(bench, "_run_one_subprocess", lambda name, t: (
        (None, "timeout") if name == "nbody_ginter_s"
        else ({"value": 1.0, "host": 1.0}, "ok")))
    monkeypatch.setattr(bench.watchdog, "classify_timeout",
                        lambda *a, **k: "slow")
    bench.main()
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["details"]["nbody_ginter_s"] is None
    assert rec["prior_evidence"] == {"nbody_ginter_s": [7.0, art]}


# ------------------------------------------------ the git-aware epochs

def _git_repo(tmp_path, touched, touch_hours_ago=1.0):
    """A repository in ``tmp_path`` with the port's sources, its base
    commit 48 h old and one commit ``touch_hours_ago`` ago to
    ``touched`` (a path under the repository)."""
    def git(*args, date=None):
        env = dict(os.environ, GIT_CONFIG_GLOBAL="/dev/null",
                   GIT_CONFIG_SYSTEM="/dev/null")
        if date:
            env.update(GIT_COMMITTER_DATE=date, GIT_AUTHOR_DATE=date)
        subprocess.run(["git", "-C", str(tmp_path), *args], check=True,
                       capture_output=True, env=env)

    def iso(hours_ago):
        return (datetime.datetime.now() - datetime.timedelta(
            hours=hours_ago)).strftime("%Y-%m-%dT%H:%M:%S")

    tmp_path.mkdir(parents=True, exist_ok=True)
    git("init", "-q")
    git("config", "user.email", "t@test")
    git("config", "user.name", "t")
    for srcs in bench._METRIC_KERNEL_SOURCES.values():
        for s in srcs:
            p = tmp_path / s
            p.parent.mkdir(parents=True, exist_ok=True)
            p.write_text("// 1\n")
    git("add", "-A")
    git("commit", "-qm", "base", date=iso(48))
    (tmp_path / touched).write_text("// 2\n")
    git("add", "-A")
    git("commit", "-qm", f"touch {touched}", date=iso(touch_hours_ago))
    return str(tmp_path)


def test_union_rejects_evidence_predating_a_commit_to_its_cu(tmp_path,
                                                             evidence):
    """An artifact stamped before a commit to ``csrc/sgemm.cu`` no longer
    counts for SGEMM; N-body, whose sources the commit left alone, keeps
    it; an artifact stamped after the commit counts again."""
    root = _git_repo(tmp_path / "repo", "tpukernels_torch/csrc/sgemm.cu")
    _write(evidence, _stamp(2), {"sgemm_gflops": 100.0,
                                 "nbody_ginter_s": 50.0})
    got = bench._recent_captured_metrics(root=root)
    assert "sgemm_gflops" not in got and got["nbody_ginter_s"][0] == 50.0
    _write(evidence, _stamp(0), {"sgemm_gflops": 101.0})
    assert bench._recent_captured_metrics(root=root)["sgemm_gflops"][0] \
        == 101.0


def test_a_shared_header_dates_every_metric_that_includes_it(tmp_path,
                                                             evidence):
    root = _git_repo(tmp_path / "repo", "tpukernels_torch/csrc/common.cuh")
    epochs = bench._metric_evidence_epochs(root)
    assert len(set(epochs.values())) == 1 and None not in epochs.values()
    _write(evidence, _stamp(2), _full())
    assert bench._recent_captured_metrics(root=root) == {}


def test_epochs_are_none_outside_a_checkout(tmp_path):
    assert set(bench._metric_evidence_epochs(str(tmp_path)).values()) == \
        {None}


def test_epoch_rejection_is_never_silent(tmp_path, evidence, capsys):
    root = _git_repo(tmp_path / "repo", "tpukernels_torch/csrc/sgemm.cu")
    art = _write(evidence, _stamp(2), {"sgemm_gflops": 100.0,
                                       "nbody_ginter_s": 50.0})
    rejected = {}
    got = bench._recent_captured_metrics(root=root, rejected=rejected)
    assert "sgemm_gflops" not in got and set(rejected) == {"sgemm_gflops"}
    name, ts = rejected["sgemm_gflops"]
    assert name == art and isinstance(ts, int)
    err = capsys.readouterr().err
    assert "epoch-rejected: sgemm_gflops" in err and art in err
    assert str(ts) in err
    (ev,) = _events(tmp_path, "epoch_rejected")
    assert (ev["metric"], ev["artifact"], ev["blocking_commit_ts"]) == (
        "sgemm_gflops", art, ts)


def test_union_gate_distinguishes_epoch_rejected_from_absent(tmp_path,
                                                             evidence,
                                                             capsys):
    root = _git_repo(tmp_path / "repo", "tpukernels_torch/csrc/nbody.cu")
    _write(evidence, _stamp(2), {"nbody_ginter_s": MEDIANS[
        "nbody_ginter_s"]})
    line = _line({n: MEDIANS[n] for n in NAMES if n != "nbody_ginter_s"})
    assert bench.check_regression(json.dumps(line), union_persisted=True,
                                  root=root) == 2
    out = capsys.readouterr().out
    assert "nbody_ginter_s: FAILED (epoch-rejected:" in out
    assert "re-measure" in out
    for f in evidence.iterdir():
        f.unlink()
    assert bench.check_regression(json.dumps(line), union_persisted=True,
                                  root=root) == 2
    assert "nbody_ginter_s: FAILED (no value in any artifact <24h)" in \
        capsys.readouterr().out


def test_union_reapplies_epoch_filter_to_carried(tmp_path, capsys):
    root = _git_repo(tmp_path / "repo", "tpukernels_torch/csrc/nbody.cu")
    fresh = {n: MEDIANS[n] for n in NAMES if n != "nbody_ginter_s"}
    for hours_ago, want in ((2, 2), (0, 0)):
        line = _line(fresh, carried={"nbody_ginter_s": [
            MEDIANS["nbody_ginter_s"], f"bench_{_stamp(hours_ago)}.json"]})
        assert bench.check_regression(json.dumps(line), union_persisted=True,
                                      root=root) == want
    assert "epoch-rejected" in capsys.readouterr().err
