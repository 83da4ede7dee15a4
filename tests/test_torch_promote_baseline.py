"""``python -m tpukernels_torch.promote_baseline`` on the CPU, after the
reference's ``tests/test_promote_baseline.py``: the union it reads
through the bench's scanner, the medians and provenance it writes into
the port's baseline, and the guard rails (a partial union, a drop past the
gate's tolerance, a jump past 25 %, a value over its ceiling), each held
against the reference's ``tools/promote_baseline.py`` on the same
evidence."""

import datetime
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import bench as ref_bench
from tools import promote_baseline as ref_promote
from tpukernels_torch import bench, promote_baseline

ROOT = Path(__file__).resolve().parent.parent
NAMES = [n for n, _f in bench.BENCH_METRICS]


@pytest.fixture(autouse=True)
def state(tmp_path, monkeypatch):
    for k in [k for k in os.environ if k.startswith(("TPKT_", "TPK_"))]:
        monkeypatch.delenv(k)
    (tmp_path / "bench").mkdir()
    monkeypatch.setenv("TPKT_BENCH_DIR", str(tmp_path / "bench"))
    monkeypatch.setenv("TPKT_BENCH_BASELINE",
                       str(tmp_path / "baseline_h100.json"))
    monkeypatch.setenv("TPKT_HEALTH_JOURNAL", "0")
    monkeypatch.setattr(bench, "_REPO", str(tmp_path))  # no epochs
    return tmp_path


def _stamp():
    return datetime.datetime.now().strftime("bench_%Y-%m-%d_%H%M%S.json")


def _write(tmp_path, details, measured=None, card=True):
    """One artifact of ``details`` and a baseline of ``measured``; the
    port's layout, and the reference's under ``tmp_path/ref``. Returns
    the artifact's name."""
    name = _stamp()
    line = {"value": details.get("sgemm_gflops"), "details": details}
    if card:
        line.update(device="h100", name="NVIDIA H100 80GB HBM3",
                    power_limit_w=700.0, git_head="ab" * 20)
    (tmp_path / "bench" / name).write_text(json.dumps(line))
    base = {"measured": {"measured_on": "2026-10-01", **(measured or {})}}
    (tmp_path / "baseline_h100.json").write_text(json.dumps(base))
    logs = tmp_path / "ref" / "docs" / "logs"
    logs.mkdir(parents=True, exist_ok=True)
    (logs / name).write_text(json.dumps(line))
    (tmp_path / "ref" / "BASELINE.json").write_text(json.dumps(
        dict(base, published={}, ceilings=bench.ceilings())))
    return name


def _full(value=100.0):
    return {n: value for n in NAMES}


def _on_disk(tmp_path):
    return json.loads((tmp_path / "baseline_h100.json").read_text())[
        "measured"]


def test_promotes_full_union_stamps_date_and_provenance(state):
    name = _write(state, _full(123.456), measured={"sgemm_gflops": 120.0})
    promote_baseline.promote(run="R7")
    on_disk = _on_disk(state)
    assert all(on_disk[n] == 123.46 for n in NAMES)
    assert on_disk["measured_on"] == datetime.date.today().isoformat()
    assert on_disk["measured_from"] == {
        "artifact": name, "name": "NVIDIA H100 80GB HBM3",
        "power_limit_w": 700.0, "git_head": "ab" * 20, "run": "R7"}


def test_refuses_partial_union_without_flag(state):
    details = _full()
    del details["stencil3d_mcells_s"]
    _write(state, details, measured={"stencil3d_mcells_s": 83564.0})
    with pytest.raises(promote_baseline.Refused, match="stencil3d"):
        promote_baseline.promote()
    promote_baseline.promote(allow_partial=True)
    on_disk = _on_disk(state)
    assert on_disk["stencil3d_mcells_s"] == 83564.0
    assert on_disk["sgemm_gflops"] == 100.0
    assert "stencil3d_mcells_s" in on_disk["_not_remeasured"]
    assert "2026-10-01" in on_disk["_not_remeasured"]
    assert "measured_from" not in on_disk  # the medians span sessions


def test_full_promotion_clears_partial_note(state):
    _write(state, _full(50.0), measured={"_not_remeasured": "stale"})
    promote_baseline.promote()
    assert "_not_remeasured" not in _on_disk(state)


def test_refuses_implausible_jump_without_flag(state):
    _write(state, _full(130.0), measured={"sgemm_gflops": 100.0})
    with pytest.raises(promote_baseline.Refused, match="above the median"):
        promote_baseline.promote()
    measured, _ = promote_baseline.promote(allow_jump=True)
    assert measured["sgemm_gflops"] == 130.0


def test_refuses_promotion_above_ceiling_even_with_jump_flag(state):
    """The ceiling is the card's bound (``bench.ceilings()``), computed:
    a value 1 % over it is refused whatever the flags."""
    ceiling = bench.ceilings()["sgemm_gflops"]
    _write(state, _full(ceiling * 1.02), measured={"sgemm_gflops": 95000.0})
    with pytest.raises(promote_baseline.Refused, match="ceiling"):
        promote_baseline.promote(allow_jump=True, allow_partial=True)
    # inside the 1 % band: honest captures near their bounds
    lim = bench.ceilings()
    _write(state, {n: lim.get(n, 100.0) * 1.005 for n in NAMES})
    measured, _ = promote_baseline.promote()
    assert measured["sgemm_gflops"] == round(ceiling * 1.005, 2)


def test_refuses_regressed_promotion(state):
    _write(state, _full(50.0), measured={"sgemm_gflops": 100.0})
    with pytest.raises(promote_baseline.Refused, match="regression"):
        promote_baseline.promote()


def test_dry_run_writes_nothing(state):
    _write(state, _full(77.0))
    before = (state / "baseline_h100.json").read_text()
    measured, lines = promote_baseline.promote(dry_run=True)
    assert (state / "baseline_h100.json").read_text() == before
    assert measured["sgemm_gflops"] == 77.0 and len(lines) == len(NAMES)


def test_a_line_not_of_the_card_is_no_evidence(state):
    _write(state, _full(), card=False)
    with pytest.raises(promote_baseline.Refused, match="missing"):
        promote_baseline.promote()


CASES = {
    "full": (_full(100.0), {}, {}),
    "partial": ({n: 100.0 for n in NAMES[:-1]}, {}, {}),
    "partial, allowed": ({n: 100.0 for n in NAMES[:-1]},
                         {NAMES[-1]: 90.0}, {"allow_partial": True}),
    "jump": (_full(130.0), {"sgemm_gflops": 100.0}, {}),
    "jump, allowed": (_full(130.0), {"sgemm_gflops": 100.0},
                      {"allow_jump": True}),
    "drop": (_full(80.0), {"nbody_ginter_s": 100.0}, {}),
    "within the bands": (_full(110.0), {n: 100.0 for n in NAMES}, {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_promotion_equals_the_references(case, state, monkeypatch):
    details, measured, flags = CASES[case]
    _write(state, details, measured=measured)
    monkeypatch.setattr(ref_bench, "_load_baseline", lambda: json.loads(
        (state / "ref" / "BASELINE.json").read_text()))
    try:
        want, _ = ref_promote.promote(root=str(state / "ref"),
                                      dry_run=True, **flags)
    except SystemExit:
        want = None
    try:
        got, _ = promote_baseline.promote(dry_run=True, **flags)
    except promote_baseline.Refused:
        got = None
    assert (got is None) == (want is None)
    if want is not None:
        assert {n: got.get(n) for n in NAMES} == {n: want.get(n)
                                                  for n in NAMES}
        assert got.get("_not_remeasured") == want.get("_not_remeasured")


def test_cli(state):
    _write(state, _full(100.0), measured={"sgemm_gflops": 50.0})
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPKT_", "TPK_"))}
    env.update(PYTHONPATH=str(ROOT), TPKT_HEALTH_JOURNAL="0",
               TPKT_BENCH_DIR=str(state / "bench"),
               TPKT_BENCH_BASELINE=str(state / "baseline_h100.json"))

    def run(*args):
        return subprocess.run(
            [sys.executable, "-m", "tpukernels_torch.promote_baseline",
             *args], capture_output=True, text=True, cwd=ROOT, env=env,
            timeout=120)

    refused = run("--dry-run")
    assert refused.returncode == 1 and "above the median" in refused.stderr
    dry = run("--dry-run", "--allow-jump")
    assert dry.returncode == 0 and "(dry run)" in dry.stdout
    assert _on_disk(state)["sgemm_gflops"] == 50.0
    done = run("--allow-jump", "--run", "T1")
    assert done.returncode == 0 and "sgemm_gflops: 50.0 -> 100.0" in \
        done.stdout
    assert _on_disk(state)["measured_from"]["run"] == "T1"
