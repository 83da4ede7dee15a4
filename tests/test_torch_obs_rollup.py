"""The port's daily rollups and adapt's multi-day window against the
reference, on the CPU.

``tpukernels_torch/obs/rollup.py``, ``obs/trend.analyze_p99_creep`` and
``serve/adapt.py``'s ``window_days``/``merge_mix``/``window_mix`` get the
inputs of the reference's own cases (``tests/test_telemetry.py``) and
seeded ones, and must give the reference's answers: the same rollup body
(apart from the version stamp, the source sha and the HEAD), the same
series windows and pruning, the same creep verdicts, the same merged
mixes; ``python -m tpukernels_torch.serve.optimize propose`` mines a
three-day window with no traffic today. Every state path is in a
temporary directory.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from tpukernels.obs import rollup as ref_rollup
from tpukernels.obs import trend as ref_trend
from tpukernels.serve import adapt as ref_adapt
from tpukernels_torch.obs import rollup, trend
from tpukernels_torch.resilience import journal
from tpukernels_torch.serve import adapt
from tpukernels_torch.tuning import cache as tcache

ROOT = Path(__file__).resolve().parent.parent

# the stamps that differ between the packages by design
STAMPS = ("jax", "torch", "source_sha", "git_head")


def _snap(pid, seq, counters, hists=None):
    return {"kind": "metrics_snapshot", "pid": pid, "seq": seq,
            "site": "flush:t", "counters": counters, "gauges": {},
            "histograms": hists or {}}


def _req(kernel, n, pad_frac, wall_s, pid=101, ok=True):
    """One serve_request record, SAXPY-shaped (a scalar and two length-n
    operands)."""
    return {"kind": "serve_request", "pid": pid, "kernel": kernel, "ok": ok,
            "shapes": [[], [n], [n]], "dtypes": ["float32"] * 3,
            "pad_frac": pad_frac, "bucketed": True, "wall_s": wall_s,
            "t": 0.0}


# the reference's fixture day (tests/test_telemetry.py)
DAY_EVENTS = (
    [_req("vector_add", 128, 0.875, 0.002)] * 3
    + [_req("vector_add", 64, 0.9, 0.001, ok=False)]
    + [_snap(101, 1, {"serve.requests.vector_add": 2})]
    + [{"kind": "metrics", "pid": 101, "site": "atexit:x",
        "counters": {"serve.requests.vector_add": 3}, "gauges": {},
        "histograms": {}}]
    + [{"kind": "serve_start", "pid": 101}]
)


def _seeded_events(seed, n=120):
    """A seeded day: three kernels, several pids, snapshots and finals,
    failed requests and junk kinds."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        kernel = ["vector_add", "scan", "sgemm"][int(rng.integers(3))]
        pid = int(rng.integers(100, 104))
        shape = int(rng.choice([64, 128, 1000, 4096]))
        out.append(_req(kernel, shape, float(rng.random()),
                        float(rng.lognormal(-6, 1)), pid=pid,
                        ok=bool(rng.random() > 0.1)))
        if i % 17 == 0:
            out.append(_snap(pid, i, {f"serve.requests.{kernel}": 1,
                                      "watchdog.kills": int(i % 3)}))
        if i % 29 == 0:
            out.append({"kind": "span", "pid": pid, "name": "serve/x",
                        "wall_s": 0.001})
    out.append({"kind": "metrics", "pid": 100, "site": "atexit:x",
                "counters": {"serve.requests.scan": 7}, "gauges": {},
                "histograms": {}})
    out.append({"kind": 3})
    return out


@pytest.fixture
def dirs(tmp_path, monkeypatch):
    """Both packages' rollups and journals in ``tmp_path``."""
    monkeypatch.setenv("TPKT_ROLLUP_DIR", str(tmp_path / "roll"))
    monkeypatch.setenv("TPK_ROLLUP_DIR", str(tmp_path / "ref_roll"))
    monkeypatch.setenv("TPKT_HEALTH_JOURNAL", str(tmp_path / "health_t.jsonl"))
    monkeypatch.setenv("TPK_HEALTH_JOURNAL", str(tmp_path / "ref_t.jsonl"))
    rollup.reset()
    ref_rollup.reset()
    yield tmp_path
    rollup.reset()
    ref_rollup.reset()


def _write_journal(path, events):
    Path(path).write_text("".join(json.dumps(e) + "\n" for e in events))


@pytest.mark.parametrize("seed", [None, 0, 1, 2])
def test_build_equals_reference(seed):
    events = DAY_EVENTS if seed is None else _seeded_events(seed)
    got = rollup.build("2026-08-01", events, bad_lines=2)
    want = ref_rollup.build("2026-08-01", events, bad_lines=2)
    assert {k: v for k, v in got.items() if k not in STAMPS} == \
        {k: v for k, v in want.items() if k not in STAMPS}
    assert got["torch"] == tcache.installed_versions()[0]
    assert "jax" not in got
    # pure: the same events give the same bytes
    again = rollup.build("2026-08-01", list(events), bad_lines=2)
    assert json.dumps(got, sort_keys=True) == json.dumps(again,
                                                         sort_keys=True)


def test_write_day_is_byte_identical_and_journaled(dirs):
    day = "2026-08-01"
    jp = dirs / f"health_{day}.jsonl"
    _write_journal(jp, DAY_EVENTS)
    p = rollup.write_day(day, paths=[str(jp)])
    assert os.path.basename(p) == f"rollup_{day}.json"
    assert os.path.dirname(p) == str(dirs / "roll")
    b1 = Path(p).read_bytes()
    rollup.reset()
    assert Path(rollup.write_day(day, paths=[str(jp)])).read_bytes() == b1
    art = rollup.load_day(day)
    assert art["kinds"]["serve_request"] == 4
    assert art["requests"]["vector_add"]["count"] == 3   # OK only
    assert art["counters"]["serve.requests.vector_add"] == 3  # final wins
    assert art["shape_mix"]["vector_add"][0]["count"] == 3
    ev, _ = journal.load_events([str(dirs / "health_t.jsonl")])
    written = [e for e in ev if e["kind"] == "rollup_written"]
    assert len(written) == 2 and written[0]["date"] == day
    assert written[0]["requests"] == 3
    # no events, no rollup
    empty = dirs / "health_2026-08-09.jsonl"
    empty.write_text("")
    assert rollup.write_day("2026-08-09", paths=[str(empty)]) is None


def _rejections(dirs):
    ev, _ = journal.load_events([str(dirs / "health_t.jsonl")])
    return [e for e in ev if e["kind"] == "artifact_rejected"]


@pytest.mark.parametrize("case", ["torn", "schema", "stale_sha", "date",
                                  "torch"])
def test_a_bad_rollup_is_rejected_once(dirs, capsys, case, monkeypatch):
    # the sources' sha as in a git checkout, whether or not this is one
    monkeypatch.setattr(tcache, "source_sha",
                        lambda sources, root=None: "1" * 40)
    day = "2026-08-01"
    jp = dirs / f"health_{day}.jsonl"
    _write_journal(jp, DAY_EVENTS)
    good = json.loads(Path(rollup.write_day(day, paths=[str(jp)]))
                      .read_text())
    bad_day = "2026-08-02"
    p = dirs / "roll" / f"rollup_{bad_day}.json"
    art = dict(good, date=bad_day)
    if case == "torn":
        text = json.dumps(art, indent=1)
        p.write_text(text[: len(text) // 2])
    else:
        if case == "schema":
            art["schema"] = 99
        elif case == "stale_sha":
            art["source_sha"] = "0" * 40
            monkeypatch.setattr(tcache, "source_sha",
                                lambda sources, root=None: "f" * 40)
        elif case == "date":
            art["date"] = day
        elif case == "torch":
            art["torch"] = "0.0.0-stale"
        p.write_text(json.dumps(art))
    capsys.readouterr()
    for _ in range(2):  # once a process and cause
        assert rollup.load_day(bad_day) is None
    err = capsys.readouterr().err
    assert err.count("# rollup rejected: ") == 1, err
    mine = [e for e in _rejections(dirs) if e["path"] == str(p)]
    assert len(mine) == 1, mine
    if case == "stale_sha":
        assert mine[0]["current_sha"] == "f" * 40
    # the series skips the bad day and keeps the good one
    assert [d for d, _ in rollup.load_series()] == \
        ([] if case == "stale_sha" else [day])


def test_series_windows_and_prune_equal_reference(dirs):
    days = ["2020-01-01", "2026-07-30", "2026-08-01", "2026-08-03",
            "2026-08-06"]
    for d in days:
        jp = dirs / f"health_{d}.jsonl"
        _write_journal(jp, _seeded_events(int(d[-2:]), n=20))
        rollup.write_day(d, paths=[str(jp)])
        ref_rollup.write_day(d, paths=[str(jp)])
    assert rollup.rollup_dates() == ref_rollup.rollup_dates() == days
    for days_n, end in ((None, None), (2, None), (3, "2026-08-03"),
                        (None, "2026-07-31"), (9, "2026-08-06"),
                        (1, "2019-01-01")):
        got = [d for d, _ in rollup.load_series(days_n, end)]
        want = [d for d, _ in ref_rollup.load_series(days_n, end)]
        assert got == want, (days_n, end)
    gone = rollup.prune(retention_days=90, today="2026-08-06")
    ref_gone = ref_rollup.prune(retention_days=90, today="2026-08-06")
    assert [os.path.basename(g) for g in gone] == \
        [os.path.basename(g) for g in ref_gone] == ["rollup_2020-01-01.json"]
    assert rollup.prune(retention_days=3, today="2026-08-06") == [
        str(dirs / "roll" / f"rollup_{d}.json")
        for d in ("2026-07-30", "2026-08-01")]


def test_journal_dir_follows_the_knob(tmp_path, monkeypatch):
    monkeypatch.setenv("TPKT_HEALTH_JOURNAL", str(tmp_path))
    assert rollup.journal_dir() == str(tmp_path)
    monkeypatch.setenv("TPKT_HEALTH_JOURNAL", str(tmp_path / "j.jsonl"))
    assert rollup.journal_dir() == str(tmp_path)
    (tmp_path / "health_2026-08-01.jsonl").write_text("{}\n")
    (tmp_path / "health_x.jsonl").write_text("{}\n")
    assert rollup.journal_dates() == {
        "2026-08-01": [str(tmp_path / "health_2026-08-01.jsonl")]}
    for off in ("0", "off", ""):
        monkeypatch.setenv("TPKT_HEALTH_JOURNAL", off)
        assert rollup.journal_dir() is None and rollup.journal_dates() == {}
    monkeypatch.delenv("TPKT_HEALTH_JOURNAL")
    assert rollup.journal_dir() is None
    monkeypatch.delenv("TPKT_ROLLUP_DIR", raising=False)
    assert rollup.rollup_dir() == str(ROOT / ".tpkt_cache" / "rollup")


def _cli(args, env_extra, cwd=ROOT):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPKT_", "TPK_"))}
    env.update(PYTHONPATH=str(ROOT), **env_extra)
    return subprocess.run([sys.executable, "-m", "tpukernels_torch.obs.rollup",
                           *args], capture_output=True, text=True, cwd=cwd,
                          env=env, timeout=120)


def test_cli(tmp_path):
    jd = tmp_path / "journals"
    jd.mkdir()
    _write_journal(jd / "health_2026-08-01.jsonl", DAY_EVENTS)
    _write_journal(jd / "health_2026-08-02.jsonl", [])
    roll = tmp_path / "roll"
    r = _cli([], {"TPKT_HEALTH_JOURNAL": str(jd),
                  "TPKT_ROLLUP_DIR": str(roll)})
    assert r.returncode == 0, r.stdout + r.stderr
    assert "rollup: 1 day(s) written, 1 skipped" in r.stdout
    assert (roll / "rollup_2026-08-01.json").exists()
    r = _cli(["--date", "2026-08-01"], {"TPKT_HEALTH_JOURNAL": str(jd),
                                        "TPKT_ROLLUP_DIR": str(roll)})
    assert r.returncode == 0 and "1 day(s) written, 0 skipped" in r.stdout
    # journaling off: nothing to roll up, and nothing written anywhere
    r = _cli([], {"TPKT_ROLLUP_DIR": str(roll)})
    assert r.returncode == 1 and "no journal" in r.stderr
    assert _cli(["--bogus"], {}).returncode == 2
    assert _cli(["--date"], {}).returncode == 2


# ------------------------------------------------------------ p99 creep

def _day(d, p99, count=50):
    return (d, {"requests": {"scan": {"count": count, "p99": p99}}})


CREEP_SERIES = {
    "drifting": [_day(f"2026-08-0{i}", v) for i, v in
                 enumerate([1.0, 1.01, 1.02, 1.03, 1.2], start=1)],
    "flat": [_day(f"2026-08-0{i}", v) for i, v in
             enumerate([1.0, 1.0, 1.01, 1.0, 1.02], start=1)],
    "spike": [_day(f"2026-08-0{i}", v) for i, v in
              enumerate([1.0, 1.5, 1.0, 1.0, 1.02], start=1)],
    "recover": [_day(f"2026-08-0{i}", v) for i, v in
                enumerate([2.0, 1.0, 1.0, 1.5], start=1)],
    "thin": [_day("2026-08-01", 1.0), _day("2026-08-02", 1.3)],
    "zero": [_day("2026-08-01", 1.0, count=0)],
    "empty": [],
}
CREEP_WANT = {"drifting": "p99_creep", "flat": "ok", "spike": "ok",
              "recover": "ok", "thin": "no_data"}


@pytest.mark.parametrize("name", sorted(CREEP_SERIES))
def test_p99_creep_equals_reference(name):
    series = CREEP_SERIES[name]
    got = trend.analyze_p99_creep(series)
    assert got == ref_trend.analyze_p99_creep(series)
    if name in CREEP_WANT:
        assert got["p99_creep[scan]"]["verdict"] == CREEP_WANT[name]
    else:
        assert got == {}
    assert trend.P99_CREEP_FRAC == ref_trend.P99_CREEP_FRAC
    assert trend.P99_CREEP_MIN_DAYS == ref_trend.P99_CREEP_MIN_DAYS


@pytest.mark.parametrize("seed", range(4))
def test_p99_creep_on_seeded_series_equals_reference(seed):
    rng = np.random.default_rng(seed)
    series = []
    for i in range(int(rng.integers(1, 9))):
        reqs = {}
        for kernel in ("scan", "sgemm", "vector_add"):
            if rng.random() < 0.8:
                reqs[kernel] = {"count": int(rng.integers(0, 5)),
                                "p99": float(rng.lognormal(0, 0.05)) * (
                                    1 + 0.03 * i)}
        series.append((f"2026-08-{i + 1:02d}", {"requests": reqs}))
    assert trend.analyze_p99_creep(series) == \
        ref_trend.analyze_p99_creep(series)


# ------------------------------------------------------- the adapt window

def test_window_days_knob_fails_loud(monkeypatch):
    monkeypatch.delenv("TPKT_ADAPT_WINDOW_DAYS", raising=False)
    assert adapt.window_days() == 1
    monkeypatch.setenv("TPKT_ADAPT_WINDOW_DAYS", "3")
    assert adapt.window_days() == 3
    for bad in ("0", "-1", "1.5", "abc"):
        monkeypatch.setenv("TPKT_ADAPT_WINDOW_DAYS", bad)
        with pytest.raises(ValueError, match="TPKT_ADAPT_WINDOW_DAYS"):
            adapt.window_days()


@pytest.mark.parametrize("seed", range(3))
def test_merge_mix_equals_reference(seed):
    mixes = [adapt.shape_mix(_seeded_events(seed * 10 + k, n=40))
             for k in range(3)]
    mixes.append({"scan": [{"shapes": "junk"}, {"count": 1}]})
    mixes.append(None)
    got = adapt.merge_mix(mixes)
    want = ref_adapt.merge_mix(mixes)
    assert json.dumps(got, sort_keys=True, default=list) == \
        json.dumps(want, sort_keys=True, default=list)
    assert adapt.mix_requests(got) == sum(adapt.mix_requests(m)
                                          for m in mixes[:3])


def test_window_mix_folds_prior_rollups_never_today(dirs):
    today = "2026-08-07"
    for day, n in (("2026-08-05", 4), ("2026-08-06", 6), (today, 9)):
        jp = dirs / f"health_{day}.jsonl"
        _write_journal(jp, [_req("vector_add", 128, 0.5, 0.001)] * n)
        rollup.write_day(day, paths=[str(jp)])
    live = [_req("vector_add", 128, 0.5, 0.001)] * 2
    mix, used = adapt.window_mix(live, days=3, end_date=today)
    assert used == 3 and adapt.mix_requests(mix) == 2 + 4 + 6
    row = mix["vector_add"][0]
    assert row["count"] == 12 and row["pad_frac_sum"] == pytest.approx(6.0)
    mix1, used1 = adapt.window_mix(live, days=1, end_date=today)
    assert used1 == 1 and adapt.mix_requests(mix1) == 2
    mix9, used9 = adapt.window_mix(live, days=9, end_date=today)
    assert used9 == 3 and adapt.mix_requests(mix9) == 12
    # a two-day window takes the nearest prior day
    mix2, used2 = adapt.window_mix(live, days=2, end_date=today)
    assert used2 == 2 and adapt.mix_requests(mix2) == 2 + 6


def test_propose_mines_a_three_day_window_without_traffic_today(dirs):
    # two prior days of (128,) SAXPY traffic against a 1024 avatar: 60
    # requests, pad 0.875
    for day in ("2026-08-05", "2026-08-06"):
        jp = dirs / f"health_{day}.jsonl"
        _write_journal(jp, [_req("vector_add", 128, 0.875, 0.001)] * 30)
        assert rollup.write_day(day, paths=[str(jp)])
    today = dirs / "health_today.jsonl"
    today.write_text("")
    proc_env = {k: v for k, v in os.environ.items()
                if not k.startswith(("TPKT_", "TPK_"))}
    proc_env.update(
        PYTHONPATH=str(ROOT), TPKT_ADAPT_DIR=str(dirs / "adapt"),
        TPKT_ADAPT_WINDOW_DAYS="3", TPKT_HEALTH_JOURNAL=str(today),
        TPKT_ROLLUP_DIR=str(dirs / "roll"),
        TPKT_SERVE_BUCKETS=json.dumps({"vector_add": {
            "args": [["f32", []], ["f32", [1024]], ["f32", [1024]]],
            "statics": {}}}))
    r = subprocess.run([sys.executable, "-m",
                        "tpukernels_torch.serve.optimize", "propose",
                        "--journal", str(today)], cwd=ROOT, env=proc_env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "3-day window" in r.stdout
    assert "2 prior rollup day(s)" in r.stdout
    assert "proposed 1 split(s)" in r.stdout
    cand = json.loads((dirs / "adapt" / "adapt.json").read_text())
    splits = [a for a in cand["proposals"] if a["action"] == "split"]
    assert len(splits) == 1 and splits[0]["kernel"] == "vector_add"
    assert splits[0]["spec"]["args"][1] == ["f32", [128]]
    ev, _ = journal.load_events([str(today)])
    prop = next(e for e in ev if e["kind"] == "adapt_proposed")
    assert prop["window_days"] == 3 and prop["requests_mined"] == 60
