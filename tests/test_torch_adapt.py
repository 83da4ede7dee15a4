"""The port's adaptive bucket optimizer against the reference, on the CPU.

``tpukernels_torch/serve/adapt.py`` is held against the reference's
``tpukernels/serve/adapt.py`` on identical inputs: the pad projection
(``pad_frac_for``, ``project``), the proposals (``propose``), the
promotion gate (``judge_canary``), the journal miners (``shape_mix``,
``traffic_order``, ``histogram_pad_frac``,
``measured_side``) and the replay spec (``replay_entries``) must give
equal results. Then the port's own parts: its knobs, the ``adapt.json``
artifact validated against the torch and CUDA versions and the sources'
sha, and, end to end with ``TPKT_SERVE_DEVICE=cpu``, the loop (traffic at
a coarse table, ``optimize propose``, a canary win, promotion, the
running daemon's pick-up on ``undrain``) and a rejection that leaves the
incumbent table file untouched.
"""

import copy
import hashlib
import json
import os
import subprocess
import sys

import pytest

from test_torch_serve import ROOT, _daemon
from tpukernels.serve import adapt as ref
from tpukernels_torch.resilience import journal
from tpukernels_torch.serve import adapt, client


def _spec(n, statics=None):
    """A vector_add avatar at array length ``n``."""
    return {"args": [["f32", []], ["f32", [n]], ["f32", [n]]],
            "statics": dict(statics or {})}


def _row(shapes, dtypes=None, count=1, pad_sum=0.0, bucketed=None,
         kernel="vector_add"):
    return {"kernel": kernel, "shapes": [tuple(s) for s in shapes],
            "dtypes": list(dtypes or ["float32"] * len(shapes)),
            "count": count, "pad_frac_sum": pad_sum,
            "bucketed": count if bucketed is None else bucketed}


def _req(kernel, shapes, ok=True, pad_frac=0.0, bucketed=True,
         dtypes=None):
    return {"kind": "serve_request", "kernel": kernel, "ok": ok,
            "shapes": [list(s) for s in shapes],
            "dtypes": dtypes or ["float32"] * len(shapes),
            "pad_frac": pad_frac, "bucketed": bucketed}


# ---------------------------------------------------------------- #
# the pure math, case for case against the reference               #
# ---------------------------------------------------------------- #

PAD_CASES = [
    ([(), (256,), (256,)], ["float32"] * 3, _spec(2048)),
    ([(), (2048,), (2048,)], ["float32"] * 3, _spec(2048)),
    ([(), (4096,), (4096,)], ["float32"] * 3, _spec(2048)),
    ([(), (256, 1), (256,)], ["float32"] * 3, _spec(2048)),
    ([(), (256,), (256,)], ["float32", "int32", "float32"], _spec(2048)),
    ([(256,)], ["float32"], _spec(2048)),
    ([(3_000_000,)], ["int32"], {"args": [["i32", [1 << 22]]],
                                 "statics": {}}),
    ([(), (600_000,), (600_000,)], ["float32"] * 3, _spec(1 << 20)),
    ([(300, 500), (500, 200)], ["float32", "float32"],
     {"args": [["f32", [1024, 1024]], ["f32", [1024, 1024]]],
      "statics": {}}),
]


@pytest.mark.parametrize("case", range(len(PAD_CASES)))
def test_pad_frac_for_equals_reference(case):
    shapes, dtypes, spec = PAD_CASES[case]
    assert adapt.pad_frac_for(shapes, dtypes, spec) == ref.pad_frac_for(
        shapes, dtypes, spec)


TABLES = {
    "one": {"k": {"args": [["f32", [100]]], "statics": {}}},
    "coarse": {"vector_add": _spec(1 << 20)},
    "two": {"vector_add": [_spec(1024), _spec(512)],
            "scan": {"args": [["i32", [4096]]], "statics": {}}},
    "stat": {"k": _spec(1024, statics={"s": 1})},
    "ab": {"a": _spec(1000), "b": _spec(1000)},
}

MIXES = {
    "three": {"k": [_row([(50,)], count=3, kernel="k"),
                    _row([(100,)], count=1, kernel="k"),
                    _row([(200,)], count=2, kernel="k")]},
    "hot": {"vector_add": [_row([(), (4096,), (4096,)], count=40)]},
    "skew": {"vector_add": [_row([(), (300,), (300,)], count=9),
                            _row([(), (512,), (512,)], count=2),
                            _row([(), (1024,), (1024,)], count=1)],
             "scan": [_row([(3000,)], dtypes=["int32"], count=5,
                           kernel="scan")]},
    "k90": {"k": [_row([(), (128,), (128,)], count=90, kernel="k"),
                  _row([(), (1024,), (1024,)], count=10, kernel="k")]},
    "ab": {"a": [_row([(), (10,), (10,)], count=100, kernel="a")],
           "b": [_row([(), (10,), (10,)], count=5, kernel="b")]},
    "none": {},
}

PAIRS = [("one", "three"), ("coarse", "hot"), ("two", "skew"),
         ("stat", "k90"), ("ab", "ab"), ("two", "none"),
         ("coarse", "skew")]


@pytest.mark.parametrize("pair", PAIRS, ids="-".join)
@pytest.mark.parametrize("max_pad", (0.4, 0.5, 1.0))
def test_project_equals_reference(pair, max_pad):
    table, mix = TABLES[pair[0]], MIXES[pair[1]]
    assert adapt.project(table, mix, max_pad) == ref.project(table, mix,
                                                             max_pad)


@pytest.mark.parametrize("pair", PAIRS, ids="-".join)
@pytest.mark.parametrize("target,max_pad,max_splits",
                         [(0.25, 1.0, 4), (0.001, 1.0, 1), (0.25, 0.5, 4),
                          (0.05, 1.0, 2)])
def test_propose_equals_reference(pair, target, max_pad, max_splits):
    table, mix = TABLES[pair[0]], MIXES[pair[1]]
    mine = adapt.propose(mix, table, target, max_pad=max_pad,
                         max_splits=max_splits)
    theirs = ref.propose(copy.deepcopy(mix), copy.deepcopy(table), target,
                         max_pad=max_pad, max_splits=max_splits)
    assert mine == theirs
    assert table == TABLES[pair[0]]  # the incumbent is never mutated


def test_propose_splits_the_hot_shape_on_the_default_table():
    """The card's phase 11c: SAXPY at (600 000,) and the scan at
    (3 000 000,) under the avatars of record propose a split."""
    from tpukernels_torch import aot

    table = {k: {"args": [[kind, list(s)] for kind, s in v["args"]],
                 "statics": v["statics"]}
             for k, v in aot.BENCH_CONFIGS.items()}
    mix = {"vector_add": [_row([(), (600_000,), (600_000,)], count=31)],
           "scan": [_row([(3_000_000,)], dtypes=["int32"], count=29,
                         kernel="scan")]}
    mine = adapt.propose(mix, table, 0.25)
    assert mine == ref.propose(mix, table, 0.25)
    splits = [p for p in mine["proposals"] if p["action"] == "split"]
    assert [p["kernel"] for p in splits] == ["vector_add"]
    assert mine["before"]["pad_frac"] > 0.25 > mine["after"]["pad_frac"]


CANARIES = [
    ({}, {"pad_frac": 0.5, "p99_s": 0.1}, 0.03),
    ({"pad_frac": 0.0, "p99_s": 0.1}, {"pad_frac": 0.0, "p99_s": 0.2}, 0.03),
    ({"pad_frac": 0.98, "p99_s": 0.1}, {"pad_frac": 1.0, "p99_s": 0.2},
     0.03),
    ({"pad_frac": 0.1, "p99_s": 0.2}, {"pad_frac": 0.9, "p99_s": 0.2}, 0.03),
    ({"pad_frac": 0.1, "p99_s": 0.1}, {"pad_frac": 0.9, "p99_s": 0.2}, 0.03),
    ({"pad_frac": 0.1, "p99_s": 0.1}, {"pad_frac": 0.9, "p99_s": 0.2}, None),
    ({"pad_frac": 0.15, "p99_s": 0.4}, {"pad_frac": 0.36, "p99_s": 0.41},
     None),
    ({"pad_frac": 0.35, "p99_s": 0.1}, {"pad_frac": 0.36, "p99_s": 0.2},
     None),
]


@pytest.mark.parametrize("case", range(len(CANARIES)))
def test_judge_canary_equals_reference(case):
    cand, inc, margin = CANARIES[case]
    assert adapt.judge_canary(cand, inc, margin=margin) == ref.judge_canary(
        cand, inc, margin=margin)


EVENTS = (
    [_req("vector_add", [(), (256,), (256,)], pad_frac=0.5)] * 3
    + [_req("vector_add", [(), (1024,), (1024,)])]
    + [_req("vector_add", [(), (256,), (256,)], ok=False)] * 5
    + [_req("scan", [(64,)], dtypes=["int32"], pad_frac=0.25)] * 2
    + [_req("scan", [(64,)], dtypes=["int32"], bucketed=False)]
    + [_req("unknown_kernel", [(8,)])]
    + [{"kind": "bench", "kernel": "vector_add"},
       {"kind": "serve_request", "ok": True}]
    + [{"kind": "metrics", "pid": 1, "histograms": {
        "serve.bucket_pad_frac": {"count": 2, "sum": 1.8}}},
       {"kind": "metrics_snapshot", "pid": 2, "seq": 1, "histograms": {
           "serve.bucket_pad_frac": {"count": 4, "sum": 2.0}}},
       {"kind": "metrics", "pid": 2, "histograms": {
           "serve.bucket_pad_frac": {"count": 6, "sum": 2.4}}}]
    + [{"kind": "slo_probe", "verdicts": {"x": {"p99_s": 0.3, "count": 1}}},
       {"kind": "slo_probe",
        "verdicts": {"x": {"p99_s": 0.1, "count": 3},
                     "y": {"p99_s": 0.2, "count": 1},
                     "z": {"p99_s": None, "count": 4}}}]
)


@pytest.mark.parametrize("n", (0, 4, 12, len(EVENTS)))
def test_miners_equal_reference(n):
    events = EVENTS[:n]
    known = ["scan", "sgemm", "vector_add"]
    assert adapt.shape_mix(events) == ref.shape_mix(events)
    assert adapt.traffic_order(events, known) == ref.traffic_order(events,
                                                                   known)
    assert adapt.histogram_pad_frac(events) == ref.histogram_pad_frac(events)
    assert adapt.measured_side(events) == ref.measured_side(events)


@pytest.mark.parametrize("top", (1, 2, 8))
def test_replay_entries_equal_reference(top):
    table = {"a": _spec(1024, statics={"rows": 8}), "b": _spec(512),
             "vector_add": [_spec(1024), _spec(512)]}
    mix = {"a": [_row([(), (128,), (128,)], count=9, kernel="a"),
                 _row([(), (64,), (64,)], count=2, kernel="a")],
           "b": [_row([(), (32,), (32,)], count=5, kernel="b")],
           "orphan": [_row([(7,)], count=99, kernel="orphan")],
           **MIXES["skew"]}
    assert adapt.replay_entries(mix, table, top=top) == ref.replay_entries(
        mix, table, top=top)


def test_adapt_knobs_fail_loud(monkeypatch):
    for name in ("TPKT_ADAPT_PAD_TARGET", "TPKT_ADAPT_MIN_REQUESTS"):
        monkeypatch.delenv(name, raising=False)
    assert adapt.pad_target() == adapt.DEFAULT_PAD_TARGET == 0.25
    assert adapt.min_requests() == adapt.DEFAULT_MIN_REQUESTS == 50
    assert adapt.PROMOTE_MARGIN == 0.03
    monkeypatch.setenv("TPKT_ADAPT_PAD_TARGET", "0.1")
    assert adapt.pad_target() == 0.1
    for bad in ("0", "1.5", "-0.2", "abc"):
        monkeypatch.setenv("TPKT_ADAPT_PAD_TARGET", bad)
        with pytest.raises(ValueError, match="TPKT_ADAPT_PAD_TARGET"):
            adapt.pad_target()
    monkeypatch.setenv("TPKT_ADAPT_MIN_REQUESTS", "20")
    assert adapt.min_requests() == 20
    for bad in ("0", "-3", "x"):
        monkeypatch.setenv("TPKT_ADAPT_MIN_REQUESTS", bad)
        with pytest.raises(ValueError, match="TPKT_ADAPT_MIN_REQUESTS"):
            adapt.min_requests()


# ---------------------------------------------------------------- #
# the adapt.json artifact                                          #
# ---------------------------------------------------------------- #

def _result(table):
    proj = {"pad_frac": 0.5, "bucketed": 6, "native": 0, "buckets": 1}
    return {"before": dict(proj), "after": dict(proj), "proposals": [],
            "table": table}


def _mix_one(kernel="vector_add", n=256, count=6):
    return {kernel: [_row([(), (n,), (n,)], count=count, kernel=kernel)]}


def test_candidate_artifact_validation(tmp_path, monkeypatch, capsys):
    import torch

    monkeypatch.setenv("TPKT_ADAPT_DIR", str(tmp_path))
    monkeypatch.setenv("TPKT_HEALTH_JOURNAL", str(tmp_path / "j.jsonl"))
    adapt.reset()
    table = {"vector_add": _spec(512)}
    p = adapt.record_candidate(_result(table), _mix_one(), 0.25,
                               versions=("not-this-torch", None))
    assert p == str(tmp_path / "adapt.json")
    data = json.load(open(p))
    assert data["status"] == "proposed" and data["canary"] is None
    assert data["requests_mined"] == 6
    assert data["replay"] == ref.replay_entries(_mix_one(), table)
    assert adapt.load(validate=False)["table"] == table
    # another torch: rejected loudly, never canaried
    assert adapt.load() is None
    err = capsys.readouterr().err
    assert "adapt candidate rejected" in err and "not-this-torch" in err
    evs, _ = journal.load_events([tmp_path / "j.jsonl"])
    assert any(e["kind"] == "adapt_rejected" for e in evs)
    # another CUDA
    adapt.reset()
    adapt.record_candidate(_result(table), _mix_one(), 0.25,
                           versions=(torch.__version__, "0.0"))
    assert adapt.load() is None
    assert "CUDA 0.0" in capsys.readouterr().err
    # stamped by this process (torch never imported for it): valid
    adapt.reset()
    adapt.record_candidate(_result(table), _mix_one(), 0.25)
    data = json.load(open(p))
    assert (data["torch"], data["cuda"]) == (torch.__version__,
                                             torch.version.cuda)
    assert adapt.load()["table"] == table
    # stale: a commit touching the serve sources postdates the sha
    data["source_sha"] = "0" * 40
    with open(p, "w") as f:
        json.dump(data, f)
    adapt.reset()
    from tpukernels_torch.tuning import cache as tcache

    if tcache.source_sha(adapt.SOURCES) is not None:
        assert adapt.load() is None
        assert "stale" in capsys.readouterr().err
    # torn: absent; malformed (no table): rejected before validation
    with open(p, "w") as f:
        f.write('{"status": "propo')
    adapt.reset()
    assert adapt.load() is None
    with open(p, "w") as f:
        json.dump({"status": "proposed"}, f)
    adapt.reset()
    assert adapt.load(validate=False) is None
    assert "malformed" in capsys.readouterr().err


def test_promote_writes_the_stable_buckets_path(tmp_path, monkeypatch):
    monkeypatch.setenv("TPKT_ADAPT_DIR", str(tmp_path / "deep" / "d"))
    table = {"vector_add": [_spec(512), _spec(64)]}
    bp = adapt.promote(table)
    assert bp == adapt.buckets_path() == str(
        tmp_path / "deep" / "d" / "buckets.json")
    assert json.load(open(bp)) == table


# ---------------------------------------------------------------- #
# the loop end to end on the CPU                                   #
# ---------------------------------------------------------------- #

def _tool_env(tmp_path, **extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPKT_", "TPK_"))}
    env.update(PYTHONPATH=str(ROOT), TPKT_SERVE_DEVICE="cpu",
               TPKT_SLO_DIR=str(tmp_path / "slo"),
               TPKT_AOT_DIR=str(tmp_path / "aot"),
               TPKT_INTEGRITY_DIR=str(tmp_path / "integrity"),
               TPKT_TUNING_CACHE_DIR=str(tmp_path / "tuning"))
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _tool(module, args, env, timeout=300):
    return subprocess.run([sys.executable, "-m", module, *args],
                          capture_output=True, text=True, timeout=timeout,
                          cwd=ROOT, env=env)


def _events(path, kind=None):
    recs, _ = journal.load_events([path])
    return [r for r in recs if kind is None or r.get("kind") == kind]


def _sha(path):
    return hashlib.sha256(path.read_bytes()).hexdigest()


def test_adaptive_bucket_loop_end_to_end(tmp_path):
    """Traffic at (4096,) against a 2^22 avatar (99.9 % pad; the padded
    copies make the incumbent's p99 several times the candidate's, well
    above a shared CPU host's stalls) -> propose a split -> the canary
    at one seed promotes it -> the daemon still running picks it up on
    undrain, and the same traffic lands with pad_frac 0."""
    adapt_dir = tmp_path / "adapt"
    adapt_dir.mkdir()
    table = adapt_dir / "buckets.json"
    table.write_text(json.dumps({"vector_add": _spec(1 << 22)}))
    incumbent_bytes = table.read_bytes()
    traffic = tmp_path / "traffic.json"
    traffic.write_text(json.dumps({"entries": [
        {"kernel": "vector_add",
         "args": [["f32", []], ["f32", [4096]], ["f32", [4096]]],
         "statics": {}, "weight": 1.0}]}))
    knobs = dict(TPKT_SERVE_BUCKETS=str(table), TPKT_SERVE_MAX_PAD_FRAC="1.0",
                 TPKT_ADAPT_DIR=str(adapt_dir), TPKT_ADAPT_MIN_REQUESTS="20")
    with _daemon(tmp_path, "traffic", **knobs) as d:
        # 1. live traffic against the incumbent leaves the evidence
        r = _tool("tpukernels_torch.loadgen",
                  ["--serve", d.sock, "--shapes", str(traffic), "--seed",
                   "7", "--requests", "24", "--rate", "100", "--verify"],
                  _tool_env(tmp_path, TPKT_HEALTH_JOURNAL=d.journal))
        assert r.returncode == 0, r.stdout + r.stderr
        mined = [e for e in d.events("serve_request") if e.get("ok")]
        assert len(mined) == 25 and all(e["bucketed"] for e in mined)
        assert all(e["pad_frac"] > 0.9 for e in mined)
        # 2. propose: mine the journal, persist the split candidate
        ops = tmp_path / "ops.jsonl"
        env = _tool_env(tmp_path, TPKT_HEALTH_JOURNAL=ops, **knobs)
        r = _tool("tpukernels_torch.serve.optimize",
                  ["propose", "--journal", str(d.journal)], env)
        assert r.returncode == 0 and "proposed" in r.stdout, (r.stdout
                                                               + r.stderr)
        cand = json.load(open(adapt_dir / "adapt.json"))
        assert cand["status"] == "proposed"
        assert cand["before"]["pad_frac"] > 0.9
        assert cand["after"]["pad_frac"] < 0.25
        assert [s["args"][1][1] for s in cand["table"]["vector_add"]] == [
            [4096]]
        # 3. the canary: the frozen mix against both tables at one seed
        r = _tool("tpukernels_torch.serve.optimize",
                  ["canary", "--seed", "11", "--requests", "16", "--rate",
                   "100", "--check"], env, timeout=420)
        assert r.returncode == 0, r.stdout + r.stderr
        assert "PROMOTED" in r.stdout, r.stdout
        cand = json.load(open(adapt_dir / "adapt.json"))
        assert cand["status"] == "promoted"
        assert cand["canary"]["seed"] == 11
        assert cand["canary"]["verdict"]["promote"] is True
        kinds = {e["kind"] for e in _events(ops)}
        assert {"adapt_proposed", "adapt_canary", "adapt_promoted"} <= kinds
        (canary,) = _events(ops, "adapt_canary")
        assert canary["candidate"]["p99_s"] < canary["incumbent"]["p99_s"]
        # each side ran twice, A/B/B/A, and the candidate won both orders
        assert [o["first"] for o in canary["orders"]] == ["incumbent",
                                                          "candidate"]
        assert all(o["promote"] for o in canary["orders"])
        assert canary["candidate"]["requests"] == 2 * 17
        (promoted,) = _events(ops, "adapt_promoted")
        assert promoted["pad_frac"] == pytest.approx(0.0)
        assert table.read_bytes() != incumbent_bytes
        assert json.loads(table.read_text()) == cand["table"]
        # 4. the running daemon picks the table up on undrain
        with client.ServeClient(d.sock, timeout_s=30) as c:
            reply = c.undrain()
        assert reply["ok"] and reply["reloaded"] == ["vector_add"]
        since = len(d.events("serve_request"))
        r = _tool("tpukernels_torch.loadgen",
                  ["--serve", d.sock, "--shapes", str(traffic), "--seed",
                   "7", "--requests", "24", "--rate", "100"],
                  _tool_env(tmp_path, TPKT_HEALTH_JOURNAL=d.journal))
        assert r.returncode == 0, r.stdout + r.stderr
        served = [e for e in d.events("serve_request")[since:]
                  if e.get("ok")]
        assert len(served) == 25
        assert all(e["bucketed"] and e["pad_frac"] == 0.0
                   and e["bucket"] == "vector_add|-+4096+4096|-"
                   for e in served)
        assert "undrain" in [e["phase"] for e in d.events("serve_drain")]


def test_canary_rejects_non_winning_candidate(tmp_path, monkeypatch):
    """A candidate equal to the incumbent (pad win exactly 0) is
    measured and rejected: status rejected, no buckets.json, the
    incumbent file's bytes unchanged."""
    adapt_dir = tmp_path / "adapt"
    incumbent_path = tmp_path / "incumbent.json"
    incumbent = {"vector_add": _spec(512)}
    incumbent_path.write_text(json.dumps(incumbent))
    sha = _sha(incumbent_path)
    monkeypatch.setenv("TPKT_ADAPT_DIR", str(adapt_dir))
    adapt.record_candidate(_result(incumbent), _mix_one(n=256), 0.25)
    ops = tmp_path / "ops.jsonl"
    env = _tool_env(tmp_path, TPKT_ADAPT_DIR=adapt_dir,
                    TPKT_SERVE_BUCKETS=incumbent_path,
                    TPKT_HEALTH_JOURNAL=ops)
    r = _tool("tpukernels_torch.serve.optimize",
              ["canary", "--seed", "3", "--requests", "6", "--rate", "200",
               "--check"], env, timeout=300)
    assert r.returncode == 1, r.stdout + r.stderr
    assert "REJECTED" in r.stdout and "incumbent stays" in r.stdout
    data = json.load(open(adapt_dir / "adapt.json"))
    assert data["status"] == "rejected"
    assert data["canary"]["verdict"]["promote"] is False
    (canary,) = _events(ops, "adapt_canary")
    assert canary["promote"] is False
    assert canary["reason"].startswith("incumbent first: pad_frac win")
    assert not any(o["promote"] for o in canary["orders"])
    assert canary["incumbent"]["pad_frac"] == pytest.approx(0.5 - 0.5 / 1025)
    assert canary["candidate"]["pad_frac"] == canary["incumbent"]["pad_frac"]
    assert _events(ops, "adapt_rejected")
    assert not _events(ops, "adapt_promoted")
    assert not (adapt_dir / "buckets.json").exists()
    assert _sha(incumbent_path) == sha


@pytest.mark.parametrize("second_wins", (True, False))
def test_canary_needs_a_win_in_both_orders(tmp_path, monkeypatch, capsys,
                                           second_wins):
    """The canary runs incumbent, candidate, candidate, incumbent and
    promotes only when the candidate's p99 wins in both orders: a side
    that is faster only when it runs second (or only when it runs first)
    is rejected, with the order that lost in the reason."""
    from tpukernels_torch.serve import optimize

    table = tmp_path / "incumbent.json"
    table.write_text(json.dumps({"vector_add": _spec(1024)}))
    for k, v in (("TPKT_ADAPT_DIR", tmp_path / "adapt"),
                 ("TPKT_SERVE_BUCKETS", table),
                 ("TPKT_HEALTH_JOURNAL", tmp_path / "ops.jsonl")):
        monkeypatch.setenv(k, str(v))
    adapt.record_candidate(_result({"vector_add": _spec(512)}),
                           _mix_one(n=256), 0.25)
    ran = []

    def side(name, tbl, replay, seed, requests, rate, tmp, echo):
        ran.append(name)
        cand, second = name.startswith("candidate"), name in (
            "candidate-1", "incumbent-2")
        fast = second if second_wins else not second
        return {"pad_frac": 0.1 if cand else 0.5, "requests": 10,
                "bucketed": 10, "dropped": 0,
                "p99_s": 0.2 if fast else 0.3}

    monkeypatch.setattr(optimize, "_run_side", side)
    assert optimize._cmd_canary(3, 10, 5.0, None, check=True) == 1
    assert ran == ["incumbent-1", "candidate-1", "candidate-2",
                   "incumbent-2"]
    (ev,) = _events(tmp_path / "ops.jsonl", "adapt_canary")
    assert [o["promote"] for o in ev["orders"]] == [second_wins,
                                                    not second_wins]
    lost = "candidate" if second_wins else "incumbent"
    assert ev["reason"] == f"{lost} first: p99 did not win (0.3000s vs " \
        "0.2000s)"
    assert ev["candidate"] == {"pad_frac": 0.1, "p99_s": 0.3,
                               "requests": 20, "bucketed": 20, "dropped": 0}
    assert "REJECTED" in capsys.readouterr().out
    assert not (tmp_path / "adapt" / "buckets.json").exists()


def test_optimize_usage(tmp_path):
    env = _tool_env(tmp_path, TPKT_ADAPT_DIR=tmp_path / "adapt",
                    TPKT_HEALTH_JOURNAL=tmp_path / "ops.jsonl")
    r = _tool("tpukernels_torch.serve.optimize", [], env)
    assert r.returncode == 2 and "want a verb" in r.stderr
    r = _tool("tpukernels_torch.serve.optimize",
              ["canary", "--autotune", "slow"], env)
    assert r.returncode == 2 and "known: off, smoke, quick" in r.stderr
    r = _tool("tpukernels_torch.serve.optimize",
              ["canary", "--autotune", "smoke"], env)
    assert r.returncode == 0 and "run propose first" in r.stdout
    r = _tool("tpukernels_torch.serve.optimize", ["canary", "--check"], env)
    assert r.returncode == 1 and "run propose first" in r.stdout
    r = _tool("tpukernels_torch.serve.optimize", ["propose"], env)
    assert r.returncode == 0 and "no proposal" in r.stdout
    r = _tool("tpukernels_torch.serve.optimize", ["show"], env)
    assert r.returncode == 0 and "no adapt.json candidate" in r.stdout


@pytest.mark.parametrize("mode", ("smoke", "quick", "off"))
def test_canary_autotune_retunes_the_candidates_kernels_first(
        tmp_path, monkeypatch, capsys, mode):
    """``--autotune smoke|quick`` re-tunes the kernels the candidate
    table names (``runner.tune_table``, the reference's
    ``serve_optimize``) before any daemon starts; ``off`` tunes
    nothing."""
    from tpukernels_torch.serve import optimize
    from tpukernels_torch.tuning import runner

    for k, v in (("TPKT_ADAPT_DIR", tmp_path / "adapt"),
                 ("TPKT_HEALTH_JOURNAL", tmp_path / "ops.jsonl")):
        monkeypatch.setenv(k, str(v))
    cand = {"vector_add": _spec(512), "scan": _spec(4096)}
    adapt.record_candidate(_result(cand), _mix_one(n=256), 0.25)
    calls = []
    monkeypatch.setattr(runner, "tune_table", lambda table, **kw: calls.append(
        ("tune", sorted(table), kw["smoke"], kw["quick"])) or {})
    monkeypatch.setattr(optimize, "_run_side", lambda name, *a: calls.append(
        ("side", name)) or {"pad_frac": 0.5, "requests": 10, "bucketed": 10,
                            "dropped": 0, "p99_s": 0.2})
    assert optimize._cmd_canary(3, 10, 5.0, None, False, mode) == 0
    sides = [("side", n) for n in ("incumbent-1", "candidate-1",
                                   "candidate-2", "incumbent-2")]
    if mode == "off":
        assert calls == sides
    else:
        assert calls == [("tune", ["scan", "vector_add"], mode == "smoke",
                          mode == "quick")] + sides
        assert f"re-autotuning the candidate table's kernels ({mode})" in \
            capsys.readouterr().out


def test_canary_daemon_that_does_not_start_fails(tmp_path, monkeypatch):
    """A side whose daemon cannot start is rc 1, never a skip."""
    adapt_dir = tmp_path / "adapt"
    monkeypatch.setenv("TPKT_ADAPT_DIR", str(adapt_dir))
    adapt.record_candidate(_result({"vector_add": _spec(512)}),
                           _mix_one(n=256), 0.25)
    # no card (hidden from the children on a host that has one), and no
    # CPU asked for
    env = _tool_env(tmp_path, TPKT_ADAPT_DIR=adapt_dir,
                    TPKT_HEALTH_JOURNAL=tmp_path / "ops.jsonl",
                    CUDA_VISIBLE_DEVICES="")
    env.pop("TPKT_SERVE_DEVICE")
    r = _tool("tpukernels_torch.serve.optimize",
              ["canary", "--requests", "4"], env, timeout=120)
    assert r.returncode == 1, r.stdout + r.stderr
    assert "canary daemon died" in r.stderr
