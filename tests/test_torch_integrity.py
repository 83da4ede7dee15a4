"""The port's output-integrity guard against the JAX package's (CPU).

The same numpy canary operands (``integrity.build_args``, one seed) go
through both packages: the canary keys, the oracle envelopes and, under
the same ``corrupt_output`` / ``nan_output`` plans, the journal events
and tiers of ``registry.dispatch``. The reference runs its Pallas
kernels in interpret mode here, as its own tests do, with its compile
memo off (``TPK_AOT_CACHE=0``). Every state path of both packages (the
integrity dir, the journal, the tuning cache) lies in ``tmp_path``.
Then the port's own behaviour: the knob's three modes, the sampled
cadence, stale envelopes, an unwritable ledger, the plan memo, the call
counters, the tripwire at every position and the envelope CLI.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukernels import registry as ref_registry
from tpukernels.resilience import faults as ref_faults
from tpukernels.resilience import integrity as ref_integrity
from tpukernels_torch import interop, registry
from tpukernels_torch.obs import metrics, trace
from tpukernels_torch.resilience import faults, integrity, journal
from tpukernels_torch.tuning import space

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = sorted(integrity.CANARY_CONFIGS)
EXACT = [k for k in KEYS if integrity.tolerance(k)[0] == "exact"]
FLOAT = [k for k in KEYS if integrity.tolerance(k)[0] == "band"]
# the kinds the two guards share (the reference adds aot_invalidated,
# which the port has no counterpart of: it drops its plan memo instead)
GUARD_KINDS = ("fault_injected", "output_integrity_failed",
               "output_integrity_quarantined",
               "output_integrity_quarantined_repeat")


def _events(path, kind=None):
    recs, _bad = journal.load_events([path])
    return [r for r in recs if kind is None or r.get("kind") == kind]


class _Rig:
    """Both packages' guard state isolated in ``tmp_path``: integrity
    dirs, journals and the port's tuning cache; fault plans cleared."""

    def __init__(self, monkeypatch, tmp_path):
        self.mp = monkeypatch
        self.dir = tmp_path / "tpkt_integrity"
        self.journal = tmp_path / "tpkt_health.jsonl"
        self.ref_dir = tmp_path / "tpk_integrity"
        self.ref_journal = tmp_path / "tpk_health.jsonl"
        for d in (self.dir, self.ref_dir):
            d.mkdir()
        monkeypatch.setenv("TPKT_INTEGRITY_DIR", str(self.dir))
        monkeypatch.setenv("TPKT_HEALTH_JOURNAL", str(self.journal))
        monkeypatch.setenv("TPKT_TUNING_CACHE_DIR", str(tmp_path / "tuning"))
        monkeypatch.setenv("TPK_INTEGRITY_DIR", str(self.ref_dir))
        monkeypatch.setenv("TPK_HEALTH_JOURNAL", str(self.ref_journal))
        monkeypatch.setenv("TPK_AOT_CACHE", "0")
        monkeypatch.setenv("TPKT_AOT_CACHE", "0")
        for var in ("TPKT_INTEGRITY", "TPKT_INTEGRITY_SAMPLE",
                    "TPKT_INTEGRITY_QUARANTINE_AFTER", "TPKT_FAULT_PLAN",
                    "TPKT_TRACE", "TPK_INTEGRITY", "TPK_FAULT_PLAN"):
            monkeypatch.delenv(var, raising=False)
        self.reload()
        metrics.reset()

    def reload(self):
        faults.reload_plan()
        ref_faults.reload_plan()
        integrity.reset()
        ref_integrity.reset()
        trace.reload()

    def set_plan(self, plan):
        self.mp.setenv("TPKT_FAULT_PLAN", json.dumps(plan))
        self.mp.setenv("TPK_FAULT_PLAN", json.dumps(plan))
        self.reload()

    def clear_plan(self):
        self.mp.delenv("TPKT_FAULT_PLAN", raising=False)
        self.mp.delenv("TPK_FAULT_PLAN", raising=False)
        faults.reload_plan()
        ref_faults.reload_plan()

    def events(self, kind=None):
        return _events(self.journal, kind)


@pytest.fixture
def rig(monkeypatch, tmp_path):
    r = _Rig(monkeypatch, tmp_path)
    yield r
    # module state outlives monkeypatch's restore of the env
    monkeypatch.delenv("TPKT_FAULT_PLAN", raising=False)
    monkeypatch.delenv("TPK_FAULT_PLAN", raising=False)
    monkeypatch.delenv("TPKT_TRACE", raising=False)
    r.reload()


def _port_args(name):
    return interop.to_port(name, integrity.build_args(name), "cpu")


def _ref_args(name):
    return tuple(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                 for a in integrity.build_args(name))


def _statics(name):
    return integrity.CANARY_CONFIGS[name]["statics"]


# ------------------------------------------------------------------ #
# the canary contracts against the reference                         #
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("name", KEYS)
def test_canary_key_matches_reference(name):
    assert integrity.canary_key(name) == ref_integrity.canary_key(name)


@pytest.mark.parametrize("name", ref_registry.names())
def test_every_registry_key_has_a_canary_contract(name):
    """As tests/test_registry_contract.py asserts for the reference:
    a CANARY_CONFIGS row, operands, an oracle and the same tolerance."""
    assert name in registry.names()
    assert integrity.CANARY_CONFIGS[name] == ref_integrity.CANARY_CONFIGS[name]
    assert integrity.tolerance(name) == ref_integrity.tolerance(name)
    assert callable(integrity.oracle(name))
    for a, b in zip(integrity.build_args(name),
                    ref_integrity._build_args(name)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", KEYS)
def test_canary_matches_oracle(rig, name):
    """The guard's authority, clean: each key's canary (the wrapper's
    plain version here) agrees with its CPU oracle at the key's
    tolerance (exact for the int32 keys)."""
    assert integrity.cross_check(name, device="cpu") is None
    assert not rig.events("output_integrity_failed")


@pytest.mark.parametrize("name", EXACT)
def test_exact_envelope_crc_matches_reference(rig, name):
    """The envelope the port records from its CPU oracle has the shape,
    dtype and CRC of the reference's fingerprint of its own oracle."""
    got = integrity.record_envelope(name)["fingerprints"]
    want = ref_integrity.fingerprint(
        ref_integrity._oracle(name)(*_ref_args(name), **_statics(name)))
    assert [(r["shape"], r["dtype"], r["crc"]) for r in got] == [
        (r["shape"], r["dtype"], r["crc"]) for r in want]
    assert integrity.envelope(name)["fingerprints"] == got


@pytest.mark.parametrize("name", FLOAT)
def test_float_envelope_norms_within_reference_band(rig, name):
    """A float key's l2, sum and absmax lie inside the reference's own
    envelope band around its oracle's (``_fingerprint_mismatch``)."""
    got = integrity.record_envelope(name)["fingerprints"]
    want = ref_integrity.fingerprint(
        ref_integrity._oracle(name)(*_ref_args(name), **_statics(name)))
    assert ref_integrity._fingerprint_mismatch(name, got, want) is None
    assert integrity.fingerprint_mismatch(name, got, want) is None


# ------------------------------------------------------------------ #
# chaos: the same plan through both packages' dispatch               #
# ------------------------------------------------------------------ #

CHAOS = [
    ("corrupt_output", "sgemm", False, 3),
    ("nan_output", "stencil2d", False, 1),
    ("corrupt_output", "histogram", False, 3),
    ("corrupt_output", "histogram", True, 2),
]


@pytest.mark.parametrize("fault,name,envelope,tier", CHAOS)
def test_chaos_parity_with_reference(rig, fault, name, envelope, tier):
    """Three dispatches under one plan: the same sequence of event
    kinds in both journals (a failure each call, the quarantine on the
    second, the repeat on the third) at the same tier."""
    if envelope:
        integrity.record_envelope(name)
        ref_integrity.record_envelope(name)
    rig.set_plan({fault: {"kernel": name, "site": "registry"}})
    for _ in range(3):
        out = registry.dispatch(name, *_port_args(name), **_statics(name))
        ref_registry.dispatch(name, *_ref_args(name), **_statics(name))
    kinds = [e["kind"] for e in rig.events() if e["kind"] in GUARD_KINDS]
    ref = _events(rig.ref_journal)
    assert kinds == [e["kind"] for e in ref if e["kind"] in GUARD_KINDS]
    fails = rig.events("output_integrity_failed")
    assert [f["tier"] for f in fails] == [tier] * 3
    assert [f["tier"] for f in ref if f["kind"] ==
            "output_integrity_failed"] == [tier] * 3
    assert kinds.count("output_integrity_quarantined") == 1
    assert kinds.count("output_integrity_quarantined_repeat") == 1
    assert integrity.is_quarantined(name)
    # the corrupted result is returned, not raised
    first = out.reshape(-1)[0]
    if fault == "nan_output":
        assert torch.isnan(first)
    else:
        want = integrity.oracle(name)(*_port_args(name), **_statics(name))
        assert first != want.reshape(-1)[0]


def test_clean_check_lifts_suspicion(rig):
    rig.set_plan({"corrupt_output": {"kernel": "scan"}})
    x = torch.arange(300, dtype=torch.int32)
    registry.dispatch("scan", x)
    assert "scan" in integrity._SUSPECT
    rig.clear_plan()
    out = registry.dispatch("scan", x)  # suspect: canary-checked again
    np.testing.assert_array_equal(out.numpy(), np.cumsum(np.arange(300)))
    assert "scan" not in integrity._SUSPECT
    assert metrics.counter("integrity.tier3.scan") == 2
    assert len(rig.events("output_integrity_failed")) == 1


# ------------------------------------------------------------------ #
# the port's own behaviour                                           #
# ------------------------------------------------------------------ #

def test_guard_off_is_one_check(rig, monkeypatch):
    """TPKT_INTEGRITY=0: the knob is read and nothing else runs: no
    fault point, no tripwire, no counter, no event."""
    monkeypatch.setenv("TPKT_INTEGRITY", "0")
    rig.set_plan({"nan_output": {"kernel": "vector_add"}})

    def boom(*a, **k):
        raise AssertionError("the guard ran past its knob")

    monkeypatch.setattr(integrity.faults, "output_fault", boom)
    monkeypatch.setattr(integrity, "tripwire_ok", boom)
    out = registry.dispatch("vector_add", *_port_args("vector_add"))
    assert torch.isfinite(out).all()
    assert metrics.counter("integrity.checks") == 0
    assert not rig.events()


def test_tripwire_mode_skips_the_canaries(rig, monkeypatch):
    monkeypatch.setenv("TPKT_INTEGRITY", "tripwire")
    rig.set_plan({"corrupt_output": {"kernel": "sgemm"}})
    registry.dispatch("sgemm", *_port_args("sgemm"))
    assert metrics.counter("integrity.deep_checks") == 0
    assert not rig.events("output_integrity_failed")  # finite: unseen
    rig.set_plan({"nan_output": {"kernel": "sgemm"}})
    registry.dispatch("sgemm", *_port_args("sgemm"))
    fails = rig.events("output_integrity_failed")
    assert [f["tier"] for f in fails] == [1]
    assert metrics.counter("integrity.deep_checks") == 0


@pytest.mark.parametrize("every,deep_at", [(3, [1, 3, 6]), (0, [1]),
                                           (1, [1, 2, 3, 4, 5, 6, 7])])
def test_sampled_cadence_fires_on_call_n(rig, monkeypatch, every, deep_at):
    monkeypatch.setenv("TPKT_INTEGRITY_SAMPLE", str(every))
    seen = []
    for call in range(1, 8):
        before = metrics.counter("integrity.deep_checks")
        registry.dispatch("vector_add", *_port_args("vector_add"))
        if metrics.counter("integrity.deep_checks") > before:
            seen.append(call)
    assert seen == deep_at
    assert metrics.counter("integrity.tier3.vector_add") == len(deep_at)


def test_bad_sample_knob_is_a_check_error(rig, monkeypatch, capsys):
    monkeypatch.setenv("TPKT_INTEGRITY_SAMPLE", "-1")
    out = registry.dispatch("vector_add", *_port_args("vector_add"))
    assert out.shape == (1000,)
    errs = rig.events("output_integrity_check_error")
    assert len(errs) == 1 and "TPKT_INTEGRITY_SAMPLE" in errs[0]["error"]
    assert metrics.counter("integrity.check_errors") == 1
    assert "check error" in capsys.readouterr().err


@pytest.mark.parametrize("stale", ["torch", "source_sha"])
def test_stale_envelope_rejected_loudly(rig, monkeypatch, capsys, stale):
    integrity.record_envelope("scan")
    assert integrity.envelope("scan") is not None
    p = integrity.manifest_path()
    data = json.load(open(p))
    for ent in data["entries"].values():
        ent[stale] = "0.0.0-stale" if stale == "torch" else "f" * 40
    with open(p, "w") as f:
        json.dump(data, f)
    if stale == "source_sha":  # a checkout whose sources moved on
        monkeypatch.setattr(integrity.tcache, "source_sha",
                            lambda sources, root=None: "a" * 40)
    assert integrity.envelope("scan") is None
    rej = rig.events("output_integrity_rejected")
    assert len(rej) == 1
    assert "integrity-envelope rejected" in capsys.readouterr().err
    assert integrity.fingerprint_check("scan", device="cpu") == (False, None)
    # the guard falls through to the oracle (tier 3)
    registry.dispatch("scan", *_port_args("scan"))
    assert metrics.counter("integrity.tier3.scan") == 1
    assert metrics.counter("integrity.tier2.scan") == 0
    assert metrics.counter("integrity.rejections") == 1


def test_valid_envelope_takes_tier_2(rig):
    for name in EXACT:
        integrity.record_envelope(name)
        registry.dispatch(name, *_port_args(name), **_statics(name))
        assert metrics.counter(f"integrity.tier2.{name}") == 1
    assert not rig.events("output_integrity_failed")


def test_unwritable_ledger_is_a_check_error(rig, capsys):
    os.makedirs(integrity.quarantine_path())  # a directory in its place
    rig.set_plan({"corrupt_output": {"kernel": "vector_add"}})
    out = registry.dispatch("vector_add", *_port_args("vector_add"))
    assert out.shape == (1000,)
    assert len(rig.events("output_integrity_failed")) == 1
    errs = rig.events("output_integrity_check_error")
    assert len(errs) == 1 and "quarantine ledger" in errs[0]["error"]
    assert metrics.counter("integrity.check_errors") == 1
    assert "check error" in capsys.readouterr().err


def test_torn_ledger_write_keeps_the_old_ledger(rig):
    rig.set_plan({"corrupt_output": {"kernel": "scan"}})
    registry.dispatch("scan", *_port_args("scan"))
    before = open(integrity.quarantine_path()).read()
    rig.set_plan({"corrupt_output": {"kernel": "scan"},
                  "torn_write": {"path_substr": "integrity_quarantine"}})
    registry.dispatch("scan", *_port_args("scan"))
    assert open(integrity.quarantine_path()).read() == before
    assert any(e.get("fault") == "torn_write"
               for e in rig.events("fault_injected"))
    assert len(rig.events("output_integrity_check_error")) == 1


def test_failure_forgets_the_plan_memo(rig):
    sp = registry.tunables("sgemm")
    made = []
    space.plan_memo(sp, ("test",), lambda: made.append(1) or "plan")
    space.plan_memo(sp, ("test",), lambda: made.append(1) or "plan")
    assert made == [1]
    rig.set_plan({"corrupt_output": {"kernel": "sgemm"}})
    registry.dispatch("sgemm", *_port_args("sgemm"))
    fails = rig.events("output_integrity_failed")
    assert fails[0]["plan_memo_dropped"] >= 1
    space.plan_memo(sp, ("test",), lambda: made.append(1) or "plan")
    assert made == [1, 1]


def test_forget_counts_what_it_drops():
    sps = registry.tunables("scan"), registry.tunables("histogram")
    space.forget("scan")  # plans earlier tests left
    space.plan_memo(sps[0], ("f1",), lambda: 1)
    space.plan_memo(sps, ("f2",), lambda: 2)
    assert space.forget("scan") == 2
    assert space.forget("scan") == 0


def test_calls_is_a_view_of_the_counters(rig):
    registry.reset_calls()
    for name, n in (("vector_add", 2), ("scan", 3)):
        for _ in range(n):
            registry.dispatch(name, *_port_args(name))
    assert registry.calls() == {"vector_add": 2, "scan": 3}
    assert registry.calls() == {
        k.removeprefix("dispatch.calls."): v
        for k, v in metrics.counters("dispatch.calls.").items()}
    snap = metrics.snapshot()["histograms"]
    assert snap["dispatch.wall_s.scan"]["count"] == 3
    registry.reset_calls()
    assert registry.calls() == {}
    assert "dispatch.wall_s.scan" not in metrics.snapshot()["histograms"]


def test_dispatch_runs_the_reference_order(rig, monkeypatch):
    """The span opens first: a slow_dispatch delay and the guard's
    canary fall inside ``dispatch/<key>``, the counters after it."""
    monkeypatch.setenv("TPKT_TRACE", "1")
    rig.set_plan({"slow_dispatch": {"kernel": "scan", "delay_s": 0.05}})
    order = []
    real_guard = integrity.guard
    monkeypatch.setattr(registry._integrity, "guard", lambda *a, **k: (
        order.append(("guard", trace.current_path())), real_guard(*a, **k))[1])
    real_inc = metrics.inc
    monkeypatch.setattr(registry._metrics, "inc", lambda name, n=1: (
        order.append((name, trace.current_path())), real_inc(name, n)))
    registry.dispatch("scan", *_port_args("scan"))
    assert order[0] == ("guard", "dispatch/scan")
    assert order[-1] == ("dispatch.calls.scan", None)
    spans = {e["name"]: e for e in rig.events("span")}
    assert spans["dispatch/scan"]["wall_s"] >= 0.05
    assert "dispatch/scan/integrity/canary/scan" in spans
    assert [e["fault"] for e in rig.events("fault_injected")] == [
        "slow_dispatch"]


def test_guard_exception_is_journaled_and_counted(rig, monkeypatch, capsys):
    def broken(*a, **k):
        raise RuntimeError("canary exploded")

    monkeypatch.setattr(integrity, "run_canary", broken)
    x = torch.ones(8)
    out = integrity.guard("registry", "vector_add", x)
    assert out is x
    errs = rig.events("output_integrity_check_error")
    assert len(errs) == 1 and "canary exploded" in errs[0]["error"]
    assert metrics.counter("integrity.check_errors") == 1
    assert "canary exploded" in capsys.readouterr().err


def test_canary_runs_on_the_result_device(rig, monkeypatch):
    """The canary follows the guarded result's device: on a card the
    kernel under test never runs its CPU path. (A meta tensor stands in
    for a tensor off the CPU; int leaves need no tripwire.)"""
    seen = []
    monkeypatch.setattr(integrity, "_deep_check",
                        lambda site, name, device: seen.append(device) or
                        (3, None))
    integrity.guard("registry", "scan", torch.zeros(4, dtype=torch.int32))
    integrity.guard("registry", "histogram",
                    torch.zeros(4, dtype=torch.int32, device="meta"))
    assert seen == [torch.device("cpu"), torch.device("meta")]


def _leaf_positions(n):
    return sorted({0, n // 2, n - 1})


@pytest.mark.parametrize("value", [float("nan"), float("inf"),
                                   float("-inf")])
@pytest.mark.parametrize("name", FLOAT)
def test_tripwire_catches_every_position(name, value):
    """NaN, +inf and -inf at the first, a middle and the last element of
    each float leaf of each float key's result: every one is caught."""
    out = registry.lookup(name)(*_port_args(name), **_statics(name))
    assert integrity.tripwire_ok(out)
    leaves = list(out) if isinstance(out, tuple) else [out]
    for i, leaf in enumerate(leaves):
        for pos in _leaf_positions(leaf.numel()):
            bad = leaf.clone()
            bad.view(-1)[pos] = value
            poisoned = leaves[:i] + [bad] + leaves[i + 1:]
            assert not integrity.tripwire_ok(
                tuple(poisoned) if isinstance(out, tuple) else bad), (
                i, pos)


@pytest.mark.parametrize("name", EXACT)
def test_tripwire_skips_int_results(name, monkeypatch):
    monkeypatch.setattr(torch.linalg, "vector_norm", None)  # never called
    out = registry.lookup(name)(*_port_args(name), **_statics(name))
    assert integrity.tripwire_ok(out)


# ------------------------------------------------------------------ #
# the envelope CLI                                                   #
# ------------------------------------------------------------------ #

def test_envelope_cli_exit_codes(rig, capsys):
    main = integrity.main
    assert main(["--check", "--device", "cpu"]) == 0  # all SKIP
    assert main(["--record"]) == 0
    assert len(json.load(open(integrity.manifest_path()))["entries"]) == 9
    assert main(["--check", "--device", "cpu"]) == 0
    assert main([]) == 0
    rig.set_plan({"corrupt_output": {"kernel": "histogram"}})
    assert main(["--check", "--device", "cpu", "--kernels",
                 "histogram,scan"]) == 1
    rig.clear_plan()
    assert main(["--record", "--check"]) == 2
    assert main(["--kernels", "dgemm", "--record"]) == 2
    assert main(["--bogus"]) == 2
    out = capsys.readouterr().out
    assert "histogram        FAIL" in out and "integrity check on cpu: OK" in out


def test_envelope_cli_runs_as_a_module(tmp_path, monkeypatch):
    env = dict(os.environ, TPKT_INTEGRITY_DIR=str(tmp_path),
               PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    env.pop("TPKT_HEALTH_JOURNAL", None)
    cmd = [sys.executable, "-m", "tpukernels_torch.resilience.integrity"]
    p = subprocess.run(cmd + ["--record", "--kernels", "scan"], env=env,
                       capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert p.returncode == 0, p.stderr
    assert "1 recorded, 0 failed" in p.stdout
    assert (tmp_path / "integrity.json").is_file()
    p = subprocess.run(cmd + ["--check"], env=env, capture_output=True,
                       text=True, timeout=120, cwd=ROOT)
    assert p.returncode == 2 and "device='cpu'" in p.stderr
