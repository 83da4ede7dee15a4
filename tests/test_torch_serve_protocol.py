"""The serving daemon's parts, unit by unit, against the reference's (CPU).

Each of the port's serving modules is held to its counterpart in the JAX
package on the same inputs: the wire (``serve/protocol.py``: frames and
packed arrays byte for byte, each side unpacking the other's, the shm
lane across packages, deadlines), the bucketing (``serve/bucketing.py``:
``bucket_for``, ``pad_args``, ``unpad_outputs`` and ``bucket_id`` over a
table of shapes for all nine keys, over-avatar, layout mismatch and
pad-over-cap included), the avatar table (``aot.BENCH_CONFIGS``), the
watchdog, ``trace.request_ctx``, the metrics flusher and
``merge_journal_metrics``, ``delay_response`` and the serve paths. Then
the port's own module state under two or more threads: the library
loader, the launch counters, the plan memo and the guard's call counts.
Every state path of both packages lies in ``tmp_path``.
"""

import json
import socket
import sys
import threading
import time

import numpy as np
import pytest

from tpukernels import _cachedir as ref_cachedir
from tpukernels import aot as ref_aot
from tpukernels.obs import metrics as ref_metrics
from tpukernels.obs import trace as ref_trace
from tpukernels.resilience import faults as ref_faults
from tpukernels.resilience import watchdog as ref_watchdog
from tpukernels.serve import bucketing as ref_bucketing
from tpukernels.serve import protocol as ref_protocol
from tpukernels_torch import _build, _cachedir, aot, registry
from tpukernels_torch.obs import metrics, trace
from tpukernels_torch.resilience import faults, journal, watchdog
from tpukernels_torch.serve import bucketing, protocol

# a small avatar for every key, so the pad rules run at CPU sizes
SMALL = {
    "vector_add": {"args": [["f32", []], ["f32", [1024]], ["f32", [1024]]],
                   "statics": {}},
    "sgemm": {"args": [["f32", []], ["f32", [64, 96]], ["f32", [96, 80]],
                       ["f32", []], ["f32", [64, 80]]], "statics": {}},
    "stencil2d": {"args": [["f32", [40, 72]]], "statics": {"iters": 3}},
    "stencil3d": {"args": [["f32", [8, 24, 40]]], "statics": {"iters": 2}},
    "scan": {"args": [["i32", [4096]]], "statics": {}},
    "scan_exclusive": {"args": [["i32", [4096]]], "statics": {}},
    "histogram": {"args": [["i32", [4096]]], "statics": {"nbins": 64}},
    "scan_histogram": {"args": [["i32", [4096]]], "statics": {"nbins": 64}},
    "nbody": {"args": [["f32", [256]]] * 7,
              "statics": {"dt": 1e-3, "eps": 1e-2, "steps": 1}},
}


def _events(path, kind=None):
    recs, _ = journal.load_events([path])
    return [r for r in recs if kind is None or r.get("kind") == kind]


def _strip(ev):
    """An event without the fields that differ run to run."""
    return {k: v for k, v in ev.items()
            if k not in ("ts", "t", "pid", "git_head")}


@pytest.fixture
def journals(monkeypatch, tmp_path):
    """Both packages journaling into ``tmp_path``; no fault plan."""
    monkeypatch.setenv("TPKT_HEALTH_JOURNAL", str(tmp_path / "tpkt.jsonl"))
    monkeypatch.setenv("TPK_HEALTH_JOURNAL", str(tmp_path / "tpk.jsonl"))
    for var in ("TPKT_FAULT_PLAN", "TPK_FAULT_PLAN"):
        monkeypatch.delenv(var, raising=False)
    faults.reload_plan()
    ref_faults.reload_plan()
    yield tmp_path / "tpkt.jsonl", tmp_path / "tpk.jsonl"
    for var in ("TPKT_FAULT_PLAN", "TPK_FAULT_PLAN", "TPKT_TRACE",
                "TPK_TRACE"):
        monkeypatch.delenv(var, raising=False)
    faults.reload_plan()
    ref_faults.reload_plan()
    trace.reload()
    ref_trace.reload()


# ---------------------------------------------------------------- wire

def _wire_bytes(mod, header, payloads) -> bytes:
    """The bytes ``mod.send_frame`` writes for one frame."""
    a, b = socket.socketpair()
    try:
        mod.send_frame(a, header, payloads)
        a.shutdown(socket.SHUT_WR)
        chunks = []
        while True:
            c = b.recv(1 << 20)
            if not c:
                return b"".join(chunks)
            chunks.append(c)
    finally:
        a.close()
        b.close()


FRAMES = {
    "ping": ({"v": 1, "op": "ping"}, []),
    "scalars and small": ({"v": 1, "op": "dispatch", "id": 3,
                           "kernel": "vector_add", "statics": {}},
                          [np.float32(2.5), np.arange(7, dtype=np.float32),
                           np.arange(7, dtype=np.float32)]),
    "int 2-D": ({"v": 1, "op": "dispatch", "id": 9, "kernel": "x",
                 "statics": {"iters": 2}, "request_id": "r-1",
                 "budget_ms": 12.5},
                [np.arange(12, dtype=np.int32).reshape(3, 4)]),
    "streamed": ({"v": 1, "op": "dispatch", "id": 1, "kernel": "scan",
                  "statics": {}},
                 [np.arange(40000, dtype=np.int32)]),  # over SMALL_FRAME
}


@pytest.mark.parametrize("case", sorted(FRAMES))
def test_frames_are_byte_identical_and_cross_parse(case):
    header, arrays = FRAMES[case]
    specs, payloads = protocol.pack_arrays(arrays)
    ref_specs, ref_payloads = ref_protocol.pack_arrays(arrays)
    assert specs == ref_specs
    assert [bytes(p) for p in payloads] == [bytes(p) for p in ref_payloads]
    h = dict(header, args=specs) if arrays else header
    mine = _wire_bytes(protocol, h, payloads)
    assert mine == _wire_bytes(ref_protocol, h, ref_payloads)
    # each side parses the other's frame
    for sender, receiver in ((protocol, ref_protocol),
                             (ref_protocol, protocol)):
        a, b = socket.socketpair()
        try:
            sender.send_frame(a, h, payloads)
            got_h, got_p = receiver.recv_frame(b)
        finally:
            a.close()
            b.close()
        assert got_h == h
        back = receiver.unpack_arrays(got_h.get("args") or [], got_p)
        for want, got in zip(arrays, back):
            assert got.dtype == np.asarray(want).dtype
            np.testing.assert_array_equal(got, want)


def test_protocol_constants_and_errors_match_reference():
    for name in ("VERSION", "MAGIC", "MAX_HEADER", "MAX_PAYLOAD",
                 "SMALL_FRAME", "DEFAULT_SHM_MIN_BYTES", "SHM_DIR"):
        assert getattr(protocol, name) == getattr(ref_protocol, name), name
    assert protocol._SHM_NAME_RE.pattern == ref_protocol._SHM_NAME_RE.pattern
    assert {k: np.dtype(v) for k, v in protocol.DTYPES.items()} == \
        {k: np.dtype(v) for k, v in ref_protocol.DTYPES.items()}
    for mod in (protocol, ref_protocol):
        with pytest.raises(mod.ProtocolError, match="unsupported dtype"):
            mod.pack_arrays([np.zeros(3, np.float64)])
        with pytest.raises(mod.ProtocolError, match="needs"):
            mod.unpack_arrays([{"shape": [4], "dtype": "int32"}],
                              [b"\0" * 8])


@pytest.mark.parametrize("direction", ["port->ref", "ref->port"])
def test_shm_lane_crosses_packages(direction):
    """A payload staged into /dev/shm by one package is resolved by the
    other, under the reference's segment names."""
    sender, receiver = ((protocol, ref_protocol) if direction == "port->ref"
                        else (ref_protocol, protocol))
    if not (sender.shm_available() and receiver.shm_available()):
        pytest.skip("this host cannot map /dev/shm segments")
    arrays = [np.arange(1 << 15, dtype=np.int32), np.float32(1.5)]
    specs, payloads = sender.pack_arrays(arrays)
    descs, wire, segs, staged = sender.stage_shm_payloads(payloads,
                                                          min_bytes=1024)
    try:
        assert staged == arrays[0].nbytes and len(segs) == 1
        assert ref_protocol._SHM_NAME_RE.match(segs[0].name)
        header = {"args": specs, "_shm": descs}
        full, inline, maps = receiver.resolve_shm_payloads(header, wire)
        assert inline == 4 and "_shm" not in header
        back = receiver.unpack_arrays(specs, full)
        np.testing.assert_array_equal(back[0], arrays[0])
        assert back[1] == arrays[1]
        del back, full
        for mm in maps:
            mm.close()
    finally:
        for seg in segs:
            seg.close()
            seg.unlink()


HEADERS = [{}, {"budget_ms": 100}, {"deadline_ms": 50}, {"budget_ms": -1},
           {"budget_ms": True}, {"budget_ms": "x"},
           {"budget_ms": 0, "deadline_ms": 10}, {"budget_ms": 2.5}]


@pytest.mark.parametrize("header", HEADERS, ids=json.dumps)
def test_deadlines_match_reference(header):
    now = 1000.0
    at = protocol.deadline_from_header(header, now=now)
    assert at == ref_protocol.deadline_from_header(header, now=now)
    stamped = protocol.stamp_budget(header, at, now=now + 0.01)
    assert stamped == ref_protocol.stamp_budget(header, at, now=now + 0.01)
    if at is not None:
        assert protocol.budget_ms_remaining(at, now + 1) == \
            ref_protocol.budget_ms_remaining(at, now + 1)


# ----------------------------------------------------------- bucketing

@pytest.fixture
def small_table(monkeypatch):
    raw = json.dumps(SMALL)
    monkeypatch.setenv("TPKT_SERVE_BUCKETS", raw)
    monkeypatch.setenv("TPK_SERVE_BUCKETS", raw)
    for var in ("TPKT_SERVE_MAX_PAD_FRAC", "TPK_SERVE_MAX_PAD_FRAC"):
        monkeypatch.delenv(var, raising=False)


def _f(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _i(rng, n, hi=64):
    return rng.integers(0, hi, n).astype(np.int32)


def _bodies(rng, n, m=None):
    return [_f(rng, n) for _ in range(6)] + [_f(rng, m or n)]


# (kernel, operands from a seeded rng, statics): exact fits, padded
# fits, over-avatar, layout mismatch, inconsistent operands, statics
# mismatch and pad-over-cap, over all nine keys
BUCKET_CASES = {
    "vector_add exact": ("vector_add", lambda r: [np.float32(2), _f(r, 1024),
                                                  _f(r, 1024)], {}),
    "vector_add padded": ("vector_add", lambda r: [np.float32(2),
                                                   _f(r, 1000), _f(r, 1000)],
                          {}),
    "vector_add over": ("vector_add", lambda r: [np.float32(2), _f(r, 2000),
                                                 _f(r, 2000)], {}),
    "vector_add layout": ("vector_add", lambda r: [np.float32(2),
                                                   _i(r, 1000), _f(r, 1000)],
                          {}),
    "vector_add inconsistent": ("vector_add", lambda r: [np.float32(2),
                                                         _f(r, 1000),
                                                         _f(r, 900)], {}),
    "vector_add pad over cap": ("vector_add", lambda r: [np.float32(2),
                                                         _f(r, 100),
                                                         _f(r, 100)], {}),
    "sgemm exact": ("sgemm", lambda r: [np.float32(1.5), _f(r, 64, 96),
                                        _f(r, 96, 80), np.float32(0.5),
                                        _f(r, 64, 80)], {}),
    "sgemm padded": ("sgemm", lambda r: [np.float32(1.5), _f(r, 60, 90),
                                         _f(r, 90, 70), np.float32(0.5),
                                         _f(r, 60, 70)], {}),
    "sgemm inconsistent": ("sgemm", lambda r: [np.float32(1.5),
                                               _f(r, 60, 90), _f(r, 80, 70),
                                               np.float32(0.5),
                                               _f(r, 60, 70)], {}),
    "sgemm over": ("sgemm", lambda r: [np.float32(1.5), _f(r, 128, 96),
                                       _f(r, 96, 80), np.float32(0.5),
                                       _f(r, 128, 80)], {}),
    "stencil2d exact": ("stencil2d", lambda r: [_f(r, 40, 72)],
                        {"iters": 3}),
    "stencil2d smaller": ("stencil2d", lambda r: [_f(r, 36, 72)],
                          {"iters": 3}),
    "stencil2d statics": ("stencil2d", lambda r: [_f(r, 40, 72)],
                          {"iters": 4}),
    "stencil3d exact": ("stencil3d", lambda r: [_f(r, 8, 24, 40)],
                        {"iters": 2}),
    "stencil3d smaller": ("stencil3d", lambda r: [_f(r, 8, 24, 36)],
                          {"iters": 2}),
    "scan exact": ("scan", lambda r: [_i(r, 4096)], {}),
    "scan padded": ("scan", lambda r: [_i(r, 3000)], {}),
    "scan over": ("scan", lambda r: [_i(r, 5000)], {}),
    "scan 2-D": ("scan", lambda r: [_i(r, 64).reshape(8, 8)], {}),
    "scan_exclusive padded": ("scan_exclusive", lambda r: [_i(r, 2500)], {}),
    "histogram padded": ("histogram", lambda r: [_i(r, 3500)],
                         {"nbins": 64}),
    "histogram statics": ("histogram", lambda r: [_i(r, 3500)],
                          {"nbins": 32}),
    "scan_histogram padded": ("scan_histogram", lambda r: [_i(r, 3100)],
                              {"nbins": 64}),
    "nbody exact": ("nbody", lambda r: _bodies(r, 256),
                    dict(SMALL["nbody"]["statics"])),
    "nbody padded": ("nbody", lambda r: _bodies(r, 200),
                     dict(SMALL["nbody"]["statics"])),
    "nbody inconsistent": ("nbody", lambda r: _bodies(r, 200, 199),
                           dict(SMALL["nbody"]["statics"])),
    "unknown kernel": ("dgemm", lambda r: [_f(r, 8)], {}),
}


def _fake_outputs(kernel, spec, seed=3):
    """Avatar-shaped outputs as the kernel would return them."""
    rng = np.random.default_rng(seed)
    shapes = [tuple(s) for _k, s in spec["args"]]
    nbins = spec["statics"].get("nbins")
    if kernel == "vector_add":
        return (_f(rng, *shapes[1]),)
    if kernel == "sgemm":
        return (_f(rng, *shapes[4]),)
    if kernel in ("scan", "scan_exclusive"):
        return (_i(rng, shapes[0][0], 1 << 20),)
    if kernel == "histogram":
        return (_i(rng, nbins, 100),)
    if kernel == "scan_histogram":
        return (_i(rng, shapes[0][0], 1 << 20), _i(rng, nbins, 100))
    if kernel == "nbody":
        return tuple(_f(rng, *shapes[0]) for _ in range(6))
    return (_f(rng, *shapes[0]),)


@pytest.mark.parametrize("case", sorted(BUCKET_CASES))
def test_bucketing_matches_reference(small_table, case):
    kernel, make, statics = BUCKET_CASES[case]
    arrays = make(np.random.default_rng(11))
    spec, how = bucketing.bucket_for(kernel, arrays, statics)
    ref_spec, ref_how = ref_bucketing.bucket_for(kernel, arrays, statics)
    assert (spec, how) == (ref_spec, ref_how)
    assert bucketing.bucket_id(kernel, spec, statics, arrays) == \
        ref_bucketing.bucket_id(kernel, ref_spec, statics, arrays)
    if spec is None:
        return
    padded, meta = bucketing.pad_args(kernel, spec, arrays)
    ref_padded, ref_meta = ref_bucketing.pad_args(kernel, ref_spec, arrays)
    assert meta == ref_meta
    for a, b in zip(padded, ref_padded):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    outs = _fake_outputs(kernel, spec)
    got = bucketing.unpad_outputs(kernel, meta, outs)
    want = ref_bucketing.unpad_outputs(kernel, ref_meta, outs)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_pad_pool_reuse_matches_reference(small_table):
    """A reused staging buffer is zeroed again: a shorter request after
    a longer one sees no stale tail, in both packages."""
    rng = np.random.default_rng(5)
    spec = bucketing.bucket_configs()["scan"]
    pool, ref_pool = {}, {}
    for n in (4000, 3000):
        x = _i(rng, n)
        got, meta = bucketing.pad_args("scan", spec, [x], pool=pool)
        want, ref_meta = ref_bucketing.pad_args("scan", spec, [x],
                                                pool=ref_pool)
        np.testing.assert_array_equal(got[0], want[0])
        assert meta == ref_meta and not got[0][n:].any()
    assert pool[0] is got[0]  # the same buffer, reused


def test_pad_cap_knob_matches_reference(small_table, monkeypatch):
    for raw in ("0.9", "0", "1"):
        monkeypatch.setenv("TPKT_SERVE_MAX_PAD_FRAC", raw)
        monkeypatch.setenv("TPK_SERVE_MAX_PAD_FRAC", raw)
        assert bucketing.max_pad_frac() == ref_bucketing.max_pad_frac()
        x = [np.float32(2), np.ones(100, np.float32),
             np.ones(100, np.float32)]
        assert bucketing.bucket_for("vector_add", x, {}) == \
            ref_bucketing.bucket_for("vector_add", x, {})
    monkeypatch.setenv("TPKT_SERVE_MAX_PAD_FRAC", "2")
    with pytest.raises(ValueError, match="TPKT_SERVE_MAX_PAD_FRAC"):
        bucketing.max_pad_frac()


def test_bench_configs_equal_the_reference():
    assert aot.BENCH_CONFIGS == ref_aot.BENCH_CONFIGS
    assert bucketing.PAD_RULES == ref_bucketing.PAD_RULES
    assert set(bucketing.PAD_RULES) == set(registry.names())


def test_default_table_matches_reference_at_record_shapes(monkeypatch):
    """The avatars of record, without allocating them (zero-stride
    stand-ins): every key fits its avatar exactly, and one past it is
    over-avatar, as in the reference; with no mesh tier, as on a
    one-device host."""
    for var in ("TPKT_SERVE_BUCKETS", "TPK_SERVE_BUCKETS", "XLA_FLAGS"):
        monkeypatch.delenv(var, raising=False)
    for kernel, spec in aot.BENCH_CONFIGS.items():
        arg_specs = [{"shape": list(s), "dtype": {"f32": "float32",
                                                  "i32": "int32"}[k]}
                     for k, s in spec["args"]]
        stubs = bucketing.spec_stubs(arg_specs)
        ref_stubs = ref_bucketing.spec_stubs(arg_specs)
        assert [s.shape for s in stubs] == [s.shape for s in ref_stubs]
        statics = dict(spec["statics"])
        got = bucketing.bucket_for(kernel, stubs, statics)
        assert got == (spec, 0.0)
        assert got == ref_bucketing.bucket_for(kernel, ref_stubs, statics)
        big = [dict(a, shape=[d + 1 for d in a["shape"]]) for a in arg_specs]
        stubs = bucketing.spec_stubs(big)
        got = bucketing.bucket_for(kernel, stubs, statics)
        assert got == ref_bucketing.bucket_for(kernel, stubs, statics)
        assert got == (None, "over-avatar")
        assert bucketing.mesh_tier_for(kernel, stubs, statics) is None
        assert ref_bucketing.mesh_tier_for(kernel, stubs, statics) is None


# ---------------------------------------------- watchdog, faults, paths

@pytest.mark.parametrize("alive", [True, False])
def test_classify_timeout_matches_reference(journals, alive):
    mine, ref = journals
    v = watchdog.classify_timeout(alive, site="serve", kernel="scan",
                                  request=7)
    assert v == ref_watchdog.classify_timeout(alive, site="serve",
                                              kernel="scan", request=7)
    assert v == ("slow" if alive else "wedged")
    assert [_strip(e) for e in _events(mine)] == \
        [_strip(e) for e in _events(ref)]


@pytest.mark.parametrize("answers,want", [(["retry", "alive"], True),
                                         (["dead"], False),
                                         (["retry", "retry"], False)])
def test_patient_probe_matches_reference(journals, answers, want):
    mine, ref = journals
    for mod in (watchdog, ref_watchdog):
        it = iter(answers)
        assert mod.patient_probe(lambda _a: next(it), len(answers), 0.0,
                                 label="p") is want
    assert [_strip(e) for e in _events(mine)] == \
        [_strip(e) for e in _events(ref)]


def test_kill_after_and_alarm(journals):
    slow = [sys.executable, "-c", "import time; time.sleep(30)"]
    assert watchdog.kill_after(slow, 0.3, site="t") == (None, "timeout")
    proc, how = watchdog.kill_after([sys.executable, "-c", "pass"], 30)
    assert how == "ok" and proc.returncode == 0
    with pytest.raises(watchdog.Timeout):
        watchdog.run_with_alarm(lambda: time.sleep(5), 1, site="t")
    assert watchdog.run_with_alarm(lambda: 42, 5) == 42
    kinds = [(e["mechanism"], e["site"]) for e in
             _events(journals[0], "watchdog_fire")]
    assert kinds == [("subprocess-kill", "t"), ("sigalrm", "t")]


def test_delay_response_matches_reference(journals, monkeypatch):
    plan = json.dumps({"delay_response": {"kernel": "scan", "delay_s": 0,
                                          "times": 2}})
    monkeypatch.setenv("TPKT_FAULT_PLAN", plan)
    monkeypatch.setenv("TPK_FAULT_PLAN", plan)
    faults.reload_plan()
    ref_faults.reload_plan()
    for _ in range(4):
        for mod in (faults, ref_faults):
            mod.response_fault("scan")
            mod.response_fault("sgemm")
    mine = [_strip(e) for e in _events(journals[0], "fault_injected")]
    assert len(mine) == 2 and mine[0]["site"] == "response"
    assert mine == [_strip(e) for e in _events(journals[1],
                                               "fault_injected")]


def test_serve_paths_match_reference(tmp_path):
    d = str(tmp_path / "srv")
    mine, ref = {"TPKT_SERVE_DIR": d}, {"TPK_SERVE_DIR": d}
    assert _cachedir.serve_dir(mine) == ref_cachedir.serve_dir(ref) == d
    assert _cachedir.serve_socket_path(mine) == \
        ref_cachedir.serve_socket_path(ref)
    assert _cachedir.serve_pidfile_path(mine) == \
        ref_cachedir.serve_pidfile_path(ref)
    sock = str(tmp_path / "x.sock")
    assert _cachedir.serve_socket_path(dict(mine, TPKT_SERVE_SOCKET=sock)) \
        == sock
    assert _cachedir.serve_dir({}).endswith(".tpkt_cache")


# ----------------------------------------------------- trace and metrics

def test_request_ctx_tags_spans_like_the_reference(journals, monkeypatch):
    monkeypatch.setenv("TPKT_TRACE", "1")
    monkeypatch.setenv("TPK_TRACE", "1")
    for mod in (trace, ref_trace):
        mod.reload()
        with mod.span("outside"):
            pass
        with mod.request_ctx("r-1"):
            assert mod.current_request() == "r-1"
            with mod.span("serve/scan", request_id="clobber"):
                mod.emit_span("wait", 0.25)
            with mod.request_ctx("r-2"):
                with mod.span("inner"):
                    pass
            assert mod.current_request() == "r-1"
        assert mod.current_request() is None
    def spans(path):  # a live span's wall differs run to run
        return [{k: v for k, v in _strip(e).items() if k != "wall_s"}
                for e in _events(path, "span")]

    mine = spans(journals[0])
    assert mine == spans(journals[1])
    assert [(e["name"], e.get("request_id")) for e in mine] == [
        ("outside", None), ("serve/scan/wait", "r-1"), ("serve/scan", "r-1"),
        ("inner", "r-2")]
    assert mine[2]["param_request_id"] == "clobber"


def _journal_of_metrics():
    """Events of three processes: one with duplicated snapshots only, one
    whose final ``metrics`` supersedes its snapshots, one with a final
    only."""
    h = {"count": 2, "sum": 3.0, "min": 1.0, "max": 2.0, "p50": 1.0,
         "p95": 2.0, "p99": 2.0, "buckets": {"0": 1, "4": 1}}
    return [
        {"kind": "metrics_snapshot", "pid": 1, "seq": 1, "site": "a",
         "counters": {"x": 2}, "gauges": {"g": 1}, "histograms": {"h": h}},
        {"kind": "metrics_snapshot", "pid": 1, "seq": 1, "site": "a",
         "counters": {"x": 2}, "gauges": {"g": 1}, "histograms": {}},
        {"kind": "metrics_snapshot", "pid": 1, "seq": 2, "site": "a",
         "counters": {"x": 3, "y": 1}, "gauges": {"g": 5},
         "histograms": {}, "t": 9.0},
        {"kind": "metrics_snapshot", "pid": 2, "seq": 1, "site": "b",
         "counters": {"x": 1}, "gauges": {}, "histograms": {}},
        {"kind": "metrics", "pid": 2, "site": "atexit", "counters": {"x": 7},
         "gauges": {}, "histograms": {"h": h}},
        {"kind": "metrics", "pid": 3, "site": "c", "counters": {"z": 1},
         "gauges": {}, "histograms": {}},
        {"kind": "span", "pid": 1, "name": "noise"},
    ]


def test_merge_journal_metrics_matches_reference():
    events = _journal_of_metrics()
    got = metrics.merge_journal_metrics(events)
    assert got == ref_metrics.merge_journal_metrics(events)
    assert got[1]["counters"] == {"x": 5, "y": 1} and not got[1]["final"]
    assert got[2]["counters"] == {"x": 7} and got[2]["seq"] == 1


def test_periodic_snapshots_match_reference(journals, monkeypatch):
    """The same records give the same delta-encoded snapshots, and the
    merge of snapshots and the final event gives the final state."""
    metrics.reset()
    ref_metrics.reset()
    try:
        for mod in (metrics, ref_metrics):
            mod.inc("serve.requests.scan", 3)
            mod.observe("serve.wall_s.scan", 0.002)
            assert mod.emit_periodic_snapshot(site="s") == 1
            mod.inc("serve.requests.scan")
            mod.gauge("serve.batch_window_ms", 1.5)
            assert mod.emit_periodic_snapshot(site="s") == 2
            assert mod.emit_periodic_snapshot(site="s") == 3  # no deltas
            assert 0.0 <= mod.last_flush_age_s() < 5
            mod.emit_snapshot(site="end")
        mine = [_strip(e) for e in _events(journals[0])]
        assert mine == [_strip(e) for e in _events(journals[1])]
        assert mine[1]["counters"] == {"serve.requests.scan": 1}
        assert "serve.wall_s.scan" not in mine[1]["histograms"]
        merged = metrics.merge_journal_metrics(_events(journals[0]))
        (state,) = merged.values()
        assert state["final"] and state["seq"] == 3
        assert state["counters"] == {"serve.requests.scan": 4}
    finally:
        metrics.reset()
        ref_metrics.reset()


@pytest.mark.parametrize("raw,want", [(None, None), ("", None),
                                      ("off", None), ("0", None),
                                      ("0.5", 0.5), ("2", 2.0)])
def test_flush_interval_matches_reference(raw, want):
    env = {} if raw is None else {"TPKT_METRICS_FLUSH_S": raw}
    ref_env = {} if raw is None else {"TPK_METRICS_FLUSH_S": raw}
    assert metrics.flush_interval_s(env) == want
    assert ref_metrics.flush_interval_s(ref_env) == want


def test_flusher_streams_and_stops(journals):
    metrics.reset()
    try:
        with pytest.raises(ValueError, match="TPKT_METRICS_FLUSH_S"):
            metrics.flush_interval_s({"TPKT_METRICS_FLUSH_S": "-1"})
        assert metrics.start_flusher(None) is False  # the knob is unset
        metrics.inc("n")
        assert metrics.start_flusher(0.05) is True
        assert metrics.start_flusher(0.05) is True  # idempotent
        deadline = time.monotonic() + 10
        while not _events(journals[0], "metrics_snapshot"):
            assert time.monotonic() < deadline, "the flusher never flushed"
            time.sleep(0.02)
    finally:
        metrics.stop_flusher()
        metrics.reset()
    assert metrics._FLUSHER is None
    (first, *_) = _events(journals[0], "metrics_snapshot")
    assert first["seq"] == 1 and first["counters"] == {"n": 1}


# ------------------------------------------------ module state, threads

@pytest.fixture
def fast_switch():
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    yield
    sys.setswitchinterval(old)


def _run_threads(fn, n=16, timeout=60):
    threads = [threading.Thread(target=fn) for _ in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    assert not any(t.is_alive() for t in threads)


def test_library_loads_once_under_threads(monkeypatch, fast_switch):
    """Threads that ask for one library at once build and load it once."""
    builds, loads = [], []

    def fake_build(names):
        builds.append(names)
        time.sleep(0.05)
        return {}

    class FakeLib:
        def __init__(self, path):
            loads.append(path)
            self.tpkt_fake = lambda *a: 0

    monkeypatch.setattr(_build, "build", fake_build)
    monkeypatch.setattr(_build.ctypes, "CDLL", FakeLib)
    monkeypatch.setattr(_build, "library_path", lambda name: f"/x/{name}.so")
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "_FUNCS", {})
    got = []
    _run_threads(lambda: got.append(
        _build.function("fake", "tpkt_fake", [])))
    assert builds == [("fake",)] and loads == ["/x/fake.so"]
    assert len(got) == 16 and len({id(f) for f in got}) == 1


def test_launch_counts_lose_nothing_under_threads(fast_switch):
    from tpukernels_torch.kernels import LAUNCHES, count_launch

    before = LAUNCHES["saxpy"]

    def work():
        for _ in range(2000):
            count_launch("saxpy")

    _run_threads(work)
    assert LAUNCHES["saxpy"] - before == 16 * 2000


def test_plan_memo_forget_under_threads(fast_switch):
    from tpukernels_torch.tuning import space

    sp = registry.tunables("scan")
    errors = []

    def work():
        try:
            for i in range(300):
                space.plan_memo(sp, ("t", threading.get_ident(), i),
                                lambda: i)
                space.forget("scan")
        except RuntimeError as e:  # dict changed size during iteration
            errors.append(e)

    _run_threads(work, n=8)
    assert not errors
    space.forget("scan")


def test_guard_counts_every_call_under_threads(monkeypatch, fast_switch):
    import torch

    from tpukernels_torch.resilience import integrity

    monkeypatch.setenv("TPKT_INTEGRITY", "tripwire")
    monkeypatch.delenv("TPKT_HEALTH_JOURNAL", raising=False)
    integrity.reset()
    out = torch.ones(8)
    try:
        _run_threads(lambda: [integrity.guard("manual", "vector_add", out)
                              for _ in range(500)], n=8)
        assert integrity._CALLS[("manual", "vector_add")] == 8 * 500
    finally:
        integrity.reset()
