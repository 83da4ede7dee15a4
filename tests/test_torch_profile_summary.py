"""``obs/profile_summary.py`` and ``python -m tpukernels_torch.profile`` on
the CPU, against the reference's ``tools/profile_summary.py``.

- The port's interval union and plane summary equal the reference's
  ``_union_busy_ps`` and ``summarize_plane`` on the same seeded
  intervals: the reference reads ``SimpleNamespace`` XProf planes, the
  port a Chrome trace holding the same events (the union exact, busy %
  within 1e-9).
- A real CPU trace from the C entry's ``TPKT_PROFILE`` summarises: a host
  plane, its top ops in order, no device plane and rc 0.
- A trace without a device plane that was taken with a card is rc 1.
- A kernel name maps to the port's source of its ``__global__`` function.
- ``python -m tpukernels_torch.profile --device cpu`` writes both logs and
  traces; without a card and without the flag it exits non-zero.
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from tpukernels_torch.obs import profile_summary as ps

ROOT = Path(__file__).resolve().parent.parent


def _reference():
    spec = importlib.util.spec_from_file_location(
        "ref_profile_summary", ROOT / "tools" / "profile_summary.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _reference()
NAMES = ["kernel_a", "kernel_b", "void (anonymous namespace)::k<8>(float*)",
         "Memcpy HtoD (Pageable -> Device)"]


def _lines(seed):
    """Seeded lines of ``(timestamp_ns, [(offset_ps, duration_ps,
    name_index)])``: overlapping, nested and disjoint events."""
    rng = np.random.default_rng(seed)
    lines = []
    for _ in range(int(rng.integers(1, 4))):
        ts = int(rng.integers(10**12, 2 * 10**12))
        events = []
        for _ in range(int(rng.integers(1, 40))):
            events.append((int(rng.integers(0, 5 * 10**9)),
                           int(rng.integers(1, 10**9)),
                           int(rng.integers(0, len(NAMES)))))
        lines.append((ts, events))
    return lines


def _ref_plane(lines):
    meta = {i: SimpleNamespace(id=i, name=n) for i, n in enumerate(NAMES)}
    return SimpleNamespace(
        name="/device:TPU:0", event_metadata=meta,
        lines=[SimpleNamespace(timestamp_ns=ts, events=[
            SimpleNamespace(offset_ps=o, duration_ps=d, metadata_id=m)
            for o, d, m in evs]) for ts, evs in lines])


def _us(ps_value):
    """Picoseconds as an exact decimal string of microseconds."""
    return f"{ps_value // 10**6}.{ps_value % 10**6:06d}"


def _trace_text(lines):
    """A Chrome trace of the lines' events on stream tid = line index of
    card 0, written by hand so every timestamp is exact."""
    events = []
    for tid, (ts, evs) in enumerate(lines):
        for o, d, m in evs:
            events.append(
                f'{{"ph": "X", "cat": "kernel", "name": '
                f'{json.dumps(NAMES[m])}, "pid": 0, "tid": {tid}, '
                f'"ts": {_us(ts * 1000 + o)}, "dur": {_us(d)}}}')
    return ('{"schemaVersion": 1, "deviceProperties": [], "traceEvents": ['
            + ", ".join(events) + "]}")


@pytest.mark.parametrize("seed", range(6))
def test_union_and_summary_equal_the_references(tmp_path, seed):
    lines = _lines(seed)
    path = tmp_path / "t.json"
    path.write_text(_trace_text(lines))
    (plane,) = ps.planes(ps.load_trace(str(path)))
    assert plane.name == "/device:CUDA:0"
    # the union, line by line, exact
    for tid, (ts, evs) in enumerate(lines):
        ivs = [(ts * 1000 + o, ts * 1000 + o + d) for o, d, _m in evs]
        assert ps.union_busy_ps(ivs) == REF._union_busy_ps(ivs)
        got = [(s, e) for s, e, _n in plane.lines[tid]]
        assert ps.union_busy_ps(got) == REF._union_busy_ps(ivs)
    want = REF.summarize_plane(_ref_plane(lines))
    got = ps.summarize_plane(plane)
    assert got["ops"] == want["ops"]
    for key in ("span_ms", "busiest_line_ms", "busy_pct"):
        assert got[key] == pytest.approx(want[key], rel=0, abs=1e-9), key


def test_a_trace_directory_takes_its_newest_json(tmp_path):
    lines = _lines(0)
    (tmp_path / "a").mkdir()
    old, new = tmp_path / "a" / "old.json", tmp_path / "a" / "new.json"
    old.write_text(_trace_text(lines[:1]))
    new.write_text(_trace_text(lines))
    os.utime(old, (1, 1))
    assert ps.find_trace(str(tmp_path)) == str(new)
    assert ps.find_trace(str(old)) == str(old)
    with pytest.raises(FileNotFoundError):
        ps.find_trace(str(tmp_path / "empty_dir_missing"))


CPU_CALL = """
import torch
from tpukernels_torch import capi, registry
x = torch.arange(1 << 14, dtype=torch.float32)
with capi._profiled("vector_add"):
    registry.dispatch("vector_add", 2.0, x, x)
"""


@pytest.fixture
def cpu_trace(tmp_path):
    """A Chrome trace the C entry's profiler wrote around one CPU call, in
    a process that sees no card (hidden on a host that has one)."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPKT_", "TPK_"))}
    env.update(PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="",
               TPKT_PROFILE=str(tmp_path / "prof"),
               TPKT_TUNING_CACHE_DIR=str(tmp_path / "tuning"),
               TPKT_INTEGRITY_DIR=str(tmp_path / "integrity"),
               TPKT_AOT_DIR=str(tmp_path / "aot"))
    p = subprocess.run([sys.executable, "-c", CPU_CALL], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    (path,) = (tmp_path / "prof").glob("capi_*_vector_add.json")
    return path


def test_a_cpu_trace_from_the_c_entry_summarises(cpu_trace, capsys):
    assert ps.main([str(cpu_trace.parent), "--top=5"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"# trace: {cpu_trace}"
    assert out[1].startswith("plane '/host:CPU': span=")
    assert out[-1].startswith("# WARNING: no device plane found")
    # the top ops, by the summed duration of their events, in order
    sums = {}
    for e in json.loads(cpu_trace.read_text())["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") in ps.HOST_CATS:
            sums[e["name"]] = sums.get(e["name"], 0.0) + e["dur"]
    want = sorted(sums, key=lambda n: (-sums[n], n))[:5]
    printed = [ln.split()[0] for ln in out[2:-1]]
    assert printed == want and len(printed) == min(5, len(sums))
    ms = [float(ln.split()[-2]) for ln in out[2:-1]]
    assert ms == sorted(ms, reverse=True)


@pytest.mark.parametrize("marker", ["deviceProperties", "cuda_runtime"])
def test_no_device_plane_on_a_card_is_rc_1(cpu_trace, tmp_path, capsys,
                                           marker):
    trace = json.loads(cpu_trace.read_text())
    if marker == "deviceProperties":
        trace["deviceProperties"] = [{"id": 0,
                                      "name": "NVIDIA H100 80GB HBM3"}]
    else:
        trace["traceEvents"].append(
            {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
             "pid": 1, "tid": 1, "ts": 1.0, "dur": 2.0})
    path = tmp_path / "card.json"
    path.write_text(json.dumps(trace))
    assert ps.main([str(path)]) == 1
    out = capsys.readouterr().out
    assert "# ERROR: the trace was taken with a card and holds no" in out
    assert "busy=" in out  # the host plane is still printed


def test_usage_and_missing_trace(tmp_path, capsys):
    assert ps.main([]) == 2
    assert ps.main([str(tmp_path), "--top=x"]) == 2
    assert ps.main([str(tmp_path / "nothing")]) == 2
    assert "no *.json trace" in capsys.readouterr().err


@pytest.mark.parametrize("name, source", [
    ("void tpkt_gemm::(anonymous namespace)::sgemm_ring_kernel<0, 128, 64, "
     "2, 1>(CUtensorMap, CUtensorMap, float const*, float*, int)",
     "tpukernels_torch/csrc/sgemm_ring.cuh"),
    ("void (anonymous namespace)::sgemm_prep_kernel<0>((anonymous "
     "namespace)::Job, (anonymous namespace)::Job, int)",
     "tpukernels_torch/csrc/sgemm_prep.cu"),
    ("void (anonymous namespace)::jacobi2d_kernel<8>(float const*, float*, "
     "int, int, (anonymous namespace)::Plan, bool, bool)",
     "tpukernels_torch/csrc/jacobi2d.cu"),
    ("void lookback::scan_tiles<int, lookback::Add>(int const*, int*)",
     "tpukernels_torch/csrc/scan.cuh"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "FillFunctor<float>, std::array<char*, 1ul> >(int, "
     "at::native::FillFunctor<float>, std::array<char*, 1ul>)", None),
    ("Memcpy DtoH (Device -> Pageable)", None),
])
def test_a_kernel_maps_to_its_port_source(name, source):
    assert ps.kernel_source(name) == source


def test_every_port_kernel_is_found():
    assert ps.port_kernels() == {
        "histogram_kernel": "tpukernels_torch/csrc/histogram.cu",
        "jacobi2d_kernel": "tpukernels_torch/csrc/jacobi2d.cu",
        "jacobi3d_kernel": "tpukernels_torch/csrc/jacobi3d.cu",
        "nbody_forces_kernel": "tpukernels_torch/csrc/nbody.cu",
        "saxpy_kernel": "tpukernels_torch/csrc/saxpy.cu",
        "sgemm_prep_kernel": "tpukernels_torch/csrc/sgemm_prep.cu",
        "scan_tiles": "tpukernels_torch/csrc/scan.cuh",
        "sgemm_ring_kernel": "tpukernels_torch/csrc/sgemm_ring.cuh",
    }


def _profile(args, tmp_path, **extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPKT_", "TPK_"))}
    env.update(PYTHONPATH=str(ROOT),
               TPKT_SUPERVISOR_DIR=str(tmp_path / "sup"),
               TPKT_TUNING_CACHE_DIR=str(tmp_path / "tuning"), **extra)
    return subprocess.run([sys.executable, "-m", "tpukernels_torch.profile",
                           *args], env=env, cwd=ROOT, capture_output=True,
                          text=True, timeout=300)


def test_profile_on_the_cpu_writes_both_logs(tmp_path):
    out = tmp_path / "out"
    p = _profile([str(out), "--device", "cpu"], tmp_path)
    assert p.returncode == 0, p.stdout + p.stderr
    record = json.loads(p.stdout.strip().splitlines()[-1])["profile"]
    assert list(record) == ["sgemm", "stencil"]
    for label, r in record.items():
        log, trace = Path(r["log"]), Path(r["trace"])
        assert log.parent == out and log.name.startswith(f"profile_{label}_")
        assert trace.is_file() and r["rc"] == 0
        text = log.read_text()
        assert text.startswith("# device: cpu (cpu), torch ")
        assert f"# trace: {trace}" in text
        assert "plane '/host:CPU'" in text
        (host,) = r["planes"]
        assert host["name"] == "/host:CPU" and 0 < host["busy_pct"] <= 100
        assert len(host["top"]) == 5
    assert not (tmp_path / "sup").exists()  # the outdir was given


def test_profile_without_a_card_or_the_flag_refuses(tmp_path):
    # no card: hidden from the child on a host that has one
    p = _profile([], tmp_path, CUDA_VISIBLE_DEVICES="")
    assert p.returncode == 2
    assert "no CUDA device" in p.stderr
    assert not (tmp_path / "sup").exists()


def test_profile_defaults_to_the_supervisors_logs(tmp_path, monkeypatch):
    from tpukernels_torch import profile

    monkeypatch.setenv("TPKT_SUPERVISOR_DIR", str(tmp_path / "sup"))
    assert profile.default_outdir() == str(tmp_path / "sup" / "logs")
    monkeypatch.delenv("TPKT_SUPERVISOR_DIR")
    assert profile.default_outdir() == str(
        ROOT / ".tpkt_cache" / "supervisor" / "logs")
