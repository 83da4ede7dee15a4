"""The metric readers, the reduction of a profiler's events and the work
of one call, on records made by hand."""

import math

import pytest

from cellbench import profiling, roofline, spec

H100 = roofline.peaks("NVIDIA H100 80GB HBM3")
A = profiling.ANNOTATION


def read(name, rec):
    return spec.load_module("metrics", name).read(rec)


def test_work_gives_chip_smokes_bounds():
    """The least time of one call's work against the H100's published
    peaks: 1.2508 ms for 1000 sweeps at 4096^2, 1.2821 ms for one N-body
    step at 65 536, each bound by its float32 operations."""
    cfg2 = spec.load_json(spec.config_file("jacobi2d-4096"))
    w = spec.load_module("work", "stencil2d").work(cfg2, {"iters": 1000})
    s, by = roofline.least_seconds(w, H100)
    assert round(s * 1e3, 4) == 1.2508 and by == "fp32_flops"
    cfgn = spec.load_json(spec.config_file("nbody-65536"))
    work = spec.load_module("work", "nbody").work
    s, by = roofline.least_seconds(work(cfgn, {"steps": 1}), H100)
    assert round(s * 1e3, 4) == 1.2821 and by == "fp32_flops"
    quarter, _ = roofline.least_seconds(work(cfgn, {"steps": 1}, ranks=4),
                                        H100)
    assert quarter == pytest.approx(s / 4)


def test_peaks_pick_the_cards_row():
    assert roofline.peaks("NVIDIA H100 PCIe")["hbm_bytes_s"] == 2.0e12
    assert roofline.peaks("NVIDIA H100 80GB HBM3")["fp32_flops"] == 67e12


def test_end_to_end_readers():
    lat = [float(i) for i in range(1, 101)]
    rec = {"calls": 100, "window_s": 2.0, "latency_ms": lat,
           "setup_s": 9.5}
    assert read("call_ms", rec) == pytest.approx(20.0)
    assert read("call_p95_ms", rec) == 95.0
    assert read("setup_s", rec) == 9.5
    assert read("call_ms", {"calls": 0, "window_s": 1.0}) is None
    assert read("call_p95_ms", {"latency_ms": []}) is None


def _events():
    """Two annotated calls on thread 7: device busy [10, 40) and
    [60, 90) of the window [0, 100); a launch open over the first gap,
    nothing but the annotation over the second."""
    return [
        (0, 50, A, False, 7), (50, 100, A, False, 7),
        (2, 12, "cudaLaunchKernel", False, 7),
        (10, 30, "jacobi2d_kernel<8>", True, None),
        (25, 40, "reduce_kernel", True, None),
        (60, 90, "jacobi2d_kernel<8>", True, None),
        (95, 99, "other thread", False, 8),
    ]


def test_profile_reduction_takes_the_union_and_names_the_gaps():
    p = profiling.reduce(_events())
    assert p["calls"] == 2 and p["window_s"] == pytest.approx(100e-9)
    assert p["busy_s"] == pytest.approx(60e-9)
    assert p["device_op_s"] == pytest.approx(65e-9)
    assert p["by_name"]["jacobi2d_kernel<8>"] == pytest.approx(50e-9)
    assert p["device_ops"][0][0] == "jacobi2d_kernel<8>"
    gaps = dict(p["idle_gaps"])
    assert gaps["cudaLaunchKernel"] == pytest.approx(10e-9)
    assert gaps[A] == pytest.approx(30e-9)
    assert "other thread" not in gaps
    assert profiling.reduce([(0, 5, "x", True, None)]) is None


def test_trace_readers_on_a_synthetic_record():
    prof = profiling.reduce(_events())
    rec = {"calls": 4, "span_calls": 2, "profile": prof,
           "least_s_per_call": 10e-9,
           "launches": {"jacobi2d": 500},
           "spans": [
               {"name": "dispatch/stencil2d", "wall_s": 0.01},
               {"name": "dispatch/stencil2d", "wall_s": 0.01},
               {"name": "dispatch/stencil2d/integrity/canary/stencil2d",
                "wall_s": 0.004},
               {"name": "dispatch/nbody/collective/nbody_ring",
                "wall_s": 0.003},
               {"name": "dispatch/nbody/collective/nbody_ring/"
                        "collective/ring_shift", "wall_s": 0.001},
               {"name": "dispatch/nbody/collective/all_gather",
                "wall_s": 0.001}]}
    assert read("canary_ms_per_call", rec) == pytest.approx(2.0)
    assert read("collective_ms_per_call", rec) == pytest.approx(2.0)
    assert read("launches_per_call", rec) == 125.0
    assert read("device_idle_pct", rec) == pytest.approx(40.0)
    # two calls of 10 ns least work over 50 ns of jacobi2d_kernel
    assert read("jacobi2d_roofline", rec) == pytest.approx(40.0)
    # no nbody_forces_kernel ran: silent, never 0
    assert read("nbody_forces_roofline", rec) is None


@pytest.mark.parametrize("name", [
    "canary_ms_per_call", "collective_ms_per_call", "launches_per_call",
    "device_idle_pct", "jacobi2d_roofline", "nbody_forces_roofline"])
def test_a_reader_with_nothing_to_read_returns_nothing(name):
    assert read(name, {"calls": 10, "span_calls": 5}) is None


def test_the_reservoir_is_uniform_and_seeded():
    import random

    from cellbench import harness

    picks = []
    for seed in (1, 2):
        r = harness.Reservoir(4, random.Random(seed))
        for i in range(1000):
            r.offer(i)
        picks.append(sorted(r.items))
        assert len(r.items) == 4 and r.seen == 1000
    r = harness.Reservoir(4, random.Random(1))
    for i in range(1000):
        r.offer(i)
    assert sorted(r.items) == picks[0] != picks[1]
    assert not math.isnan(sum(picks[0]))
