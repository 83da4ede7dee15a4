#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``tpukernels_torch``) on one GPU.

    python3 chip_smoke.py [--seed N]

Builds the port's CUDA kernels from ``tpukernels_torch/csrc`` (into
``tpukernels_torch/_build/``), then:

1. prints the card (``nvidia-smi`` name and power limit) and toolchain,
   and turns TF32 off for float32 matmuls;
2. builds every kernel, in parallel, and prints the build times;
3. holds each kernel against its plain PyTorch version on the card at
   the sizes of the main path and at ragged ones, with the tolerance
   stated beside each check;
4. drives the main path end to end — ``registry.dispatch`` of
   ``vector_add``, ``sgemm``, ``stencil2d``, ``stencil3d``, ``nbody``,
   ``scan``, ``scan_exclusive``, ``histogram`` and ``scan_histogram``
   (fuse off, then on) at the configurations of record and at the
   canary configurations — checks each result against the port's oracle
   (N-body at 65 536 bodies against its chunked plain version; the
   int32 keys bitwise), and shows from the launch counters that every
   kernel ran;
5. times each kernel, its plain version and, where one exists, the
   single PyTorch call computing the same function, with CUDA events,
   beside the least time the card could take (``bound_ms``); for scan
   and histogram also the device time alone (``device_ms``: calls
   captured in a CUDA graph and replayed) and the scan's tile sizes.

It prints one JSON line of per-kernel results before the last line,
and as the last line ``{"ok": true, "device": {...}}``. Any failed
check raises: the script then exits non-zero and prints no result. It
needs a CUDA device and the repository's ``tpukernels_torch`` package;
it imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

# published dense peaks (NVIDIA data sheets): bytes/s of device memory,
# bf16 tensor-core flop/s, fp32 (non-tensor) flop/s
PEAKS = (
    ("H100 PCIe", 2.0e12, 756e12, 51e12),
    ("H100 NVL", 3.9e12, 835e12, 60e12),
    ("H100", 3.35e12, 989e12, 67e12),  # SXM
)

SAXPY_ALPHA = 0.7
GEMM_ALPHA, GEMM_BETA = 1.5, 0.5
NBODY_N = 1 << 16  # the configuration of record: dt 1e-3, eps 1e-2, 1 step
STENCIL3D_N, STENCIL3D_ITERS = 384, 8
# the C golden checkers' bars: c/stencil.c (Jacobi, bitwise expected),
# c/nbody.c (N-body against its plain version; rsqrtf and the sum order
# differ)
JACOBI_BAND = (1e-4, 1e-5)
NBODY_BAND = (2e-3, 2e-4)
# scan + histogram: the configuration of record (scan_hist_melem_s,
# 2^22 int32 in [0, 256), 256 bins), which fits in the 50 MB L2, and a
# size that streams device memory
SCAN_N, SCAN_NBINS, STREAM_N = 1 << 22, 256, 1 << 26
# the reference's float32 scan band (tests/test_scan_histogram.py)
SCAN_F32_BAND = (1e-4, 1e-2)
# more bins than a block keeps in shared memory (TPKT_SMEM_BINS, 32768,
# csrc/bins.cuh): the kernels count with global atomics
GLOBAL_NBINS = 40000
# a histogram above 256 bins, where the reference took its VPU kernel
WIDE_NBINS = 1024


def log(msg=""):
    print(msg, flush=True)


def peaks_for(name):
    for key, bw, bf16, fp32 in PEAKS:
        if key in name:
            return key, bw, bf16, fp32
    key, bw, bf16, fp32 = PEAKS[-1]
    log(f"note: no peak table for {name!r}; using the {key} SXM peaks")
    return key, bw, bf16, fp32


def bound(nbytes, ops, op_rate, bw):
    """(bound_ms, bound_by): the larger of bytes over the memory rate
    and operations over the peak rate for their type."""
    t_bytes, t_ops = nbytes / bw * 1e3, ops / op_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(got, want):
    d = (got.double() - want.double()).abs()
    both_nan = got.isnan() & want.isnan()
    d = d.masked_fill(both_nan, 0.0)
    return float(d.max()) if d.numel() else 0.0


def check(label, got, want, rtol, atol):
    """Fail unless |got - want| <= atol + rtol·|want| everywhere (NaN
    where the reference has NaN); returns the largest |got - want|."""
    import torch

    if got.shape != want.shape:
        raise AssertionError(f"{label}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    ok = torch.isclose(got, want, rtol=rtol, atol=atol, equal_nan=True)
    err = max_abs_err(got, want)
    bitwise = bool(torch.equal(got, want))
    if not bool(ok.all()):
        bad = int((~ok).sum())
        raise AssertionError(
            f"{label}: {bad}/{got.numel()} elements outside rtol={rtol:g} "
            f"atol={atol:g}; max_abs_err={err:.3e}"
        )
    log(f"PASS {label}: max_abs_err={err:.3e} (rtol={rtol:g}, "
        f"atol={atol:.3g}){' bitwise' if bitwise else ''}")
    return err


def check_exact(label, got, want):
    """Fail unless got equals want element for element, with the same
    shape and dtype; returns the largest |got - want|, 0."""
    import torch

    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{label}: {tuple(got.shape)} {got.dtype} != "
                             f"{tuple(want.shape)} {want.dtype}")
    if not torch.equal(got, want):
        bad = int((got != want).sum())
        raise AssertionError(
            f"{label}: {bad}/{got.numel()} elements differ; "
            f"max_abs_err={max_abs_err(got, want):.3e}")
    log(f"PASS {label}: bitwise")
    return 0.0


@contextlib.contextmanager
def knobs(**values):
    """Set environment knobs (``TPKT_*``) for the body, then restore
    them."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update({k: str(v) for k, v in values.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def bodies(gen, n):
    """Seven float32 SoA arrays on the card: positions and velocities
    normal, masses uniform in [0.5, 1.5), as the reference's canary."""
    import torch

    arrs = [torch.randn(n, device="cuda", generator=gen) for _ in range(6)]
    return arrs + [torch.rand(n, device="cuda", generator=gen) + 0.5]


def stacked(out):
    """A tuple-valued result (N-body's six arrays) as one tensor."""
    import torch

    return torch.stack(out) if isinstance(out, tuple) else out


def time_ms(fn, reps, warmup=2):
    """Mean ms per call of ``fn`` over ``reps`` calls, CUDA events,
    after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, calls, reps=10):
    """Device time of one call of ``fn``, without the host's cost per
    call: ``calls`` calls captured in one CUDA graph, the graph replayed
    ``reps`` times after warm-up."""
    import torch

    fn()  # builds, loads and warms the allocator outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    ms = time_ms(graph.replay, reps) / calls
    del graph
    return ms


def run(cmd):
    try:
        p = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except FileNotFoundError:
        return None
    return p.stdout.strip()


def phase_toolchain(torch):
    log("== phase 1: card and toolchain")
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"])
    if not smi:
        raise RuntimeError("nvidia-smi gave no card name and power limit")
    card = smi.splitlines()[0]
    log(f"card: {card}")
    from tpukernels_torch import _build

    nvcc = run([_build.nvcc(), "--version"]) or ""
    try:
        import triton

        triton_version = triton.__version__
    except ImportError:
        triton_version = "absent"
    cutlass = os.path.isdir(os.path.join(
        os.environ.get("CUTLASS_PATH", "/usr/local/cutlass"), "include",
        "cutlass"))
    log(f"torch {torch.__version__}, torch.version.cuda "
        f"{torch.version.cuda}, device {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()}")
    log(f"nvcc: {nvcc.splitlines()[-1] if nvcc else 'absent'}")
    log(f"triton: {triton_version}; CUTLASS headers: "
        f"{'present' if cutlass else 'absent'}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("torch.backends.cuda.matmul.allow_tf32 = False (float32 matmuls "
        "of the plain versions and yardsticks run in full fp32)")
    return card


def phase_build():
    log("== phase 2: build")
    from tpukernels_torch import _build

    t0 = time.perf_counter()
    secs = _build.build()
    wall = time.perf_counter() - t0
    for name, s in secs.items():
        log(f"built {name}.cu in {s:.1f} s")
    log(f"build wall: {wall:.1f} s ({len(secs)} compiled, "
        f"{len(_build.SOURCES) - len(secs)} already built)")
    for name in _build.SOURCES:
        logf = _build.library_path(name).with_suffix(".log")
        if logf.exists():
            for line in logf.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"ptxas {name}: {line.strip()}")


def phase_kernels(torch, gen):
    """Each kernel against its plain version; returns max_abs_err at the
    main-path sizes."""
    log("== phase 3: kernels against their plain versions")
    from tpukernels_torch.kernels import nbody as NB
    from tpukernels_torch.kernels import sgemm as S, stencil as J
    from tpukernels_torch.kernels import vector_add as V

    dev = torch.device("cuda")

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    def unif(*shape):  # the C golden checker's [-1, 1) operands
        return torch.rand(*shape, device=dev, generator=gen) * 2 - 1

    errs = {}
    for n in (1000, 1 << 20, 1 << 26):
        x, y = randn(n), randn(n)
        e = check(f"saxpy n={n}", V.saxpy(SAXPY_ALPHA, x, y),
                  V.saxpy_reference(SAXPY_ALPHA, x, y), 1e-5, 1e-6)
        errs.setdefault("saxpy", {})[n] = e
        del x, y
    x, y = randn(1001), randn(1001)  # offset views: the unaligned path
    check("saxpy n=1000 unaligned", V.saxpy(SAXPY_ALPHA, x[1:], y[1:]),
          V.saxpy_reference(SAXPY_ALPHA, x[1:], y[1:]), 1e-5, 1e-6)

    for m, k, n in ((1024, 1024, 1024), (1000, 1042, 2176), (40, 72, 56)):
        a, b, c = unif(m, k), unif(k, n), unif(m, n)
        ref = S.sgemm_reference(GEMM_ALPHA, a, b, GEMM_BETA, c)
        for prec in S.PRECISIONS:
            rtol, atol = S.contract(prec, k, GEMM_ALPHA)
            got = S.sgemm(GEMM_ALPHA, a, b, GEMM_BETA, c, precision=prec)
            plain = S.sgemm_plain(GEMM_ALPHA, a, b, GEMM_BETA, c, prec)
            e = check(f"sgemm[{prec}] {m}x{k}x{n} vs plain", got, plain,
                      rtol, atol)
            check(f"sgemm[{prec}] {m}x{k}x{n} vs oracle", got, ref, rtol,
                  atol)
            if (m, k, n) == (1024, 1024, 1024):
                errs[f"sgemm_{prec}"] = e
    a, b = unif(128, 128), unif(128, 128)
    c = torch.full((128, 128), float("nan"), device=dev)
    for prec in S.PRECISIONS:
        got = S.sgemm(1.0, a, b, 0.0, c, precision=prec)
        if not bool(got.isnan().all()):
            raise AssertionError(f"sgemm[{prec}] beta=0: NaN in C did not "
                                 "propagate")
        log(f"PASS sgemm[{prec}] beta=0 with NaN in C: all NaN, as the "
            "oracle")

    for (h, w), iters, k in (((40, 200), 4, None), ((1024, 1536), 13, 1),
                              ((1024, 1536), 13, 8),
                              ((4096, 4096), 1000, None)):
        x = randn(h, w)
        e = check(f"jacobi2d {h}x{w} iters={iters} k={k or 'default'}",
                  J.jacobi2d(x, iters, k=k), J.jacobi2d_plain(x, iters),
                  1e-4, 1e-5)
        if (h, w) == (4096, 4096):
            errs["jacobi2d"] = e

    n3 = STENCIL3D_N
    for shape, iters, k in (((8, 24, 132), 2, None), ((33, 70, 130), 9, 1),
                            ((33, 70, 130), 9, 2), ((33, 70, 130), 9, None),
                            ((n3, n3, n3), STENCIL3D_ITERS, None)):
        x = randn(*shape)
        e = check(f"jacobi3d {'x'.join(map(str, shape))} iters={iters} "
                  f"k={k or 'default'}", J.jacobi3d(x, iters, k=k),
                  J.jacobi3d_plain(x, iters), *JACOBI_BAND)
        if shape[0] == n3:
            errs["jacobi3d"] = e
        del x

    for n, steps in ((192, 1), (1000, 2), (4096, 1), (NBODY_N, 1)):
        b = bodies(gen, n)
        got = stacked(NB.nbody_step(*b, steps=steps))
        e = check(f"nbody n={n} steps={steps} vs chunked plain", got,
                  stacked(NB.nbody_plain(*b, steps=steps)), *NBODY_BAND)
        if n <= 4096:  # the pairwise oracle makes (n, n) temporaries
            check(f"nbody n={n} steps={steps} vs oracle", got,
                  stacked(NB.nbody_reference(*b, steps=steps)), 1e-3, 1e-3)
        if n == NBODY_N:
            errs["nbody_forces"] = e
        del b, got
    b = bodies(gen, 192)
    for label, out in (("kernel", NB.nbody_step(*b, eps=0.0)),
                       ("plain", NB.nbody_plain(*b, eps=0.0))):
        if not bool(stacked(out).isnan().all()):
            raise AssertionError(f"nbody {label} eps=0: self-pairs did not "
                                 "give NaN everywhere")
    log("PASS nbody eps=0: every output NaN in kernel and plain version "
        "(self-pairs 0*inf), as the reference")
    errs.update(scan_kernels(torch, gen))
    return errs


def scan_kernels(torch, gen):
    """Phase 3 for scan, histogram and the fused pair: int32 and counts
    bitwise, float32 in the reference's band."""
    from tpukernels_torch.kernels import histogram as H, scan as SC
    from tpukernels_torch.kernels import scan_histogram as SH

    dev = torch.device("cuda")

    def ints(n, lo, hi):
        return torch.randint(lo, hi, (n,), device=dev, generator=gen,
                             dtype=torch.int32)

    errs = {}
    for n in (1, 7, 4093, 1_000_003, SCAN_N, STREAM_N):
        x = ints(n, -1000, 1000)
        got = SC.inclusive_scan(x)
        e = check_exact(f"scan int32 n={n} vs plain", got, SC.scan_plain(x))
        check_exact(f"scan int32 n={n} vs oracle", got,
                    SC.inclusive_scan_reference(x))
        if n == SCAN_N:
            errs["scan"] = e
        del x, got
    x = ints(1 << 20, (1 << 30) - 1000, 1 << 30)
    check_exact("scan int32 n=2^20 near 2^30 (wraps mod 2^32) vs oracle",
                SC.inclusive_scan(x), SC.inclusive_scan_reference(x))
    x = ints(1_000_004, -1000, 1000)[1:]  # offset view: no 16-byte loads
    for tile in SC.TILES:
        with knobs(TPKT_SCAN_TILE=tile):
            check_exact(f"scan int32 n=1000003 unaligned tile={tile} vs "
                        "plain", SC.inclusive_scan(x), SC.scan_plain(x))
    for n in (7, 1000, 1 << 17):
        x = torch.randn(n, device=dev, generator=gen)
        got = SC.inclusive_scan(x)
        check(f"scan float32 n={n} vs float64 cumsum", got.double(),
              torch.cumsum(x.double(), 0), *SCAN_F32_BAND)
        check(f"scan float32 n={n} vs plain", got, SC.scan_plain(x),
              *SCAN_F32_BAND)
    for n in (0, 1, 4093):
        x = ints(n, -1000, 1000)
        check_exact(f"exclusive scan n={n} vs oracle", SC.exclusive_scan(x),
                    SC.exclusive_scan_reference(x))

    # negative values and values >= nbins mixed in: they count nothing
    for nbins in (4, 16, 200, 256, 1024, GLOBAL_NBINS):
        x = ints(1 << 20, -max(nbins // 8, 2), nbins + max(nbins // 8, 2))
        check_exact(f"histogram n=2^20 nbins={nbins} (out-of-range mixed "
                    "in) vs plain", H.histogram(x, nbins),
                    H.histogram_plain(x, nbins))
    for n in (SCAN_N, STREAM_N):
        x = ints(n, 0, SCAN_NBINS)
        got = H.histogram(x, SCAN_NBINS)
        e = check_exact(f"histogram n={n} nbins=256 vs plain", got,
                        H.histogram_plain(x, SCAN_NBINS))
        check_exact(f"histogram n={n} nbins=256 vs oracle", got,
                    H.histogram_reference(x, SCAN_NBINS))
        if n == SCAN_N:
            errs["histogram"] = e
        del x, got
    x = torch.full((SCAN_N,), 7, dtype=torch.int32, device=dev)
    check_exact("histogram n=2^22 all one value (skew) vs plain",
                H.histogram(x, SCAN_NBINS), H.histogram_plain(x, SCAN_NBINS))
    x = ints(4098, 0, 200)[1:]
    check_exact("histogram n=4097 unaligned nbins=200 vs plain",
                H.histogram(x, 200), H.histogram_plain(x, 200))
    check_exact("histogram n=0", H.histogram(ints(0, 0, 1), 16),
                torch.zeros(16, dtype=torch.int32, device=dev))

    cases = [(SCAN_N, SCAN_NBINS, None), (999, 16, None), (4093, 1024, None),
             (1 << 20, GLOBAL_NBINS, None), (STREAM_N, SCAN_NBINS, None)]
    cases += [(1_000_003, nb, t) for nb in (SCAN_NBINS, GLOBAL_NBINS)
              for t in SC.TILES]
    for n, nbins, tile in cases:
        label = f"scan_histogram[on] n={n} nbins={nbins}" + (
            f" tile={tile}" if tile else "")
        x = ints(n, -max(nbins // 8, 2), nbins + max(nbins // 8, 2))
        with knobs(TPKT_SCANHIST_FUSE="off"):
            off = SH.scan_histogram(x, nbins)
        tiles = {"TPKT_SCAN_TILE": tile} if tile else {}
        with knobs(TPKT_SCANHIST_FUSE="on", **tiles):
            got = SH.scan_histogram(x, nbins)
        for part, g, p, o in zip(("scan", "histogram"), got,
                                 SH.scan_histogram_plain(x, nbins), off):
            e = check_exact(f"{label} {part} vs plain", g, p)
            check_exact(f"{label} {part} vs fuse=off", g, o)
            if (n, nbins) == (SCAN_N, SCAN_NBINS):
                errs["scan_histogram"] = e
        del x, got, off
    with knobs(TPKT_SCANHIST_FUSE="on"):
        s, h = SH.scan_histogram(ints(0, 0, 1), 16)
    check_exact("scan_histogram[on] n=0 scan", s, ints(0, 0, 1))
    check_exact("scan_histogram[on] n=0 histogram", h,
                torch.zeros(16, dtype=torch.int32, device=dev))
    return errs


def phase_main_path(torch, gen):
    log("== phase 4: main path end to end (registry.dispatch)")
    from tpukernels_torch import interop, registry
    from tpukernels_torch.kernels import LAUNCHES, reset_launches
    from tpukernels_torch.kernels import nbody as NB, sgemm as S
    from tpukernels_torch.resilience import integrity

    dev = torch.device("cuda")

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    def unif(*shape):  # the C golden checker's [-1, 1) operands
        return torch.rand(*shape, device=dev, generator=gen) * 2 - 1

    def against_oracle(label, name, args, out, statics, band=None,
                       oracle=None):
        kind, rtol, atol = integrity.tolerance(name)
        if band is not None:
            kind, (rtol, atol) = "band", band
        statics = {k: v for k, v in statics.items() if k != "precision"}
        want = (oracle or integrity.oracle(name))(*args, **statics)
        if kind == "band":
            check(f"dispatch {label}", stacked(out), stacked(want), rtol,
                  atol)
            return
        # exact: element by element (scan_histogram's parts differ in
        # shape)
        pairs = zip(out, want) if isinstance(want, tuple) else [(out, want)]
        for i, (g, w) in enumerate(pairs):
            part = f" [{i}]" if isinstance(want, tuple) else ""
            check_exact(f"dispatch {label}{part}", g, w)

    # (key, label, operands, statics, band or None, oracle or None,
    # knobs set for the call)
    record = []
    for n in (1 << 20, 1 << 26):
        record.append(("vector_add", f"n={n}",
                       (SAXPY_ALPHA, randn(n), randn(n)), {}, None, None,
                       {}))
    gemm = (GEMM_ALPHA, unif(1024, 1024), unif(1024, 1024), GEMM_BETA,
            unif(1024, 1024))
    record.append(("sgemm", "1024^3 (precision of record)", gemm, {}, None,
                   None, {}))
    for prec in ("float32", "default"):
        record.append(("sgemm", f"1024^3 precision={prec}", gemm,
                       {"precision": prec},
                       S.contract(prec, 1024, GEMM_ALPHA), None, {}))
    record.append(("stencil2d", "4096^2 iters=1000", (randn(4096, 4096),),
                   {"iters": 1000}, None, None, {}))
    n3 = STENCIL3D_N
    record.append(("stencil3d", f"{n3}^3 iters={STENCIL3D_ITERS}",
                   (randn(n3, n3, n3),), {"iters": STENCIL3D_ITERS}, None,
                   None, {}))
    # the pairwise oracle would need (n, n) temporaries of 16 GiB: the
    # chunked plain version at the C checker's bar stands in for it
    record.append(("nbody", f"n={NBODY_N} steps=1", tuple(bodies(gen,
                                                               NBODY_N)),
                   dict(integrity.CANARY_CONFIGS["nbody"]["statics"]),
                   NBODY_BAND, NB.nbody_plain, {}))
    # scan + histogram at the configuration of record: fuse off (the path
    # of record), then the fused kernel
    x = torch.randint(0, SCAN_NBINS, (SCAN_N,), device=dev, generator=gen,
                      dtype=torch.int32)
    hist = {"nbins": SCAN_NBINS}
    for name, st, env in (("scan", {}, {}), ("scan_exclusive", {}, {}),
                          ("histogram", hist, {}),
                          ("scan_histogram", hist,
                           {"TPKT_SCANHIST_FUSE": "off"}),
                          ("scan_histogram", hist,
                           {"TPKT_SCANHIST_FUSE": "on"})):
        label = "n=2^22" + (" nbins=256" if st else "") + "".join(
            f" fuse={v}" for v in env.values())
        record.append((name, label, (x,), st, None, None, env))
    canaries = [
        (name, "canary", interop.to_port(name, integrity.build_args(name)),
         integrity.CANARY_CONFIGS[name]["statics"], None, None, {})
        for name in ("vector_add", "sgemm", "stencil2d", "stencil3d",
                     "nbody", "scan", "scan_exclusive", "histogram",
                     "scan_histogram")
    ]
    torch.cuda.synchronize()

    def run(name, args, st, env):
        with knobs(**env):
            return registry.dispatch(name, *args, **st)

    reset_launches()
    registry.reset_calls()
    outs = [run(name, args, st, env)
            for name, _, args, st, _, _, env in record + canaries]
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    calls = registry.calls()

    for (name, label, args, st, band, oracle, _), out in zip(
            record + canaries, outs):
        against_oracle(f"{name} {label}", name, args, out, st, band, oracle)
    log("kernels: " + json.dumps(launches))
    log("dispatch calls: " + json.dumps(calls))
    idle = [k for k, v in launches.items() if v <= 0]
    if idle:
        raise AssertionError(f"kernels not launched on the main path: {idle}")
    return launches


def phase_times(torch, gen, peaks):
    log("== phase 5: times (CUDA events, after warm-up)")
    from tpukernels_torch.kernels import nbody as NB
    from tpukernels_torch.kernels import sgemm as S, stencil as J
    from tpukernels_torch.kernels import vector_add as V

    _, bw, bf16, fp32 = peaks
    dev = torch.device("cuda")
    out = {}

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    def canary(label, fn, plain, shape, iters, k, flops_per_cell):
        """A Jacobi kernel at its canary shape, where the reference took
        its small, whole-grid-in-VMEM kernel."""
        x = randn(*shape)
        interior = 1
        for s in shape:
            interior *= s - 2
        row = {
            "shape": list(shape), "iters": iters, "k": k,
            "ms": time_ms(lambda: fn(x, iters), 200),
            "plain_ms": time_ms(lambda: plain(x, iters), 200),
            "library_ms": None,
            "launches_per_call": len(J.passes(iters, k)),
        }
        row["bound_ms"], row["bound_by"] = bound(
            8 * x.numel(), flops_per_cell * interior * iters, fp32, bw)
        out[label] = row

    for n, reps in ((1 << 20, 200), (1 << 26, 20)):
        x, y = randn(n), randn(n)
        row = {
            "n": n,
            "ms": time_ms(lambda: V.saxpy(SAXPY_ALPHA, x, y), reps),
            "plain_ms": time_ms(
                lambda: V.saxpy_reference(SAXPY_ALPHA, x, y), reps),
            "library_ms": time_ms(
                lambda: torch.add(y, x, alpha=SAXPY_ALPHA), reps),
            "launches_per_call": 1,
        }
        row["bound_ms"], row["bound_by"] = bound(12 * n, 2 * n, fp32, bw)
        out[f"saxpy n={n}"] = row
        del x, y

    m = k = n = 1024
    a, b, c = (torch.rand(*s, device=dev, generator=gen) * 2 - 1
               for s in ((m, k), (k, n), (m, n)))
    lib = time_ms(lambda: torch.addmm(c, a, b, beta=GEMM_BETA,
                                      alpha=GEMM_ALPHA), 20)
    for prec, work, rate in (("high", 3 * 2 * m * n * k, bf16),
                             ("float32", 2 * m * n * k, fp32),
                             ("default", 2 * m * n * k, bf16)):
        row = {
            "shape": [m, k, n],
            "ms": time_ms(lambda: S.sgemm(GEMM_ALPHA, a, b, GEMM_BETA, c,
                                          precision=prec), 20),
            "plain_ms": time_ms(lambda: S.sgemm_plain(
                GEMM_ALPHA, a, b, GEMM_BETA, c, prec), 20),
            "library_ms": lib,
            "launches_per_call": 1,
        }
        row["bound_ms"], row["bound_by"] = bound(
            4 * (m * k + k * n + 2 * m * n), work, rate, bw)
        out[f"sgemm[{prec}]"] = row

    h = w = 4096
    iters = 1000
    x = randn(h, w)
    kk = J.resolve_k()
    row = {
        "shape": [h, w], "iters": iters, "k": kk,
        "ms": time_ms(lambda: J.jacobi2d(x, iters), 3, warmup=1),
        "plain_ms": time_ms(lambda: J.jacobi2d_plain(x, iters), 1,
                            warmup=1),
        "library_ms": None,
        "launches_per_call": len(J.passes(iters, kk)),
    }
    row["bound_ms"], row["bound_by"] = bound(
        8 * h * w, 5 * (h - 2) * (w - 2) * iters, fp32, bw)
    # the k-sweep pass structure moves 8 bytes per cell per launch
    row["pass_bytes_ms"] = 8 * h * w * row["launches_per_call"] / bw * 1e3
    out["jacobi2d"] = row

    canary("jacobi2d canary", J.jacobi2d, J.jacobi2d_plain, (40, 200), 4,
           kk, 5)

    n3, iters = STENCIL3D_N, STENCIL3D_ITERS
    x = randn(n3, n3, n3)
    k3 = J.resolve_k(None, 3)
    row = {
        "shape": [n3] * 3, "iters": iters, "k": k3,
        "ms": time_ms(lambda: J.jacobi3d(x, iters), 10),
        "plain_ms": time_ms(lambda: J.jacobi3d_plain(x, iters), 2, warmup=1),
        "library_ms": None,
        "launches_per_call": len(J.passes(iters, k3)),
    }
    row["bound_ms"], row["bound_by"] = bound(
        8 * n3 ** 3, 6 * (n3 - 2) ** 3 * iters, fp32, bw)
    row["pass_bytes_ms"] = 8 * n3 ** 3 * row["launches_per_call"] / bw * 1e3
    # every fusion depth the kernel takes: the default is the fastest
    row["per_k_ms"] = {kk3: time_ms(lambda: J.jacobi3d(x, iters, k=kk3), 10)
                       for kk3 in range(1, J.HALO3D_MAX + 1)}
    out["jacobi3d"] = row
    del x
    canary("jacobi3d canary", J.jacobi3d, J.jacobi3d_plain, (8, 24, 132), 2,
           k3, 6)

    n = NBODY_N
    b = bodies(gen, n)
    bi, bj = NB._tiles()
    eps2 = NB._eps2(1e-2)  # the configuration of record
    row = {
        "n": n, "steps": 1, "bi": bi, "bj": bj,
        "ms": time_ms(lambda: NB.nbody_step(*b), 10),
        "plain_ms": time_ms(lambda: NB.nbody_plain(*b), 1, warmup=1),
        "library_ms": None,
        "launches_per_call": 1,
        # the forces launch alone, without the six integration ops
        "forces_ms": time_ms(lambda: NB._forces_cuda(
            b[0], b[1], b[2], b[6], eps2, bi, bj), 10),
    }
    # 20 flops per pair, the reference's CostEstimate; 7 arrays in, 6 out
    row["bound_ms"], row["bound_by"] = bound(4 * 13 * n, 20 * n * n, fp32,
                                             bw)
    out["nbody"] = row
    out.update(scan_times(torch, gen, peaks))

    for label, r in out.items():
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        extra = (f", forces launch alone {r['forces_ms']:.4f} ms"
                 if "forces_ms" in r else "")
        if "per_k_ms" in r:
            extra += ", per k: " + ", ".join(
                f"k={kk} {ms:.4f} ms" for kk, ms in r["per_k_ms"].items())
        if "device_ms" in r:
            extra += f", device alone {r['device_ms']:.4f} ms"
        if "per_tile_device_ms" in r:
            extra += ", device per tile: " + ", ".join(
                f"{t} {ms:.4f} ms"
                for t, ms in r["per_tile_device_ms"].items())
        if "scan_hist_melem_s" in r:
            extra += (f", scan_hist_melem_s {r['scan_hist_melem_s']:.1f}, "
                      f"passes' bytes {r['pass_bytes_ms']:.6g} ms")
        log(f"time {label}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {lib} ms, bound "
            f"{r['bound_ms']:.6g} ms ({r['bound_by']}), launches/call "
            f"{r['launches_per_call']}{extra}")
    return out


def scan_times(torch, gen, peaks):
    """Phase 5 for scan, histogram and scan_histogram (fuse off and on),
    int32 in [0, 256) with 256 bins, at 2^22 (the configuration of
    record; in L2) and 2^26 (streams device memory)."""
    from tpukernels_torch.kernels import histogram as H, scan as SC
    from tpukernels_torch.kernels import scan_histogram as SH

    _, bw, _, fp32 = peaks
    # Hopper issues int32 adds and compares on 64 of each SM's 128 lanes
    int32 = fp32 / 2
    nb = SCAN_NBINS
    out = {}
    for n, reps, calls in ((SCAN_N, 200, 20), (STREAM_N, 20, 4)):
        x = torch.randint(0, nb, (n,), device="cuda", generator=gen,
                          dtype=torch.int32)
        xw = torch.randint(0, WIDE_NBINS, (n,), device="cuda", generator=gen,
                           dtype=torch.int32)
        plain_reps = max(reps // 10, 2)
        rows = {
            # (wrapper, plain version, one library call, launches per
            # call, bytes the function moves, int32 ops, knobs)
            "scan": (lambda: SC.inclusive_scan(x), lambda: SC.scan_plain(x),
                     lambda: torch.cumsum(x, 0, dtype=torch.int32), 1,
                     8 * n, n, {}),
            "histogram": (lambda: H.histogram(x, nb),
                          lambda: H.histogram_plain(x, nb),
                          lambda: torch.bincount(x, minlength=nb), 1,
                          4 * n + 4 * nb, 2 * n, {}),
            f"histogram[{WIDE_NBINS}]": (
                lambda: H.histogram(xw, WIDE_NBINS),
                lambda: H.histogram_plain(xw, WIDE_NBINS),
                lambda: torch.bincount(xw, minlength=WIDE_NBINS), 1,
                4 * n + 4 * WIDE_NBINS, 2 * n, {}),
        }
        for fuse, launches in (("off", 2), ("on", 1)):
            rows[f"scan_histogram[{fuse}]"] = (
                lambda: SH.scan_histogram(x, nb),
                lambda: SH.scan_histogram_plain(x, nb),
                lambda: (torch.cumsum(x, 0, dtype=torch.int32),
                         torch.bincount(x, minlength=nb)),
                launches, 8 * n + 4 * nb, 3 * n,
                {"TPKT_SCANHIST_FUSE": fuse})
        for name, (fn, plain, lib, launches, nbytes, ops, env) in rows.items():
            with knobs(**env):
                row = {
                    "n": n,
                    "nbins": (WIDE_NBINS if name == f"histogram[{WIDE_NBINS}]"
                              else nb),
                    "ms": time_ms(fn, reps),
                    "device_ms": graph_ms(fn, calls),
                    "plain_ms": time_ms(plain, plain_reps),
                    "library_ms": time_ms(lib, reps),
                    "launches_per_call": launches,
                }
                if name in ("scan", "scan_histogram[on]"):
                    # device time at every tile size the kernel takes
                    row["per_tile_device_ms"] = {}
                    for tile in SC.TILES:
                        with knobs(TPKT_SCAN_TILE=tile):
                            row["per_tile_device_ms"][tile] = graph_ms(
                                fn, calls)
            row["bound_ms"], row["bound_by"] = bound(nbytes, ops, int32, bw)
            if name.startswith("scan_histogram"):
                # the reference's metric (bench.py), and what the path's
                # passes move: 12 B/elem unfused, 8 fused
                row["scan_hist_melem_s"] = n / row["ms"] / 1e3
                row["pass_bytes_ms"] = (4 * n * (launches + 1) + 4 * nb) / bw \
                    * 1e3
            out[f"{name} n={n}"] = row
        del x, xw
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import tpukernels_torch  # noqa: F401  (fails outside the repository)
    from tpukernels_torch.kernels import TPU_KERNELS

    card = phase_toolchain(torch)
    peaks = peaks_for(torch.cuda.get_device_name(0))
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    errs = phase_kernels(torch, gen)
    launches = phase_main_path(torch, gen)
    times = phase_times(torch, gen, peaks)

    # B3/B4, B5/B6 and B9/B10 share an entry: the dict keeps B4, B6 and
    # B10, and B3, B5 and B10 stand in also_replaces
    rows = {r.port_entry: r for r in TPU_KERNELS if r.status == "ported"}
    sg, jc, sx = rows["tpkt_sgemm"], rows["tpkt_jacobi2d_pass"], \
        rows["tpkt_saxpy"]
    j3, nb = rows["tpkt_jacobi3d_pass"], rows["tpkt_nbody_forces"]
    by_id = {r.id: r for r in TPU_KERNELS}
    b3, b5 = by_id["B3"], by_id["B5"]

    def entry(name, row, t, err, **extra):
        keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
        return {"name": name, "route": "cuda", "source": row.port_source,
                "replaces": row.where, "launches": launches[name],
                "max_abs_err": err, **{k: t[k] for k in keys}, **extra}

    kernels = [
        entry("saxpy", sx, times[f"saxpy n={1 << 20}"],
              errs["saxpy"][1 << 20], n=1 << 20,
              stream={k: times[f"saxpy n={1 << 26}"][k] for k in
                      ("n", "ms", "plain_ms", "library_ms", "bound_ms",
                       "bound_by")}),
    ]
    for prec, name in (("high", "sgemm_split3"), ("float32", "sgemm_float32"),
                       ("default", "sgemm_bf16")):
        kernels.append(entry(name, sg, times[f"sgemm[{prec}]"],
                             errs[f"sgemm_{prec}"], precision=prec,
                             shape=[1024, 1024, 1024]))
    def canary(label):  # the small kernel's shape, timed
        return {k: times[label][k] for k in ("shape", "iters", "ms",
                                            "plain_ms", "bound_ms",
                                            "bound_by")}

    kernels.append(entry("jacobi2d", jc, times["jacobi2d"], errs["jacobi2d"],
                         also_replaces=b3.where, shape=[4096, 4096],
                         iters=1000, canary=canary("jacobi2d canary")))
    t3 = times["jacobi3d"]
    kernels.append(entry("jacobi3d", j3, t3, errs["jacobi3d"],
                         also_replaces=b5.where, shape=t3["shape"],
                         iters=t3["iters"], k=t3["k"],
                         per_k_ms=t3["per_k_ms"],
                         canary=canary("jacobi3d canary")))
    tn = times["nbody"]
    kernels.append(entry("nbody_forces", nb, tn, errs["nbody_forces"],
                         n=tn["n"], steps=tn["steps"],
                         forces_ms=tn["forces_ms"]))

    def at(label, *keys):  # one timed row, its keys picked
        keys = keys or ("n", "ms", "plain_ms", "library_ms", "bound_ms",
                        "bound_by")
        return {k: times[label][k] for k in keys}

    big, rec = f"n={STREAM_N}", f"n={SCAN_N}"
    one = ("n", "ms", "device_ms", "plain_ms", "library_ms", "bound_ms",
           "bound_by")
    sh = one + ("pass_bytes_ms", "scan_hist_melem_s", "launches_per_call")
    t = times[f"scan {rec}"]
    kernels.append(entry("scan", by_id["B8"], t, errs["scan"], n=SCAN_N,
                         dtype="int32", device_ms=t["device_ms"],
                         per_tile_device_ms=t["per_tile_device_ms"],
                         stream=at(f"scan {big}", *one,
                                   "per_tile_device_ms")))
    t = times[f"histogram {rec}"]
    kernels.append(entry("histogram", by_id["B9"], t, errs["histogram"],
                         also_replaces=by_id["B10"].where, n=SCAN_N,
                         nbins=SCAN_NBINS, device_ms=t["device_ms"],
                         stream=at(f"histogram {big}", *one),
                         wide=[at(f"histogram[{WIDE_NBINS}] {size}", "nbins",
                                  *one) for size in (rec, big)]))
    t = times[f"scan_histogram[on] {rec}"]
    kernels.append(entry(
        "scan_histogram", by_id["B11"], t, errs["scan_histogram"], n=SCAN_N,
        nbins=SCAN_NBINS, fuse="on",
        **{k: t[k] for k in ("scan_hist_melem_s", "device_ms",
                             "per_tile_device_ms")},
        stream=at(f"scan_histogram[on] {big}", *sh, "per_tile_device_ms"),
        off=[at(f"scan_histogram[off] {size}", *sh) for size in (rec, big)]))
    log(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
