#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``tpukernels_torch``) on one GPU.

    python3 chip_smoke.py [--seed N]

Builds the port's CUDA kernels from ``tpukernels_torch/csrc`` (into
``tpukernels_torch/_build/``), then:

1. prints the card (``nvidia-smi`` name and power limit) and toolchain,
   and turns TF32 off for float32 matmuls;
2. builds every kernel, in parallel, and prints the build times, the
   registers and spills ptxas reports (the 2-D and 3-D Jacobi and
   N-body must not spill), the count of the SGEMM kernels' tensor-core, TMA and
   mbarrier instructions in their SASS (both SGEMM libraries must show
   wgmma and TMA and no mma.sync), and for each N-body instantiation
   (r i-bodies a thread, s groups a block) its registers, its SASS mix
   (FFMA, FADD, FMUL, MUFU, LDS) and its pair loop's issue slots a pair;
3. holds each kernel against its plain PyTorch version on the card at
   the sizes of the main path and at ragged ones, with the tolerance
   stated beside each check: the depth-1 SGEMM at every tile it builds,
   the pipelined SGEMM (depth 2/3, both grid orders, two tiles) also
   bitwise against itself at depth 2 order ij and against the depth-1
   SGEMM, SGEMM's operand preparation and the 2-D and 3-D Jacobi
   (ragged, narrow, all-boundary and unaligned grids too; the 3-D at
   every fusion depth k and every ring depth) bitwise against their
   plain versions, the scan family also call after call on one scratch
   buffer, across a growing buffer and on two streams, N-body at ragged
   sizes, in every (r, s) instantiation, and twice bit for bit;
4. drives the main path end to end — ``registry.dispatch`` of
   ``vector_add``, ``sgemm``, ``stencil2d``, ``stencil3d``, ``nbody``,
   ``scan``, ``scan_exclusive``, ``histogram`` and ``scan_histogram``
   (fuse off, then on) at the configurations of record and at the
   canary configurations, and SGEMM's tuned path: depth 2 from the env,
   then depth 3 / order ji from a tuning-cache entry, then the cache
   off — checks each result against the port's oracle (N-body at 65 536
   bodies against its chunked plain version; the int32 keys bitwise),
   shows which kernel each SGEMM call launched and where its knobs came
   from, and shows from the launch counters that every kernel ran;
5. times each kernel, its plain version and, where one exists, the
   single PyTorch call computing the same function, with CUDA events,
   beside the least time the card could take (``bound_ms``); for SAXPY,
   SGEMM, scan and histogram also the device time alone (``device_ms``:
   calls captured in a CUDA graph and replayed) and the graph's nodes a
   call, the scan's tile sizes, SAXPY's and SGEMM's host path step by
   step, for SGEMM every depth, order and depth-1 tile at 1024^3, each
   depth at 4096^3, each with the device time of its kernel alone and of
   its operand preparation, at depth 3 also with and without a wgmma
   group in flight, ``float32`` SGEMM's share of its contract's bound
   (six bf16 products: the run fails at half), for the scan at 2^26
   its resident blocks a SM and its time on capped grids and without its
   look-back, for the 2-D and 3-D Jacobi every fusion depth k and
   the HBM floor of their passes (``pass_bytes_ms``), for the 3-D also
   every ring depth, the halo's redundancy at each k and each
   instantiation's registers, and for N-body
   its forces launch alone, every (r, s, bi, bj) of a sweep, the SM
   clock under load and the issue floor it gives (``issue_floor_ms``).

It prints one JSON line of per-kernel results before the last line,
and as the last line ``{"ok": true, "device": {...}}``. Any failed
check raises: the script then exits non-zero and prints no result. It
needs a CUDA device and the repository's ``tpukernels_torch`` package;
it imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
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
# (m, k, n): ragged edges in every dimension, k % 8 != 0 in the last
GEMM_RAGGED = ((100, 300, 200), (40, 56, 72), (33, 300, 130), (64, 129, 96))
GEMM_MODES = {"high": "split3", "float32": "float32", "default": "bf16"}
# the default tile (128 x 64), and one from the other sweep values
GEMM_TILES = (("tile default", {}),
              ("tile 64x128", {"TPKT_SGEMM_BM": 64, "TPKT_SGEMM_BN": 128}))
NBODY_N = 1 << 16  # the configuration of record: dt 1e-3, eps 1e-2, 1 step
STENCIL3D_N, STENCIL3D_ITERS = 384, 8
# c/nbody.c's golden checker's bar (N-body against its plain version;
# rsqrtf and the sum order differ)
NBODY_BAND = (2e-3, 2e-4)
# N-body sizes either side of a warp, a tile and a block, and one past
# the configuration of record
NBODY_RAGGED = (1, 2, 31, 33, 257, 4097, NBODY_N + 1)
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

    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=warmed_stream(fn)):
        for _ in range(calls):
            fn()
    ms = time_ms(graph.replay, reps) / calls
    del graph
    return ms


def warmed_stream(fn):
    """A side stream on which ``fn`` has run once: the call builds and
    loads its kernels, warms the allocator and makes the wrappers'
    per-stream scratch buffers outside a capture on that stream."""
    import torch

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.synchronize()
    return stream


_CUDART = []


def cudart():
    """The CUDA runtime library PyTorch runs on, for the one call this
    script makes itself (``cudaGraphGetNodes``)."""
    import torch

    if not _CUDART:
        major = (torch.version.cuda or "12").split(".")[0]
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        names = (f"libcudart.so.{major}", "libcudart.so",
                 os.path.join(home, "lib64", "libcudart.so"))
        for name in names:
            try:
                _CUDART.append(ctypes.CDLL(name))
                break
            except OSError:
                continue
        else:
            raise RuntimeError(f"no CUDA runtime library among {names}")
    return _CUDART[0]


def graph_nodes(fn, calls=4):
    """Nodes a call of ``fn`` leaves in a CUDA graph: every kernel
    launch, fill and copy it issues on the device is one node. ``calls``
    calls are captured and the graph's nodes counted."""
    import torch

    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=warmed_stream(fn)):
        for _ in range(calls):
            fn()
    count = ctypes.c_size_t(0)
    rc = cudart().cudaGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()),
                                    None, ctypes.byref(count))
    del graph
    if rc != 0:
        raise RuntimeError(f"cudaGraphGetNodes failed with error {rc}")
    if count.value % calls:
        raise AssertionError(f"{count.value} graph nodes for {calls} calls")
    return count.value // calls


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
        if not logf.exists():
            continue
        text = logf.read_text()
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
        stores = sum(map(int, re.findall(r"(\d+) bytes spill stores", text)))
        loads = sum(map(int, re.findall(r"(\d+) bytes spill loads", text)))
        log(f"ptxas {name}: {len(regs)} kernels, registers "
            f"{min(regs, default=0)}..{max(regs, default=0)} a thread, "
            f"spill stores {stores} B, spill loads {loads} B, "
            f"{len(re.findall('serializ', text))} wgmma serialisation "
            "warnings")
        # the Jacobi wavefronts keep every level in registers, N-body its
        # i-bodies and sums
        if name in ("jacobi2d", "jacobi3d", "nbody") and (stores or loads):
            raise AssertionError(f"ptxas spills in {name}: the registers "
                                 "the design keeps its state in overflowed")
    # what the SGEMM kernels were compiled to: HGMMA is wgmma, UTMALDG a
    # TMA tile load, SYNCS the mbarrier operations, HMMA mma.sync
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    for name in ("sgemm", "sgemm_pipelined"):
        sass = run([cuobjdump, "-sass", str(_build.library_path(name))])
        if not sass:
            raise RuntimeError(f"cuobjdump gave no SASS for {name}")
        ops = re.findall(
            r"^\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)", sass,
            re.M)
        counts = {op: ops.count(op) for op in ("HGMMA", "UTMALDG", "SYNCS",
                                               "HMMA", "FFMA")}
        log(f"sass {name}: {json.dumps(counts)} instructions")
        if not (counts["HGMMA"] > 0 and counts["UTMALDG"] > 0
                and counts["HMMA"] == 0):
            raise AssertionError(f"{name} is not on TMA + wgmma: {counts}")
    return nbody_build(cuobjdump)


def jacobi3d_registers():
    """``{sweeps: (registers, spill bytes)}`` of each ``jacobi3d.cu``
    instantiation, from its ptxas report."""
    from tpukernels_torch import _build

    out = {}
    log_ = _build.library_path("jacobi3d").with_suffix(".log").read_text()
    for chunk in log_.split("Compiling entry function")[1:]:
        s = re.search(r"jacobi3d_kernelILi(\d+)E", chunk)
        regs = re.search(r"Used (\d+) registers", chunk)
        if s and regs:
            out[int(s[1])] = (int(regs[1]), sum(map(int, re.findall(
                r"(\d+) bytes spill (?:stores|loads)", chunk))))
    return dict(sorted(out.items()))


def stencil3d_redundancy(J, n, k):
    """Cells a pass of ``k`` sweeps loads and sweeps over the cells of an
    n^3 grid: the windows in x and y and the segments' extra planes in z
    (``plan3d`` on device 0's SMs)."""
    p = J.plan3d(n, n, n, k, J.sm_count(0))
    wx, wy = J.window3d(k)
    return p.nx * wx * p.ny * wy * p.nz * (p.seg + 2 * k) / n ** 3


NBODY_MIX = ("FFMA", "FADD", "FMUL", "MUFU", "LDS")


def nbody_build(cuobjdump):
    """Each ``nbody.cu`` instantiation, keyed ``(r, s)``: its registers
    and spill bytes (ptxas's report), the count of each of
    :data:`NBODY_MIX` in its SASS, and its pair loop: the backward
    branch's body with the most MUFU instructions an instruction (the
    unrolled loop over a tile), its instructions and mix a pair (one
    MUFU.RSQ a pair) — the issue slots a pair."""
    from tpukernels_torch import _build

    lib = _build.library_path("nbody")
    out = {}
    for chunk in lib.with_suffix(".log").read_text().split(
            "Compiling entry function")[1:]:
        rs = re.search(r"nbody_forces_kernelILi(\d+)ELi(\d+)E", chunk)
        regs = re.search(r"Used (\d+) registers", chunk)
        if not (rs and regs):
            raise AssertionError(f"no ptxas report of an nbody kernel in "
                                 f"{chunk[:200]!r}")
        spill = sum(map(int, re.findall(r"(\d+) bytes spill (?:stores|loads)",
                                        chunk)))
        out[(int(rs[1]), int(rs[2]))] = {"registers": int(regs[1]),
                                         "spill_bytes": spill}
    sass = run([cuobjdump, "-sass", str(lib)])
    if not sass:
        raise RuntimeError("cuobjdump gave no SASS for nbody")
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        rs = re.match(r"\S*nbody_forces_kernelILi(\d+)ELi(\d+)E", fn)
        if rs:
            out[(int(rs[1]), int(rs[2]))].update(pair_loop(fn))
    missing = [k for k, v in out.items() if "slots_per_pair" not in v]
    if missing or not out:
        raise AssertionError(f"no pair loop found in the SASS of {missing}")
    for (r, s_), v in sorted(out.items()):
        log(f"nbody r={r} s={s_}: {v['registers']} registers, spill "
            f"{v['spill_bytes']} B, SASS {json.dumps(v['mix'])}, pair loop "
            f"{v['loop_instructions']} instructions for {v['loop_pairs']} "
            f"pairs: {v['slots_per_pair']:.3f} issue slots a pair "
            f"{json.dumps(v['mix_per_pair'])}")
    return out


_SASS_LINE = re.compile(
    r"^\s+/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)([^;]*);", re.M)


def pair_loop(fn_sass):
    """The mix of one SASS function and of its pair loop (see
    :func:`nbody_build`). A branch target is an address (``BRA 0x230``)
    or a label (``BRA `(.L_x_3)``, the label on a line of its own before
    the instruction it names)."""
    insts, labels, pending = [], {}, []
    for line in fn_sass.splitlines():
        lab = re.match(r"^\s*(\.L_x_\d+):", line)
        if lab:
            pending.append(lab[1])
            continue
        m = _SASS_LINE.match(line)
        if not m:
            continue
        addr = int(m[1], 16)
        for name in pending:
            labels[name] = addr
        pending = []
        insts.append((addr, m[2], m[3]))
    mix = {op: sum(1 for _, o, _ in insts if o == op) for op in NBODY_MIX}
    best = None
    for addr, op, rest in insts:
        if op != "BRA":
            continue
        hexa = re.search(r"0x([0-9a-f]+)", rest)
        lab = re.search(r"\((\.L_x_\d+)\)", rest)
        target = int(hexa[1], 16) if hexa else labels.get(lab[1]) if lab \
            else None
        if target is None or target > addr:
            continue
        body = [o for a, o, _ in insts if target <= a <= addr and o != "NOP"]
        pairs = body.count("MUFU")
        if pairs and (best is None or pairs / len(body) >
                      best[0].count("MUFU") / len(best[0])):
            best = (body, pairs)
    if best is None:
        return {"mix": mix}
    body, pairs = best
    return {"mix": mix, "loop_instructions": len(body), "loop_pairs": pairs,
            "slots_per_pair": len(body) / pairs,
            "mix_per_pair": {op: body.count(op) / pairs for op in NBODY_MIX}}


def phase_kernels(torch, gen):
    """Each kernel against its plain version; returns max_abs_err at the
    main-path sizes."""
    log("== phase 3: kernels against their plain versions")
    from tpukernels_torch.kernels import sgemm as S, stencil as J
    from tpukernels_torch.kernels import vector_add as V

    dev = torch.device("cuda")

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    def unif(*shape):  # the C golden checker's [-1, 1) operands
        return torch.rand(*shape, device=dev, generator=gen) * 2 - 1

    errs = {}
    for n in (1, 3, 1000, 1 << 20, (1 << 20) + 3, 1 << 26):
        x, y = randn(n), randn(n)
        e = check(f"saxpy n={n}", V.saxpy(SAXPY_ALPHA, x, y),
                  V.saxpy_reference(SAXPY_ALPHA, x, y), 1e-5, 1e-6)
        errs.setdefault("saxpy", {})[n] = e
        del x, y
    x, y = randn(1001), randn(1001)  # offset views: the unaligned path
    check("saxpy n=1000 unaligned", V.saxpy(SAXPY_ALPHA, x[1:], y[1:]),
          V.saxpy_reference(SAXPY_ALPHA, x[1:], y[1:]), 1e-5, 1e-6)
    errs.update(sgemm_kernels(torch, gen))

    # 2-D Jacobi bitwise: the canary, the remainder pass, ragged widths
    # and heights, grids narrower than a warp's strip, all-boundary grids
    for (h, w), iters, k in (((40, 200), 4, None), ((1024, 1536), 13, 1),
                              ((1024, 1536), 13, 8), ((1023, 1537), 13, 3),
                              ((1023, 1537), 13, 8), ((5, 4099), 9, 8),
                              ((4099, 5), 9, 8), ((2, 2), 5, 8),
                              ((1, 300), 5, 8),
                              ((4096, 4096), 1000, None)):
        x = randn(h, w)
        e = check_exact(
            f"jacobi2d {h}x{w} iters={iters} k={k or 'default'}",
            J.jacobi2d(x, iters, k=k), J.jacobi2d_plain(x, iters))
        if (h, w) == (4096, 4096):
            errs["jacobi2d"] = e
    # a storage offset of one float: rows start off 16-byte alignment
    x = randn(777 * 1032 + 1)[1:].view(777, 1032)
    check_exact("jacobi2d 777x1032 iters=10 k=8 unaligned",
                J.jacobi2d(x, 10, k=8), J.jacobi2d_plain(x, 10))

    # 3-D Jacobi bitwise: the canary, every k at a ragged shape (and
    # remainder passes), every ring depth at the size of record, thin and
    # ragged grids, all-boundary grids
    n3 = STENCIL3D_N
    cases = [((8, 24, 132), 2, None, None),
             *[((33, 70, 130), 9, k, None) for k in range(1, 9)],
             ((33, 70, 130), 16, 8, None), ((2, 70, 130), 9, None, None),
             ((33, 1, 130), 9, None, None), ((33, 70, 1), 9, 8, None),
             ((5, 389, 1031), 9, None, None), ((5, 389, 1031), 8, 8, None),
             ((2, 2, 2), 5, 8, None), ((1, 300, 300), 3, 8, None),
             *[((n3, n3, n3), STENCIL3D_ITERS, None, depth)
               for depth in range(1, J.RING_MAX + 1)],
             ((n3, n3, n3), STENCIL3D_ITERS, 8, None)]
    for shape, iters, k, depth in cases:
        x = randn(*shape)
        e = check_exact(
            f"jacobi3d {'x'.join(map(str, shape))} iters={iters} "
            f"k={k or 'default'} depth={depth or 'default'}",
            J.jacobi3d(x, iters, k=k, depth=depth), J.jacobi3d_plain(x, iters))
        if shape[0] == n3:
            errs["jacobi3d"] = e
        del x
    # a storage offset of one float: rows start off 16-byte alignment
    x = randn(33 * 70 * 132 + 1)[1:].view(33, 70, 132)
    check_exact("jacobi3d 33x70x132 iters=9 k=4 unaligned",
                J.jacobi3d(x, 9, k=4), J.jacobi3d_plain(x, 9))

    errs["nbody_forces"] = nbody_checks(torch, gen)
    errs.update(sgemm_pipelined_kernels(torch, gen))
    errs.update(sgemm_prep_checks(torch, gen))
    errs.update(scan_kernels(torch, gen))
    return errs


def nbody_checks(torch, gen):
    """Phase 3 for N-body: the wrapper at the main path's size and at
    ragged ones against the chunked plain version (and the pairwise
    oracle where it fits), every (r, s) instantiation at the main path's
    size, a second call bit for bit, and eps = 0 giving NaN; returns
    max_abs_err at the main path's size."""
    from tpukernels_torch.kernels import nbody as NB

    for n, steps in ((192, 1), (1000, 2), (4096, 1), (NBODY_N, 1),
                     *((n, 1) for n in NBODY_RAGGED)):
        b = bodies(gen, n)
        got = stacked(NB.nbody_step(*b, steps=steps))
        want = stacked(NB.nbody_plain(*b, steps=steps))
        e = check(f"nbody n={n} steps={steps} vs chunked plain", got, want,
                  *NBODY_BAND)
        if n <= 4096:  # the pairwise oracle makes (n, n) temporaries
            check(f"nbody n={n} steps={steps} vs oracle", got,
                  stacked(NB.nbody_reference(*b, steps=steps)), 1e-3, 1e-3)
        if n == NBODY_N:
            err = e
            nbody_instantiations(torch, NB, b, want)
            again = stacked(NB.nbody_step(*b, steps=steps))
            check_exact(f"nbody n={n}: a second call", again, got)
        del b, got, want
    b = bodies(gen, 192)
    for label, out in (("kernel", NB.nbody_step(*b, eps=0.0)),
                       ("plain", NB.nbody_plain(*b, eps=0.0))):
        if not bool(stacked(out).isnan().all()):
            raise AssertionError(f"nbody {label} eps=0: self-pairs did not "
                                 "give NaN everywhere")
    log("PASS nbody eps=0: every output NaN in kernel and plain version "
        "(self-pairs 0*inf), as the reference")
    return err


def nbody_bi(r, s):
    """The default i-bodies a block, cut so that a block of ``s``
    groups of ``r`` i-bodies a thread stays within the most threads a
    block: every instantiation then runs as built."""
    from tpukernels_torch.kernels import nbody as NB

    return min(NB._tiles()[0], NB.MAX_THREADS // s * r)


def nbody_instantiations(torch, NB, b, want):
    """Every (r, s) instantiation of ``nbody.cu`` at the size of ``b``,
    one step through the wrapper's integration, against ``want`` (the
    plain version's step)."""
    import functools

    n = b[0].numel()
    for r, s in NB.RS_BUILT:
        plan = NB.plan_forces(n, nbody_bi(r, s), NB._tiles()[1], r, s)
        if (plan.r, plan.s) != (r, s):
            raise AssertionError(f"nbody: the plan for r={r} s={s} runs "
                                 f"{plan}")
        got = NB._advance(functools.partial(NB._forces_cuda, plan=plan),
                          tuple(b), 1e-3, 1e-2, 1)
        check(f"nbody n={n} r={r} s={s} bi={plan.bi} vs chunked plain",
              stacked(got), want, *NBODY_BAND)


def sgemm_kernels(torch, gen):
    """Phase 3 for the depth-1 SGEMM (B1, TMA + wgmma): at every
    precision and every tile it builds, at 1024^3, the ragged shapes and
    two more, within ``sgemm.contract`` of the plain version and the
    oracle; two calls bitwise equal; beta = 0 with NaN in C gives NaN."""
    from tpukernels_torch.kernels import sgemm as S

    dev = torch.device("cuda")

    def unif(*shape):  # the C golden checker's [-1, 1) operands
        return torch.rand(*shape, device=dev, generator=gen) * 2 - 1

    bms, bns, _ = S.tiles(1)
    errs = {}
    for m, k, n in ((1024, 1024, 1024), (1000, 1042, 2176), (40, 72, 56),
                    *GEMM_RAGGED):
        a, b, c = unif(m, k), unif(k, n), unif(m, n)
        ref = S.sgemm_reference(GEMM_ALPHA, a, b, GEMM_BETA, c)
        for prec in S.PRECISIONS:
            rtol, atol = S.contract(prec, k, GEMM_ALPHA)
            plain = S.sgemm_plain(GEMM_ALPHA, a, b, GEMM_BETA, c, prec)
            for bm in bms:
                for bn in bns:
                    label = f"sgemm[{prec}] {m}x{k}x{n} bm={bm} bn={bn}"
                    with knobs(TPKT_SGEMM_BM=bm, TPKT_SGEMM_BN=bn):
                        got = S.sgemm(GEMM_ALPHA, a, b, GEMM_BETA, c,
                                      precision=prec)
                    check(f"{label} vs plain", got, plain, rtol, atol)
                    check(f"{label} vs oracle", got, ref, rtol, atol)
            got = S.sgemm(GEMM_ALPHA, a, b, GEMM_BETA, c, precision=prec)
            check_exact(f"sgemm[{prec}] {m}x{k}x{n} default tile, two calls",
                        S.sgemm(GEMM_ALPHA, a, b, GEMM_BETA, c,
                                precision=prec), got)
            if (m, k, n) == (1024, 1024, 1024):
                errs[f"sgemm_{prec}"] = check(
                    f"sgemm[{prec}] 1024^3 default tile vs plain", got,
                    plain, rtol, atol)
        del a, b, c, ref
    a, b = unif(128, 128), unif(128, 128)
    c = torch.full((128, 128), float("nan"), device=dev)
    for prec in S.PRECISIONS:
        got = S.sgemm(1.0, a, b, 0.0, c, precision=prec)
        if not bool(got.isnan().all()):
            raise AssertionError(f"sgemm[{prec}] beta=0: NaN in C did not "
                                 "propagate")
        log(f"PASS sgemm[{prec}] beta=0 with NaN in C: all NaN, as the "
            "oracle")
    return errs


def sgemm_pipelined_kernels(torch, gen):
    """Phase 3 for the pipelined SGEMM (B2): at every precision, depth 2
    and 3 and order ij and ji, bitwise against depth 2 order ij and
    against the depth-1 SGEMM (B1) at the same tile, mode and order
    (one accumulator an output, summed in the same order whatever the
    stage count), and within ``sgemm.contract`` of the plain version and
    the oracle; at 1024^3 and the ragged shapes, at the default tile and
    at 64 x 128."""
    from tpukernels_torch.kernels import sgemm as S

    dev = torch.device("cuda")

    def unif(*shape):
        return torch.rand(*shape, device=dev, generator=gen) * 2 - 1

    errs = {}
    for m, k, n in ((1024, 1024, 1024),) + GEMM_RAGGED:
        a, b, c = unif(m, k), unif(k, n), unif(m, n)
        ref = S.sgemm_reference(GEMM_ALPHA, a, b, GEMM_BETA, c)
        for prec in S.PRECISIONS:
            rtol, atol = S.contract(prec, k, GEMM_ALPHA)
            plain = S.sgemm_plain(GEMM_ALPHA, a, b, GEMM_BETA, c, prec)
            for tname, tile in GEMM_TILES:
                with knobs(TPKT_SGEMM_DEPTH=2, TPKT_SGEMM_ORDER="ij", **tile):
                    base = S.sgemm(GEMM_ALPHA, a, b, GEMM_BETA, c,
                                   precision=prec)
                for order in ("ij", "ji"):
                    with knobs(TPKT_SGEMM_DEPTH=1, TPKT_SGEMM_ORDER=order,
                               **tile):
                        b1 = S.sgemm(GEMM_ALPHA, a, b, GEMM_BETA, c,
                                     precision=prec)
                    for depth in (2, 3):
                        with knobs(TPKT_SGEMM_DEPTH=depth,
                                   TPKT_SGEMM_ORDER=order, **tile):
                            got = S.sgemm(GEMM_ALPHA, a, b, GEMM_BETA, c,
                                          precision=prec)
                        label = (f"sgemm_pipelined[{prec}] {m}x{k}x{n} "
                                 f"depth={depth} order={order} {tname}")
                        check_exact(f"{label} vs depth 2 order ij", got, base)
                        check_exact(f"{label} vs depth 1 (B1) order {order}",
                                    got, b1)
                        e = check(f"{label} vs plain", got, plain, rtol,
                                  atol)
                        check(f"{label} vs oracle", got, ref, rtol, atol)
                        if ((m, k, n, depth, order) == (1024, 1024, 1024, 2,
                                                        "ij") and not tile):
                            errs[f"sgemm_pipelined_{prec}"] = e
        del a, b, c, ref
    a, b = unif(128, 128), unif(128, 128)
    c = torch.full((128, 128), float("nan"), device=dev)
    for prec in S.PRECISIONS:
        for depth in (2, 3):
            with knobs(TPKT_SGEMM_DEPTH=depth):
                got = S.sgemm(1.0, a, b, 0.0, c, precision=prec)
            if not bool(got.isnan().all()):
                raise AssertionError(f"sgemm_pipelined[{prec}] depth={depth} "
                                     "beta=0: NaN in C did not propagate")
            log(f"PASS sgemm_pipelined[{prec}] depth={depth} beta=0 with NaN "
                "in C: all NaN, as the oracle")
    return errs


def sgemm_prep_checks(torch, gen):
    """Phase 3 for SGEMM's operand preparation (``tpkt_sgemm_prep``):
    every operand it writes bitwise equal to ``operands_plain``'s, zero
    pads included, in all three modes; one launch a call. Shapes: the
    main path's, the ragged ones (k % 8 != 0, m and n odd), and A or B
    given as views that are not contiguous."""
    from tpukernels_torch.kernels import LAUNCHES
    from tpukernels_torch.kernels import sgemm as S

    dev = torch.device("cuda")

    def unif(*shape):
        return torch.rand(*shape, device=dev, generator=gen) * 2 - 1

    def bits(t):  # compared bit for bit
        return t.contiguous().view(torch.uint8)

    views = {
        "contiguous": lambda m, k, n: (unif(m, k), unif(k, n)),
        "A transposed view": lambda m, k, n: (unif(k, m).t(), unif(k, n)),
        "A every other column": lambda m, k, n: (unif(m, 2 * k)[:, ::2],
                                                 unif(k, n)),
        "B transposed view": lambda m, k, n: (unif(m, k), unif(n, k).t()),
        "B offset by one element": lambda m, k, n: (
            unif(m, k), unif(k * n + 1)[1:].view(k, n)),
    }
    shapes = ((1024, 1024, 1024), (1000, 1042, 2176), (1, 1, 1),
              *GEMM_RAGGED)
    for m, k, n in shapes:
        for vname, make in views.items():
            if vname != "contiguous" and m == 1024:
                continue
            a, b = make(m, k, n)
            for prec in S.PRECISIONS:
                before = LAUNCHES["sgemm_prep"]
                ops, kp = S.operands(a, b, prec)
                launched = LAUNCHES["sgemm_prep"] - before
                want, want_kp = S.operands_plain(a, b, prec)
                label = f"sgemm_prep[{prec}] {m}x{k}x{n} {vname}"
                if launched != 1 or kp != want_kp:
                    raise AssertionError(f"{label}: {launched} launches, "
                                         f"k {kp} != {want_kp}")
                for i, (g, w) in enumerate(zip(ops, want)):
                    if (g is None) != (w is None):
                        raise AssertionError(f"{label}: operand {i} "
                                             "present on one side only")
                    if g is None:
                        continue
                    if (g.shape, g.dtype) != (w.shape, w.dtype) or not (
                            g.is_contiguous() and g.data_ptr() % 16 == 0):
                        raise AssertionError(
                            f"{label}: operand {i} {tuple(g.shape)} "
                            f"{g.dtype} against {tuple(w.shape)} {w.dtype}")
                    check_exact(f"{label} operand {i}", bits(g), bits(w))
    return {"sgemm_prep": 0.0}


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
    scan_scratch_checks(torch, ints)

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


def scan_scratch_checks(torch, ints):
    """The scan family's scratch buffer, which every launch must leave
    zeroed: 50 calls in a row on one buffer, a long scan after a short
    one and the reverse (the buffer grows; nothing stale leaks), the
    histogram and the fused pass call after call, and two streams at
    once, each on its own buffer. int32 and counts bitwise."""
    from tpukernels_torch.kernels import histogram as H, scan as SC
    from tpukernels_torch.kernels import scan_histogram as SH

    x = ints(SCAN_N, -1000, 1000)
    want = SC.inclusive_scan_reference(x)
    bad = sum(not torch.equal(SC.inclusive_scan(x), want) for _ in range(50))
    if bad:
        raise AssertionError(f"scan n={SCAN_N}: {bad} of 50 calls in a row "
                             "differ from the oracle")
    log(f"PASS scan int32 n={SCAN_N}: 50 calls in a row on one scratch "
        "buffer, each bitwise the oracle")
    for n in (5000, STREAM_N, 4093, SCAN_N, STREAM_N + 12345, 7):
        xs = ints(n, -1000, 1000)
        check_exact(f"scan int32 n={n} after another length vs oracle",
                    SC.inclusive_scan(xs), SC.inclusive_scan_reference(xs))
        del xs
    small = SC.TILES[0]  # the most status words a length needs
    with knobs(TPKT_SCAN_TILE=small):
        xs = ints(STREAM_N, -1000, 1000)
        for i in range(2):
            check_exact(f"scan int32 n={STREAM_N} tile={small} call {i} vs "
                        "oracle", SC.inclusive_scan(xs),
                        SC.inclusive_scan_reference(xs))
        del xs
    xh = ints(SCAN_N, -8, SCAN_NBINS + 8)
    hwant = H.histogram_plain(xh, SCAN_NBINS)
    swant = SC.inclusive_scan_reference(xh)
    for i in range(10):
        for fuse in ("off", "on"):
            with knobs(TPKT_SCANHIST_FUSE=fuse):
                s, h = SH.scan_histogram(xh, SCAN_NBINS)
            if not (torch.equal(s, swant) and torch.equal(h, hwant)):
                raise AssertionError(f"scan_histogram[{fuse}] call {i} in a "
                                     "row differs from the plain versions")
    log(f"PASS scan_histogram n={SCAN_N}: 10 calls in a row, fuse off and "
        "on, each bitwise the plain versions")
    # two streams at once: each has a scratch buffer of its own
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    xs = [ints(1 << 24, -1000, 1000), ints((1 << 24) + 77, 0, SCAN_NBINS)]
    wants = [SC.inclusive_scan_reference(t) for t in xs]
    hwant = H.histogram_plain(xs[1], SCAN_NBINS)
    torch.cuda.synchronize()
    got = [[], []]
    for _ in range(10):
        with torch.cuda.stream(streams[0]):
            got[0].append(SC.inclusive_scan(xs[0]))
        with torch.cuda.stream(streams[1]), knobs(TPKT_SCANHIST_FUSE="on"):
            got[1].append(SH.scan_histogram(xs[1], SCAN_NBINS))
    torch.cuda.synchronize()
    ok = all(torch.equal(g, wants[0]) for g in got[0]) and all(
        torch.equal(s, wants[1]) and torch.equal(h, hwant)
        for s, h in got[1])
    bufs = [SC._SCRATCH.get(("scan", xs[0].get_device(), st.cuda_stream))
            for st in streams]
    if not ok or None in bufs or bufs[0].data_ptr() == bufs[1].data_ptr():
        raise AssertionError("scan on two streams at once: results differ "
                             f"from the oracle ({ok}) or the streams do not "
                             "have a scratch buffer each")
    log("PASS scan and scan_histogram[on] n=2^24 on two streams at once, 10 "
        "calls each: bitwise, one scratch buffer a stream")


def phase_main_path(torch, gen):
    log("== phase 4: main path end to end (registry.dispatch)")
    from tpukernels_torch import interop, registry
    from tpukernels_torch.kernels import LAUNCHES, reset_launches
    from tpukernels_torch.kernels import nbody as NB, sgemm as S
    from tpukernels_torch.resilience import integrity
    from tpukernels_torch.tuning import cache

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
    # the tuned path (B2): depth 2 from the env in every precision; then,
    # env clear, depth 3 / order ji from a tuning-cache entry for this
    # card; then the same entry with the cache off, which is B1 again
    tuned = tempfile.mkdtemp(prefix="tpkt_tuning_")
    with knobs(TPKT_TUNING_CACHE_DIR=tuned):
        cache.put(S.TUNABLES, {"depth": 3, "order": "ji"},
                  shape=(1024, 1024, 1024), dtype="float32", device=dev)
    for prec in S.PRECISIONS:
        record.append(("sgemm", f"1024^3 precision={prec} depth=2 (env)",
                       gemm, {"precision": prec},
                       S.contract(prec, 1024, GEMM_ALPHA), None,
                       {"TPKT_SGEMM_DEPTH": 2}))
    record.append(("sgemm", "1024^3 depth=3 order=ji (tuning cache)", gemm,
                   {}, None, None, {"TPKT_TUNING_CACHE_DIR": tuned}))
    record.append(("sgemm", "1024^3 tuning cache off", gemm, {}, None, None,
                   {"TPKT_TUNING_CACHE_DIR": tuned, "TPKT_TUNING_CACHE": 0}))
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

    deltas = []  # per call: the launch counters it moved

    def run(name, args, st, env):
        before = dict(LAUNCHES)
        with knobs(**env):
            out = registry.dispatch(name, *args, **st)
        deltas.append({k: v - before[k] for k, v in LAUNCHES.items()
                       if v != before[k]})
        return out

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

    # which kernel each SGEMM call of the tuned path launched, and where
    # each of its knobs came from
    for (name, label, _, st, _, _, env), moved in zip(record, deltas):
        if name != "sgemm":
            continue
        with knobs(**env):
            src = registry.knob_sources("sgemm", (1024, 1024, 1024),
                                        "float32", dev)
        log(f"sgemm {label}: launched {json.dumps(moved)}, knobs from "
            f"{json.dumps(src)}")
        mode = GEMM_MODES[st.get("precision", "high")]
        b1 = {"sgemm_prep": 1, f"sgemm_{mode}": 1}
        b2 = {"sgemm_prep": 1, f"sgemm_pipelined_{mode}": 1}
        default = {k: "default" for k in src}
        if "TPKT_SGEMM_DEPTH" in env:
            want = (b2, dict(default, depth="env"))
        elif "TPKT_TUNING_CACHE" in env or not env:  # the cache off, or none
            want = (b1, default)
        else:
            want = (b2, dict(default, depth="cache", order="cache"))
        if (moved, src) != want:
            raise AssertionError(f"sgemm {label}: launched {moved} with knobs "
                                 f"from {src}; expected {want}")
        log(f"PASS sgemm {label}: the expected kernel, knobs as expected")
    shutil.rmtree(tuned)
    log("tuning cache: " + json.dumps(cache.COUNTS))
    log(f"host cost of a knob lookup: {lookup_us(cache, S):.2f} us a "
        f"resolve of sgemm's knobs, {lookup_us(cache, S, stat=True):.2f} "
        "us a stat of the cache's path")
    log("kernels: " + json.dumps(launches))
    log("dispatch calls: " + json.dumps(calls))
    idle = [k for k, v in launches.items() if v <= 0]
    if idle:
        raise AssertionError(f"kernels not launched on the main path: {idle}")
    return launches


def lookup_us(cache, S, stat=False, calls=2000):
    """Microseconds a wrapper's knob lookup costs on this host: a resolve
    of SGEMM's knobs (cache file absent), or one ``os.stat`` of the
    cache's path, which a lookup without the memo would pay."""
    from tpukernels_torch.tuning import resolve

    path = cache.path()
    t0 = time.perf_counter()
    for _ in range(calls):
        if stat:
            try:
                os.stat(path)
            except OSError:
                pass
        else:
            resolve(S.TUNABLES, (1024, 1024, 1024), "float32", "cuda")
    return (time.perf_counter() - t0) / calls * 1e6


def host_us(fn, calls=1000, batch=100):
    """Host microseconds per call of ``fn``: batches of ``batch`` calls
    on the host's clock, the device drained between batches (outside
    the clock), so a queue of launches never fills and blocks."""
    import torch

    fn()
    total = 0.0
    for _ in range(calls // batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(batch):
            fn()
        total += time.perf_counter() - t0
    torch.cuda.synchronize()
    return total / (calls // batch * batch) * 1e6


def saxpy_host_us(torch, V, x, y):
    """SAXPY's host path at ``x.numel()``, step by step: µs per call of
    each piece a wrapper call may pay, the bare ctypes launch, the whole
    wrapper and ``torch.add`` beside it."""
    from tpukernels_torch import _build
    from tpukernels_torch.tuning import resolve

    n, dev = x.numel(), x.device
    out = torch.empty_like(x)
    threads, blocks = V.launch_plan(n, dev)
    fn = _build.function("saxpy", "tpkt_saxpy", V._ARGTYPES)
    stream = _build.stream_of(x)

    def context():
        with torch.cuda.device(dev):
            pass

    steps = {
        "resolve": lambda: resolve(V.TUNABLES, (n,), "float32", dev),
        "get_device_properties":
            lambda: torch.cuda.get_device_properties(dev),
        "device_context": context,
        "current_stream": lambda: torch.cuda.current_stream(dev),
        "empty_like": lambda: torch.empty_like(x),
        "ctypes_launch": lambda: fn(x.data_ptr(), y.data_ptr(),
                                    out.data_ptr(), n, SAXPY_ALPHA, blocks,
                                    threads, stream),
        "launch_plan": lambda: V.launch_plan(n, dev),
        "wrapper": lambda: V.saxpy(SAXPY_ALPHA, x, y),
        "torch_add": lambda: torch.add(y, x, alpha=SAXPY_ALPHA),
    }
    return {name: host_us(f) for name, f in steps.items()}


def saxpy_few_blocks_ms(torch, V, x, y, per_sm=8):
    """Device ms of the SAXPY kernel on a grid of ``per_sm`` blocks a SM
    walking the work in its grid-stride loop, to set beside the grid
    that covers the work, which the wrapper picks."""
    from tpukernels_torch import _build

    n, out = x.numel(), torch.empty_like(x)
    threads, blocks = V.launch_plan(n, x.device)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    fn = _build.function("saxpy", "tpkt_saxpy", V._ARGTYPES)
    return graph_ms(lambda: _build.launch(
        fn, x, x.data_ptr(), y.data_ptr(), out.data_ptr(), n, SAXPY_ALPHA,
        min(blocks, per_sm * sms), threads), 4)


def sgemm_host_us(torch, S, a, b, c, prec):
    """SGEMM's host path under the knobs set now, step by step: µs per
    call of the memoised plan, the operand preparation (``_prepare``:
    one allocation and one launch; ``operands`` adds the views) and what
    it replaced (``operands_plain``: PyTorch ops), the output's
    allocation, the bare launch on prepared operands, the whole wrapper,
    and ``torch.addmm`` beside it."""
    from tpukernels_torch.tuning import plan_memo

    m, n = c.shape
    k = a.shape[1]
    ops, kp = S.operands(a, b, prec)
    out = torch.empty_like(c)
    p = S.plan(m, n, k, prec, a.device)
    steps = {
        "plan_memo": lambda: plan_memo(S.TUNABLES,
                                       (m, n, k, prec, a.device.index),
                                       S.plan, m, n, k, prec, a.device),
        "prepare": lambda: S._prepare(a, b, prec),
        "operands": lambda: S.operands(a, b, prec),
        "operands_plain": lambda: S.operands_plain(a, b, prec),
        "empty": lambda: torch.empty((m, n), dtype=torch.float32,
                                     device=a.device),
        "launch": lambda: S.launch(GEMM_ALPHA, ops, kp, GEMM_BETA, c, out,
                                   prec, p),
        "wrapper": lambda: S.sgemm(GEMM_ALPHA, a, b, GEMM_BETA, c,
                                   precision=prec),
        "torch_addmm": lambda: torch.addmm(c, a, b, beta=GEMM_BETA,
                                           alpha=GEMM_ALPHA),
    }
    return {name: host_us(f, calls=500) for name, f in steps.items()}


def scan_host_us(torch, SC, H, SH, x, nbins):
    """The scan family's host path at ``x.numel()``, step by step: µs per
    call of the pieces a scan call pays (the input's checks, the
    memoised tile, the output's allocation, the scratch lookup, the bare
    ctypes launch), the whole wrappers, and the library calls beside
    them."""
    from tpukernels_torch import _build

    n = x.numel()
    out = torch.empty_like(x)
    tile = SC.tile_plan(x)
    fn = _build.function("scan", "tpkt_scan", SC._ARGTYPES)
    where = _build.device_stream(x)
    _, state = SC.scan_state(n, tile, x)

    def fused(fuse):
        with knobs(TPKT_SCANHIST_FUSE=fuse):
            return host_us(lambda: SH.scan_histogram(x, nbins))

    steps = {
        "flat": lambda: SC._flat(x),
        "tile_plan": lambda: SC.tile_plan(x),
        "empty_like": lambda: torch.empty_like(x),
        "device_stream": lambda: _build.device_stream(x),
        "scan_state": lambda: SC.scan_state(n, tile, x, 0, where),
        "ctypes_launch": lambda: fn(x.data_ptr(), out.data_ptr(),
                                    state.data_ptr(), n,
                                    tile // SC.TILES[0], 0, where[1]),
        "scan": lambda: SC.inclusive_scan(x),
        "torch_cumsum": lambda: torch.cumsum(x, 0, dtype=torch.int32),
        "histogram": lambda: H.histogram(x, nbins),
        "scan_histogram_plan": lambda: SH.launch_plan(x, nbins),
    }
    us = {name: host_us(f) for name, f in steps.items()}
    us["scan_histogram_off"], us["scan_histogram_on"] = fused("off"), \
        fused("on")
    return us


def phase_times(torch, gen, peaks, nbody):
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

    for n, reps, calls in ((1 << 20, 200, 20), (1 << 26, 20, 4)):
        x, y = randn(n), randn(n)
        row = {
            "n": n,
            "ms": time_ms(lambda: V.saxpy(SAXPY_ALPHA, x, y), reps),
            "device_ms": graph_ms(lambda: V.saxpy(SAXPY_ALPHA, x, y), calls),
            "plain_ms": time_ms(
                lambda: V.saxpy_reference(SAXPY_ALPHA, x, y), reps),
            "library_ms": time_ms(
                lambda: torch.add(y, x, alpha=SAXPY_ALPHA), reps),
            "library_device_ms": graph_ms(
                lambda: torch.add(y, x, alpha=SAXPY_ALPHA), calls),
            "launches_per_call": 1,
        }
        row["bound_ms"], row["bound_by"] = bound(12 * n, 2 * n, fp32, bw)
        if n == 1 << 20:
            row["host_us"] = saxpy_host_us(torch, V, x, y)
        else:  # the grid the wrapper picks against 8 blocks a SM looping
            row["few_blocks_device_ms"] = saxpy_few_blocks_ms(torch, V, x, y)
        out[f"saxpy n={n}"] = row
        del x, y

    m = k = n = 1024
    a, b, c = (torch.rand(*s, device=dev, generator=gen) * 2 - 1
               for s in ((m, k), (k, n), (m, n)))
    lib = time_ms(lambda: torch.addmm(c, a, b, beta=GEMM_BETA,
                                      alpha=GEMM_ALPHA), 20)
    for prec, work, rate in (("high", 3 * 2 * m * n * k, bf16),
                             ("float32", 6 * 2 * m * n * k, bf16),
                             ("default", 2 * m * n * k, bf16)):
        row = {
            "shape": [m, k, n],
            "ms": time_ms(lambda: S.sgemm(GEMM_ALPHA, a, b, GEMM_BETA, c,
                                          precision=prec), 20),
            "plain_ms": time_ms(lambda: S.sgemm_plain(
                GEMM_ALPHA, a, b, GEMM_BETA, c, prec), 20),
            "device_ms": graph_ms(lambda: S.sgemm(
                GEMM_ALPHA, a, b, GEMM_BETA, c, precision=prec), 20),
            "library_ms": lib,
            "library_device_ms": graph_ms(lambda: torch.addmm(
                c, a, b, beta=GEMM_BETA, alpha=GEMM_ALPHA), 20),
            "launches_per_call": graph_nodes(lambda: S.sgemm(
                GEMM_ALPHA, a, b, GEMM_BETA, c, precision=prec)),
            "knobs": S.plan(m, n, k, prec, dev),
        }
        row["split_ms"], row["kernel_ms"] = sgemm_parts(torch, S, a, b, c,
                                                        prec, 20)
        if prec == "high":
            row["host_us"] = sgemm_host_us(torch, S, a, b, c, prec)
        row["bound_ms"], row["bound_by"] = bound(
            4 * (m * k + k * n + 2 * m * n), work, rate, bw)
        out[f"sgemm[{prec}]"] = row
    out.update(sgemm_times(torch, gen, peaks))
    out.update(sgemm_prep_times(torch, gen, peaks))
    out["sgemm[float32]"]["contract_share"] = float32_by_six_bf16(torch, gen)

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
    # every fusion depth the kernel takes: the default is the fastest
    row["per_k_ms"] = {k2: time_ms(lambda: J.jacobi2d(x, iters, k=k2), 3,
                                   warmup=1)
                       for k2 in range(1, J.HALO_MAX + 1)}
    out["jacobi2d"] = row

    canary("jacobi2d canary", J.jacobi2d, J.jacobi2d_plain, (40, 200), 4,
           kk, 5)

    n3, iters = STENCIL3D_N, STENCIL3D_ITERS
    x = randn(n3, n3, n3)
    k3 = J.resolve_k(None, 3)
    row = {
        "shape": [n3] * 3, "iters": iters, "k": k3,
        "depth": J.resolve_depth(),
        "ms": time_ms(lambda: J.jacobi3d(x, iters), 10),
        "plain_ms": time_ms(lambda: J.jacobi3d_plain(x, iters), 2, warmup=1),
        "library_ms": None,
        "launches_per_call": len(J.passes(iters, k3)),
    }
    row["bound_ms"], row["bound_by"] = bound(
        8 * n3 ** 3, 6 * (n3 - 2) ** 3 * iters, fp32, bw)
    row["pass_bytes_ms"] = 8 * n3 ** 3 * row["launches_per_call"] / bw * 1e3
    # every fusion depth and ring depth the kernel takes: the defaults
    # are the fastest
    row["per_k_ms"] = {kk3: time_ms(lambda: J.jacobi3d(x, iters, k=kk3), 10)
                       for kk3 in range(1, J.HALO3D_MAX + 1)}
    row["per_depth_ms"] = {
        dd: time_ms(lambda: J.jacobi3d(x, iters, depth=dd), 10)
        for dd in range(1, J.RING_MAX + 1)}
    row["halo_redundancy"] = {kk3: stencil3d_redundancy(J, n3, kk3)
                              for kk3 in range(1, J.HALO3D_MAX + 1)}
    row["registers"] = jacobi3d_registers()
    out["jacobi3d"] = row
    del x
    canary("jacobi3d canary", J.jacobi3d, J.jacobi3d_plain, (8, 24, 132), 2,
           k3, 6)

    out["nbody"] = nbody_times(torch, NB, gen, peaks, nbody)
    out.update(scan_times(torch, gen, peaks))

    for label, r in out.items():
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        extra = ""
        if "forces_ms" in r:
            extra += (f", forces launch alone {r['forces_ms']:.4f} ms (r="
                      f"{r['r']} s={r['s']}, {r['threads']} threads a "
                      f"block), issue floor {r['issue_floor_ms']:.4f} ms at "
                      f"{r['issue_slots_per_pair']:.3f} slots a pair and "
                      f"{r['sm_clock_mhz']} MHz (most {r['max_sm_clock_mhz']}"
                      "), registers " + json.dumps(r["registers"])
                      + ", per (r, s, bi, bj): " + ", ".join(
                          f"{k} {ms:.4f} ms"
                          for k, ms in r["per_config_ms"].items()))
        if "per_k_ms" in r:
            extra += ", per k: " + ", ".join(
                f"k={kk} {ms:.4f} ms" for kk, ms in r["per_k_ms"].items())
        if "per_depth_ms" in r:
            extra += ", per depth: " + ", ".join(
                f"depth={dd} {ms:.4f} ms"
                for dd, ms in r["per_depth_ms"].items())
            extra += ", halo redundancy " + ", ".join(
                f"k={kk} {v:.3f}" for kk, v in r["halo_redundancy"].items())
            extra += ", (registers, spill bytes) " + json.dumps(
                r["registers"])
        if "knobs" in r:
            extra += f", knobs {json.dumps(r['knobs'])}"
        if "blocks" in r:
            extra += f", {r['blocks']} blocks"
        if "device_ms" in r:
            extra += f", device alone {r['device_ms']:.4f} ms"
        if "kernel_ms" in r:
            extra += (f", operands {r['split_ms']:.4f} ms + kernel "
                      f"{r['kernel_ms']:.4f} ms on the device")
        if "in_flight_kernel_ms" in r:
            extra += (", kernel with every wgmma group waited for "
                      f"{r['in_flight_kernel_ms']['0']:.4f} ms, one in "
                      f"flight {r['in_flight_kernel_ms']['1']:.4f} ms")
        if r.get("library_device_ms") is not None:
            extra += f", library device {r['library_device_ms']:.4f} ms"
        if "few_blocks_device_ms" in r:
            extra += (", 8 blocks a SM looping "
                      f"{r['few_blocks_device_ms']:.4f} ms on the device")
        if "host_us" in r:
            extra += ", host us a call: " + ", ".join(
                f"{k} {v:.2f}" for k, v in r["host_us"].items())
        if "per_tile_device_ms" in r:
            extra += ", device per tile: " + ", ".join(
                f"{t} {ms:.4f} ms"
                for t, ms in r["per_tile_device_ms"].items())
        if "plain_device_ms" in r:
            extra += (f", plain on the device {r['plain_device_ms']:.4f} ms "
                      f"in {r['plain_launches_per_call']} launches")
        if "probe" in r:
            extra += f", probe {json.dumps(r['probe'])}"
        if "scan_hist_melem_s" in r:
            extra += (f", scan_hist_melem_s {r['scan_hist_melem_s']:.1f}, "
                      f"passes' bytes {r['pass_bytes_ms']:.6g} ms")
        elif "pass_bytes_ms" in r:
            extra += f", passes' bytes {r['pass_bytes_ms']:.6g} ms"
        log(f"time {label}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {lib} ms, bound "
            f"{r['bound_ms']:.6g} ms ({r['bound_by']}), launches/call "
            f"{r['launches_per_call']}{extra}")
    return out


# the N-body sweep: i-bodies a thread, groups a block, i-bodies a
# block, j-bodies a tile (a block's)
NBODY_SWEEP = {"r": (2, 4), "s": (1, 2, 4, 8), "bi": (128, 256, 512),
               "bj": (512, 1024, 2048)}


def sm_clock_mhz(torch, fn, calls=600, samples=3):
    """(SM clock, most SM clock) in MHz as ``nvidia-smi`` reports them
    while ``calls`` calls of ``fn`` run on the card: the median of
    ``samples`` readings."""
    for _ in range(calls):
        fn()
    reads = []
    for _ in range(samples):
        line = run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                    "--format=csv,noheader,nounits"])
        if not line:
            raise RuntimeError("nvidia-smi gave no SM clock")
        reads.append([int(v) for v in line.splitlines()[0].split(",")])
    torch.cuda.synchronize()
    reads.sort()
    return tuple(reads[len(reads) // 2])


def nbody_times(torch, NB, gen, peaks, nbody):
    """N-body at the configuration of record: a call, the forces launch
    alone, the plain version, the bound; the SM clock under load and the
    issue floor it gives with the SASS's slots a pair (phase 2); every
    (r, s, bi, bj) of :data:`NBODY_SWEEP` (a plan that halves s is timed
    once, under the (r, s) it runs)."""
    _, bw, _, fp32 = peaks
    n = NBODY_N
    b = bodies(gen, n)
    bi, bj = NB._tiles()
    plan = NB.plan_forces(n, bi, bj)
    eps2 = NB._eps2(1e-2)  # the configuration of record

    def forces(p):
        return lambda: NB._forces_cuda(b[0], b[1], b[2], b[6], eps2, p)

    row = {
        "n": n, "steps": 1, "bi": bi, "bj": bj, "r": plan.r, "s": plan.s,
        "threads": plan.threads,
        "ms": time_ms(lambda: NB.nbody_step(*b), 10),
        "plain_ms": time_ms(lambda: NB.nbody_plain(*b), 1, warmup=1),
        "library_ms": None,
        "launches_per_call": 1,
        # the forces launch alone, without the six integration ops
        "forces_ms": time_ms(forces(plan), 10),
    }
    # 20 flops per pair, the reference's CostEstimate; 7 arrays in, 6 out
    row["bound_ms"], row["bound_by"] = bound(4 * 13 * n, 20 * n * n, fp32,
                                             bw)
    sweep = {}
    for r in NBODY_SWEEP["r"]:
        for s in NBODY_SWEEP["s"]:
            for bi2 in NBODY_SWEEP["bi"]:
                for bj2 in NBODY_SWEEP["bj"]:
                    p = NB.plan_forces(n, bi2, bj2, r, s)
                    key = f"r={p.r} s={p.s} bi={bi2} bj={bj2}"
                    if key not in sweep:
                        sweep[key] = time_ms(forces(p), 5, warmup=1)
    row["per_config_ms"] = sweep
    row["registers"] = {f"r={r} s={s}": v["registers"]
                        for (r, s), v in sorted(nbody.items())}
    row["sass_per_pair"] = nbody[(plan.r, plan.s)]["mix_per_pair"]
    slots = nbody[(plan.r, plan.s)]["slots_per_pair"]
    clock, most = sm_clock_mhz(torch, forces(plan))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    row.update(issue_slots_per_pair=slots, sm_clock_mhz=clock,
               max_sm_clock_mhz=most, sms=sms,
               issue_floor_ms=slots * n * n / (32 * 4 * sms * clock * 1e6)
               * 1e3)
    return row


def sgemm_parts(torch, S, a, b, c, prec, calls):
    """(split_ms, kernel_ms) of one SGEMM call under the knobs set now:
    the device time of the wrapper's operand preparation alone
    (``operands``: the bf16 split, B^T or A^T, the row padding) and of
    the kernel alone on operands prepared once."""
    m, n = c.shape
    ops, kp = S.operands(a, b, prec)
    out = torch.empty_like(c)
    p = S.plan(m, n, a.shape[1], prec, a.device)
    split = graph_ms(lambda: S.operands(a, b, prec), calls)
    kernel = graph_ms(lambda: S.launch(GEMM_ALPHA, ops, kp, GEMM_BETA, c,
                                       out, prec, p), calls)
    return split, kernel


def sgemm_in_flight_probe(torch, S, a, b, c, prec, calls):
    """Device ms of the depth-3 kernel alone, under the knobs set now,
    with every wgmma group waited for (``"0"``, what depth 3 runs) and
    with one group left in flight (``"1"``, the variant that measured
    slower and that no entry runs). Through
    ``tpkt_sgemm_pipelined_probe``, an entry no wrapper calls; the two
    results must agree bitwise with depth 3's."""
    from tpukernels_torch import _build

    m, n = c.shape
    ops, kp = S.operands(a, b, prec)
    p = S.plan(m, n, a.shape[1], prec, a.device)
    if (prec, p["bm"], p["depth"]) != ("high", 128, 3):
        raise AssertionError(f"the probe is built for 'high' at depth 3 on "
                             f"128-row tiles, not {prec} {p}")
    fn = _build.function(
        "sgemm_pipelined", "tpkt_sgemm_pipelined_probe",
        (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 3 + (ctypes.c_float,) * 2
        + (ctypes.c_int,) * 3 + (ctypes.c_void_p,))
    ptrs = [t.data_ptr() for t in ops]
    want = S.sgemm(GEMM_ALPHA, a, b, GEMM_BETA, c, precision=prec)
    out = {}
    for keep in (0, 1):
        got = torch.empty_like(c)

        def run():
            rc = _build.launch(fn, got, *ptrs, c.data_ptr(), got.data_ptr(),
                               m, n, kp, GEMM_ALPHA, GEMM_BETA, p["bn"], keep,
                               int(p["order"] == "ji"))
            _build.check(rc, "tpkt_sgemm_pipelined_probe")

        run()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"tpkt_sgemm_pipelined_probe in_flight={keep} "
                                 "differs from depth 3")
        out[str(keep)] = graph_ms(run, calls)
    return out


def sgemm_times(torch, gen, peaks):
    """Phase 5 for SGEMM's tuned path: at 1024^3 every precision at depth
    1 (B1) on each tile it builds, ``high`` at depth 1/2/3 in both grid
    orders and B2 at the 64-row and the 128 x 128 tile, ``float32`` and
    ``default`` at depth 2/3; at 4096^3 ``high`` on B1's tiles and at
    depth 2/3 on the default and the 128 x 128 tile. Each beside its
    bound, the plain version and ``torch.addmm``, with the device time
    of the operand preparation and of the kernel alone and the graph
    nodes (launches) of a call."""
    from tpukernels_torch.kernels import sgemm as S

    _, bw, bf16, fp32 = peaks
    dev = torch.device("cuda")
    passes = {"high": 3, "float32": 6, "default": 1}  # bf16 products
    bm64, bn128 = {"TPKT_SGEMM_BM": 64}, {"TPKT_SGEMM_BN": 128}
    bms, bns, _ = S.tiles(1)
    b1_tiles = [{"TPKT_SGEMM_BM": bm, "TPKT_SGEMM_BN": bn}
                for bm in bms for bn in bns]
    out = {}
    for size, reps in ((1024, 50), (4096, 5)):
        m = k = n = size
        calls = 20 if size == 1024 else 2
        a, b, c = (torch.rand(*s, device=dev, generator=gen) * 2 - 1
                   for s in ((m, k), (k, n), (m, n)))
        lib = time_ms(lambda: torch.addmm(c, a, b, beta=GEMM_BETA,
                                          alpha=GEMM_ALPHA), reps)
        lib_dev = graph_ms(lambda: torch.addmm(c, a, b, beta=GEMM_BETA,
                                               alpha=GEMM_ALPHA), calls)
        precs = S.PRECISIONS if size == 1024 else ("high",)
        combos = [(p, 1, "ij", t) for p in precs for t in b1_tiles]
        combos += [("high", d, "ij", t) for d in (2, 3) for t in ({}, bn128)]
        if size == 1024:
            combos += [("high", d, "ji", {}) for d in S.DEPTHS]
            combos += [("high", d, "ij", bm64) for d in (2, 3)]
            combos += [(p, d, "ij", {}) for p in ("float32", "default")
                       for d in (2, 3)]
        plain = {}
        for prec, depth, order, tile in combos:
            if prec not in plain:
                plain[prec] = time_ms(lambda: S.sgemm_plain(
                    GEMM_ALPHA, a, b, GEMM_BETA, c, prec), reps, warmup=1)

            def call():
                return S.sgemm(GEMM_ALPHA, a, b, GEMM_BETA, c,
                               precision=prec)

            with knobs(TPKT_SGEMM_DEPTH=depth, TPKT_SGEMM_ORDER=order,
                       **tile):
                in_flight = None  # the probe is built for 128-row tiles
                if (prec == "high" and depth == 3 and order == "ij"
                        and tile is not bm64):
                    in_flight = sgemm_in_flight_probe(torch, S, a, b, c,
                                                      prec, calls)
                row = {
                    "shape": [m, k, n], "precision": prec, "depth": depth,
                    "order": order, "knobs": S.plan(m, n, k, prec, dev),
                    "ms": time_ms(call, reps), "plain_ms": plain[prec],
                    "library_ms": lib, "library_device_ms": lib_dev,
                    "launches_per_call": graph_nodes(call, 2),
                    "device_ms": graph_ms(call, calls),
                }
                row["split_ms"], row["kernel_ms"] = sgemm_parts(
                    torch, S, a, b, c, prec, calls)
            if in_flight:
                row["in_flight_kernel_ms"] = in_flight
            t = row["knobs"]
            row["blocks"] = -(-m // t["bm"]) * -(-n // t["bn"])
            row["bound_ms"], row["bound_by"] = bound(
                4 * (m * k + k * n + 2 * m * n),
                passes[prec] * 2 * m * n * k, bf16, bw)
            label = f"sgemm[{prec}] {size}^3 depth={depth} order={order}"
            if tile:  # not the default tile: B1's sweep, or a B2 variant
                row["variant"] = f"{t['bm']}x{t['bn']}"
                label += f" tile={row['variant']}"
            out[label] = row
        del a, b, c
    return out


def float32_by_six_bf16(torch, gen):
    """How close ``float32``, six bf16 tensor-core products, comes to
    its contract on this card, where the tensor cores do not keep every
    bit of a float32 accumulator. Per shape (1024^3, 4096^3, a long k
    and the ragged ones), against the oracle: the largest error of the
    kernel and its largest share of ``contract("float32")``'s bound,
    beside those of the six products taken one at a time: a3b1, a2b2,
    a1b3, a2b1, a1b2, a1b1 each summed over k by one ``default``-mode
    call (one accumulator a product) and added up through beta = 1,
    smallest first. The kernel fails the run at half the bound."""
    from tpukernels_torch.kernels import sgemm as S

    rows = {}
    for m, k, n in ((1024, 1024, 1024), (4096, 4096, 4096),
                    (512, 32768, 512), *GEMM_RAGGED):
        a, b, c = (torch.rand(*s, device="cuda", generator=gen) * 2 - 1
                   for s in ((m, k), (k, n), (m, n)))
        ref = S.sgemm_reference(GEMM_ALPHA, a, b, GEMM_BETA, c)
        rtol, atol = S.contract("float32", k, GEMM_ALPHA)
        limit = atol + rtol * ref.abs()
        pa, pb = S._pieces_bf16(a).float(), S._pieces_bf16(b).float()
        acc = torch.zeros_like(c)
        for i, j in ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0)):
            acc = S.sgemm(1.0, pa[i], pb[j], 1.0, acc, precision="default")
        apart = GEMM_ALPHA * acc + GEMM_BETA * c
        got = S.sgemm(GEMM_ALPHA, a, b, GEMM_BETA, c, precision="float32")
        r = rows[f"{m}x{k}x{n}"] = {
            "max_abs_err": max_abs_err(got, ref),
            "share_of_contract": float(((got - ref).abs() / limit).max()),
            "apart_max_abs_err": max_abs_err(apart, ref),
            "apart_share_of_contract": float(
                ((apart - ref).abs() / limit).max()),
            "atol": atol, "rtol": rtol,
        }
        del a, b, c, ref, pa, pb, acc, apart, got, limit
        log(f"float32 as six bf16 products {m}x{k}x{n}: max_abs_err "
            f"{r['max_abs_err']:.3e}, {r['share_of_contract']:.3f} of the "
            f"contract's bound (rtol {rtol:g}, atol {atol:.3g}); the six "
            f"products one call each {r['apart_max_abs_err']:.3e}, "
            f"{r['apart_share_of_contract']:.3f}")
        if r["share_of_contract"] > 0.5:
            raise AssertionError(
                f"sgemm[float32] {m}x{k}x{n}: the error takes "
                f"{r['share_of_contract']:.3f} of the contract's bound, "
                "over half")
    return rows


def sgemm_prep_times(torch, gen, peaks):
    """Phase 5 for SGEMM's operand preparation in ``high`` mode at the
    operands of 1024^3 and 4096^3: a call and the device time of
    ``operands`` (one launch), of its plain version (the PyTorch ops it
    replaced) and the bytes bound: A and B read once in float32, four
    bf16 operands written."""
    from tpukernels_torch.kernels import sgemm as S

    _, bw, _, fp32 = peaks
    out = {}
    for size, reps, calls in ((1024, 100, 20), (4096, 10, 2)):
        a, b = (torch.rand(size, size, device="cuda", generator=gen) * 2 - 1
                for _ in range(2))
        row = {
            "shape": [size, size, size], "precision": "high",
            "ms": time_ms(lambda: S.operands(a, b, "high"), reps),
            "device_ms": graph_ms(lambda: S.operands(a, b, "high"), calls),
            "plain_ms": time_ms(lambda: S.operands_plain(a, b, "high"),
                                reps),
            "plain_device_ms": graph_ms(
                lambda: S.operands_plain(a, b, "high"), calls),
            "library_ms": None,
            "launches_per_call": graph_nodes(
                lambda: S.operands(a, b, "high")),
            "plain_launches_per_call": graph_nodes(
                lambda: S.operands_plain(a, b, "high")),
        }
        # 2 x 4 B read and 4 x 2 B written an element; a convert and a
        # subtract an element
        row["bound_ms"], row["bound_by"] = bound(
            16 * size * size, 4 * size * size, fp32, bw)
        out[f"sgemm_prep {size}^2"] = row
        del a, b
    return out


def scan_times(torch, gen, peaks):
    """Phase 5 for scan, histogram and scan_histogram (fuse off and on),
    int32 in [0, 256) with 256 bins, at 2^22 (the configuration of
    record; in L2) and 2^26 (streams device memory): a call and the
    device time of the wrapper and of the library call, the nodes a call
    leaves in a CUDA graph (its launches, fills included), and at 2^26
    the scan's probe (:func:`scan_probe`)."""
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
            # call, bytes the function moves, int32 ops, knobs); a library
            # call with torch.bincount in it synchronises with the host,
            # so it cannot be captured and has no device time of its own
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
                    "library_device_ms": (graph_ms(lib, calls)
                                          if name == "scan" else None),
                    "launches_per_call": graph_nodes(fn),
                }
                if row["launches_per_call"] != launches:
                    raise AssertionError(
                        f"{name} n={n}: a call leaves "
                        f"{row['launches_per_call']} nodes in a CUDA graph, "
                        f"not its {launches} kernel launch(es)")
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
        if n == STREAM_N:
            out[f"scan n={n}"]["probe"] = scan_probe(torch, SC, x)
        else:
            out[f"scan n={n}"]["host_us"] = scan_host_us(torch, SC, H, SH,
                                                          x, nb)
        del x, xw
    return out


def scan_probe(torch, SC, x):
    """What holds the int32 scan of ``x`` (2^26, the largest tile) under
    its bytes bound: the blocks a SM the runtime reports resident, and
    the device ms with the grid capped at 1 and 2 blocks a SM, with all
    resident blocks, and with every look-back answered at once (tile 0's
    path; that output is wrong and is not read). Timing only, through
    ``tpkt_scan_probe``, an entry no wrapper calls."""
    from tpukernels_torch import _build

    n, out = x.numel(), torch.empty_like(x)
    fn = _build.function(
        "scan", "tpkt_scan_probe",
        (ctypes.c_void_p,) * 3 + (ctypes.c_longlong, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_void_p,
                                  ctypes.c_void_p))
    per_sm = ctypes.c_int(0)

    def run(cap, first_path, ask=False):
        _, state = SC.scan_state(n, SC.TILES[-1], x)
        rc = _build.launch(fn, x, x.data_ptr(), out.data_ptr(),
                           state.data_ptr(), n, cap, first_path,
                           ctypes.addressof(per_sm) if ask else None)
        _build.check(rc, "tpkt_scan_probe")

    run(0, 0, ask=True)
    torch.cuda.synchronize()
    if not torch.equal(out, SC.inclusive_scan_reference(x)):
        raise AssertionError("tpkt_scan_probe on the whole grid differs "
                             "from the oracle")
    probe = {"resident_blocks_per_sm": per_sm.value}
    for label, cap, first in (("cap_1_ms", 1, 0), ("cap_2_ms", 2, 0),
                              ("all_resident_ms", 0, 0),
                              ("no_look_back_ms", 0, 1),
                              ("no_look_back_cap_1_ms", 1, 1)):
        probe[label] = graph_ms(lambda: run(cap, first), 4)
    return probe


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
    nbody = phase_build()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    errs = phase_kernels(torch, gen)
    launches = phase_main_path(torch, gen)
    times = phase_times(torch, gen, peaks, nbody)

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

    t = times[f"saxpy n={1 << 20}"]
    kernels = [
        entry("saxpy", sx, t, errs["saxpy"][1 << 20], n=1 << 20,
              device_ms=t["device_ms"],
              library_device_ms=t["library_device_ms"], host_us=t["host_us"],
              stream={k: times[f"saxpy n={1 << 26}"][k] for k in
                      ("n", "ms", "device_ms", "plain_ms", "library_ms",
                       "library_device_ms", "few_blocks_device_ms",
                       "bound_ms", "bound_by")}),
    ]
    def picked(r, *keys):  # one timed SGEMM row, its keys picked
        keys = keys or ("ms", "device_ms", "plain_ms", "library_ms",
                        "bound_ms", "bound_by")
        return {key: r[key] for key in keys if key in r}

    # B1: the main path's call at the default tile, with its device
    # time, its operand preparation and kernel alone, and every tile
    for prec, mode in GEMM_MODES.items():
        t = times[f"sgemm[{prec}]"]
        tiles = {r["variant"]: picked(
                     r, "ms", "device_ms", "split_ms", "kernel_ms")
                 for lbl, r in times.items()
                 if lbl.startswith(f"sgemm[{prec}] 1024^3 depth=1 ")
                 and "variant" in r}
        extra = {}
        if prec == "high":
            extra["at_4096"] = [
                dict(picked(r), tile=r["variant"],
                     kernel_ms=r["kernel_ms"], split_ms=r["split_ms"])
                for lbl, r in times.items()
                if lbl.startswith("sgemm[high] 4096^3 depth=1 ")]
        for key in ("host_us", "contract_share"):
            if key in t:
                extra[key] = t[key]
        kernels.append(entry(f"sgemm_{mode}", sg, t, errs[f"sgemm_{prec}"],
                             precision=prec, shape=t["shape"],
                             knobs=t["knobs"], device_ms=t["device_ms"],
                             split_ms=t["split_ms"], kernel_ms=t["kernel_ms"],
                             library_device_ms=t["library_device_ms"],
                             launches_per_call=t["launches_per_call"],
                             per_tile=tiles, **extra))
    # B2: `high` at depth 2 order ij, the env-driven main path; the other
    # modes at their fastest depth. max_abs_err is against the plain
    # version at depth 2 order ij (phase 3 holds every depth and order)
    parts = ("ms", "device_ms", "split_ms", "kernel_ms",
             "in_flight_kernel_ms")
    for prec, mode in GEMM_MODES.items():
        rows_1024 = {lbl: r for lbl, r in times.items()
                     if lbl.startswith(f"sgemm[{prec}] 1024^3 depth=")
                     and "variant" not in r}
        t = (times["sgemm[high] 1024^3 depth=2 order=ij"] if prec == "high"
             else min((r for r in rows_1024.values() if r["depth"] > 1),
                      key=lambda r: r["ms"]))
        extra = {"per_depth_order": {f"{r['depth']}/{r['order']}":
                                     picked(r, *parts)
                                     for r in rows_1024.values()}}
        if prec == "high":
            extra["per_tile_depth"] = {
                f"{r['variant']}/{r['depth']}": picked(r, *parts)
                for lbl, r in times.items()
                if lbl.startswith("sgemm[high] 1024^3") and "variant" in r
                and r["depth"] > 1}
            extra["at_4096"] = [
                dict(picked(r, "depth", *parts, "plain_ms", "library_ms",
                            "library_device_ms", "bound_ms", "bound_by"),
                     tile=f"{r['knobs']['bm']}x{r['knobs']['bn']}")
                for lbl, r in times.items()
                if lbl.startswith("sgemm[high] 4096^3 depth=")
                and r["depth"] > 1]
        kernels.append(entry(f"sgemm_pipelined_{mode}", by_id["B2"], t,
                             errs[f"sgemm_pipelined_{prec}"], precision=prec,
                             shape=t["shape"], depth=t["depth"],
                             order=t["order"], knobs=t["knobs"],
                             device_ms=t["device_ms"],
                             split_ms=t["split_ms"], kernel_ms=t["kernel_ms"],
                             library_device_ms=t["library_device_ms"],
                             launches_per_call=t["launches_per_call"],
                             **extra))
    # the operand preparation: a helper kernel, no TPU kernel behind it
    from tpukernels_torch.kernels import HELPER_KERNELS

    t = times["sgemm_prep 1024^2"]
    big = times["sgemm_prep 4096^2"]
    prep_keys = ("ms", "device_ms", "plain_ms", "plain_device_ms",
                 "bound_ms", "bound_by", "launches_per_call",
                 "plain_launches_per_call")
    kernels.append({
        "name": "sgemm_prep", "route": "cuda",
        "source": HELPER_KERNELS["sgemm_prep"].source,
        "replaces": HELPER_KERNELS["sgemm_prep"].replaces,
        "launches": launches["sgemm_prep"],
        "max_abs_err": errs["sgemm_prep"], "shape": t["shape"],
        "precision": "high", "library_ms": None,
        **{key: t[key] for key in prep_keys},
        "at_4096": {key: big[key] for key in prep_keys}})

    def canary(label):  # the small kernel's shape, timed
        return {k: times[label][k] for k in ("shape", "iters", "ms",
                                            "plain_ms", "bound_ms",
                                            "bound_by")}

    t2 = times["jacobi2d"]
    kernels.append(entry("jacobi2d", jc, t2, errs["jacobi2d"],
                         also_replaces=b3.where, shape=t2["shape"],
                         iters=t2["iters"], k=t2["k"],
                         per_k_ms=t2["per_k_ms"],
                         canary=canary("jacobi2d canary")))
    t3 = times["jacobi3d"]
    kernels.append(entry("jacobi3d", j3, t3, errs["jacobi3d"],
                         also_replaces=b5.where,
                         **{k: t3[k] for k in (
                             "shape", "iters", "k", "depth", "per_k_ms",
                             "per_depth_ms", "registers")},
                         canary=canary("jacobi3d canary")))
    tn = times["nbody"]
    kernels.append(entry("nbody_forces", nb, tn, errs["nbody_forces"],
                         **{k: tn[k] for k in (
                             "n", "steps", "bi", "bj", "r", "s", "threads",
                             "forces_ms", "issue_floor_ms",
                             "issue_slots_per_pair", "sass_per_pair",
                             "sm_clock_mhz", "max_sm_clock_mhz", "sms",
                             "registers", "per_config_ms")}))

    def at(label, *keys):  # one timed row, its keys picked
        keys = keys or ("n", "ms", "plain_ms", "library_ms", "bound_ms",
                        "bound_by")
        return {k: times[label][k] for k in keys}

    big, rec = f"n={STREAM_N}", f"n={SCAN_N}"
    one = ("n", "ms", "device_ms", "plain_ms", "library_ms",
           "library_device_ms", "launches_per_call", "bound_ms", "bound_by")
    sh = one + ("scan_hist_melem_s",)
    t = times[f"scan {rec}"]
    kernels.append(entry("scan", by_id["B8"], t, errs["scan"], n=SCAN_N,
                         dtype="int32", device_ms=t["device_ms"],
                         library_device_ms=t["library_device_ms"],
                         launches_per_call=t["launches_per_call"],
                         host_us=t["host_us"],
                         per_tile_device_ms=t["per_tile_device_ms"],
                         stream=at(f"scan {big}", *one,
                                   "per_tile_device_ms", "probe")))
    t = times[f"histogram {rec}"]
    kernels.append(entry("histogram", by_id["B9"], t, errs["histogram"],
                         also_replaces=by_id["B10"].where, n=SCAN_N,
                         nbins=SCAN_NBINS, device_ms=t["device_ms"],
                         launches_per_call=t["launches_per_call"],
                         stream=at(f"histogram {big}", *one),
                         wide=[at(f"histogram[{WIDE_NBINS}] {size}", "nbins",
                                  *one) for size in (rec, big)]))
    t = times[f"scan_histogram[on] {rec}"]
    kernels.append(entry(
        "scan_histogram", by_id["B11"], t, errs["scan_histogram"], n=SCAN_N,
        nbins=SCAN_NBINS, fuse="on",
        **{k: t[k] for k in ("scan_hist_melem_s", "device_ms",
                             "launches_per_call", "per_tile_device_ms")},
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
