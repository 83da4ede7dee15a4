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
   sizes, in every (r, s) instantiation, and twice bit for bit, its
   single-set entry bitwise the ij entry (``tpkt_nbody_forces_ij``) with
   the i-set the j-set (with ``--parent DIR``, also bitwise the same
   entry built from DIR), and the ij entry at the distributed forms'
   shapes and ragged ones against its plain version;
4. drives the main path end to end — ``registry.dispatch`` of
   ``vector_add``, ``sgemm``, ``stencil2d``, ``stencil3d``, ``nbody``,
   ``scan``, ``scan_exclusive``, ``histogram`` and ``scan_histogram``
   (fuse off, then on) at the configurations of record and at the
   canary configurations, and SGEMM's tuned path: depth 2 from the env,
   then depth 3 / order ji from a tuning-cache entry, then the cache
   off — checks each result against the port's oracle (N-body at 65 536
   bodies against its chunked plain version; the int32 keys bitwise),
   shows which kernel each SGEMM call launched and where its knobs came
   from, and shows from the launch counters that every kernel ran (the
   integrity guard's first-trust canaries are spent before the counted
   run, so each dispatch moves only its own launches);
4b. runs the output-integrity guard of ``registry.dispatch`` on the card
   (its state and the journal in a temporary directory): the tripwire on
   NaN/inf at the first, a middle and the last element; envelopes
   recorded from the CPU oracle, then every key's canary operands and
   the configurations of record dispatched, with a first-trust canary
   for each key (tier 2 for the exact keys, tier 3 for the float ones)
   and no failure and no check error; three injected faults
   (``corrupt_output`` on sgemm, caught within one call and quarantined
   at the second, ``nan_output`` on stencil3d at tier 1,
   ``corrupt_output`` on histogram at tier 2) read back from the
   journal, then a clean deep check; the cost of the guard (the wrapper
   alone, and dispatch with the guard off, as a tripwire and full, host
   clock, in turns), each key's first-trust canary split into its
   kernel run and its CPU oracle, and the device's idle share over
   guarded dispatches (``torch.profiler``, "not measured" when it shows
   no device time);
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

6. runs the repository's unchanged C drivers (``c/``) on the port: builds
   the port's CPython shim (``csrc/tpkt_shim.c``) and the drivers into
   ``tpukernels_torch/_build/``, runs ``test_shim_abi`` and every
   single-device row of ``c/run_all.sh`` with ``--device=tpu --check``
   and ``TPU_KERNELS_SHIM`` naming the shim (each must print its own
   CHECK PASS), then each driver at its configuration of record with
   ``--check --reps=5``, and proves from each child's journal
   (``TPKT_TRACE``) that every call ran on the card through
   ``registry.dispatch`` and that both first-trust canaries fell in the
   checked call; an injected ``corrupt_output`` at site ``capi`` must fail
   the C program's own check and ``fail_capi`` the program. It prints the
   host<->card copy rates (pageable and pinned, 64 MiB) and one
   ``{"c_entry": ...}`` JSON line a configuration: the driver's
   ``time_ms`` and metric beside phase 5's wrapper ``ms``, the bytes the
   adapter copies each way and their transfer bound.

7. runs the serving daemon (``python -m tpukernels_torch.serve``) on the
   card with no knob but its state paths and ``TPKT_TRACE=1``, and drives
   it with the port's own client: the nine keys at their avatars
   (``aot.BENCH_CONFIGS``), each from a seeded generator, on the inline
   and the shm lane, bit for bit against ``registry.dispatch`` of the
   same operands in this process and against the oracle; one request
   under its avatar for SAXPY, scan and SGEMM (padded up, cut back); a
   seeded Poisson burst of 200 SAXPY / scan / SGEMM requests from two
   client threads, with per kernel the client's p50/p99, batch sizes,
   queue waits, rejections (none), the journal's spans beside phase 5's
   wrapper ms and the operand and result bytes against phase 6's copy
   rates; the daemon's launch counts (every kernel of its default path
   must launch); the first request of each bucket against the warm
   ones; a second daemon whose first scan dispatch wedges (requeued once,
   classified at site ``serve``, answered right); ``vector_add --check``
   through the port's shim with ``TPKT_SERVE_SOCKET`` (served by the
   daemon, under its pid); SIGTERM (rc 0, socket and pidfile gone,
   ``serve_stop``); and that neither daemon built a library. It prints
   one ``{"serve": ...}`` JSON line.

8. runs the distributed layer (``tpukernels_torch.parallel``): (a) one
   rank on NCCL (a group of one: NCCL takes one rank a card), the
   bandwidth sweeps 1 KiB-64 MiB (allreduce and ppermute; the n = 1
   copy rate), ``allreduce_sum`` at 2^20 floats, then each distributed
   entry at its configuration of record (2-D 4096^2 x 1000 and 3-D
   384^3 x 8 at k = 4, scan and histogram at 2^22 with 256 bins, N-body
   psum and ring at 65 536 bodies, 1 step) with the launch counters
   zeroed before and read after (every kernel of the path must launch),
   each bitwise against its single-device wrapper, 0 bytes staged
   through the host, each one's ms beside phase 5's wrapper and
   ``forces_ij``'s against its bound; (b) four rank processes on the one
   card through gloo (``dist_rank``: the same path, bitwise or within
   N-body's band, ``forces_ij`` at the psum's shape against its plain
   version, the stencils at k 1, 4, 8 and depth 1, 2 and their
   residuals, the ring's knobs, allreduce on a ring and a 2 x 2 mesh,
   bcast and ring_shift exact, every rank's launches, ms a call and the
   bytes host-staged a call); (c) the unchanged C drivers as four rank
   processes on c/run_all.sh's mesh rows and ``allreduce_bench`` at
   ``TPKT_MESH=1`` on NCCL, each printing CHECK PASS. It prints one
   ``{"dist": ...}`` JSON line.

9. runs the serving fleet: ``python -m tpukernels_torch.serve.ctl
   start-fleet 2`` on the card, its state and journal in a temporary
   directory, hedging off and the health windows compressed. (1) Both
   workers hold the card (a ``/dev/nvidia*`` descriptor; nvidia-smi's
   compute apps list them, where it sees this pid namespace) and the
   router does not; each worker's memory. (2) The nine avatars of phase 7
   through the front socket on both lanes, bitwise phase 7's daemon's
   answers, each routed to ``ring_order(bucket, 2)[0]``; the workers'
   ``launches`` (the router's ``stats``) cover the daemon's default path.
   (3) Phase 7's burst through the front: client p50/p99 beside phase
   7's, the split over the workers. (4) Worker 0 drained while two
   clients stream (no request lost, none routed to it), then undrained
   with a ``wedge_dispatch`` plan for one of its keys in its environment
   only. (5) That key wedges twice and the router spills it to worker 1
   (reason ``wedged``). (6) After the cooldown worker 0 holds it again
   and is SIGKILLed while a client streams worker 1's keys: one
   ``worker_dead``, one replay on worker 1, a respawn on the card with
   its down-time, its first dispatch against warm ones. (7) The guardian
   with a ``kill_router`` plan for the routers it spawns: the router is
   SIGKILLed, its successor kills itself at its third request after the
   WAL holds it, two clients ride through on their reconnect budget,
   one ``serve_request`` a request_id. (8) ``stop-fleet``: no member, socket,
   pidfile, fleet.json or ``tpkserve-*`` segment left; no library built.
   It prints one ``{"fleet": ...}`` JSON line; each kernel entry gains
   ``fleet_launches``.

It prints one JSON line of per-kernel results before the last line,
and as the last line ``{"ok": true, "device": {...}}``. Any failed
check raises: the script then exits non-zero and prints no result. It
needs a CUDA device and the repository's ``tpukernels_torch`` package;
it imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
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
REPO = os.path.dirname(os.path.abspath(__file__))


def run_all_rows():
    """The single-device ``run <driver> <flags>`` rows of c/run_all.sh
    (phase 6 runs each through the port's shim)."""
    rows = []
    with open(os.path.join(REPO, "c", "run_all.sh")) as f:
        for line in f:
            m = re.match(r"run (\w+) (.*?)\s*(#.*)?$", line.rstrip("\n"))
            if m and m.group(1) != "allreduce_bench":
                rows.append((m.group(1), m.group(2).split()))
    return rows


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
    """Set environment knobs (``TPKT_*``) for the body (a None value
    unsets one), then restore them."""
    old = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = str(v)
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


def phase_kernels(torch, gen, parent=None):
    """Each kernel against its plain version; returns max_abs_err at the
    main-path sizes. ``parent``: a checkout whose ``tpkt_nbody_forces``
    this one's is held bitwise against."""
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
    errs["nbody_forces_ij"] = forces_ij_checks(torch, gen, parent)
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


def ij_step(i, a):
    """One step of the reference's integration of the i-bodies ``i``
    (seven arrays) under accelerations ``a``, stacked: what c/nbody.c's
    golden checker judges, so N-body's band applies."""
    import torch

    dt = 1e-3
    v = [u + g * dt for u, g in zip(i[3:6], a)]
    return torch.stack([p + u * dt for p, u in zip(i[:3], v)] + v)


def forces_ij_checks(torch, gen, parent=None):
    """Phase 3 for ``tpkt_nbody_forces_ij``: ``tpkt_nbody_forces`` (the
    wrapper's single-set launch) bitwise the ij entry with the i-set the
    j-set, and, with ``parent``, bitwise the same entry built from that
    checkout; the ij entry at the distributed forms' shapes and ragged
    ones, one integration step against its plain version at N-body's
    band; returns max_abs_err at all bodies from all."""
    from tpukernels_torch.kernels import nbody as NB

    eps2 = NB._eps2(1e-2)
    for n in (NBODY_N, 4097, 33):
        b = bodies(gen, n)
        plan = NB.plan_forces(n, *NB._tiles())
        one = NB._forces_cuda(b[0], b[1], b[2], b[6], eps2, plan)
        check_exact(f"nbody forces n={n}: tpkt_nbody_forces vs "
                    "tpkt_nbody_forces_ij with the i-set the j-set",
                    stacked(one), stacked(NB.forces_ij(
                        b[0], b[1], b[2], b[0], b[1], b[2], b[6], eps2)))
        if parent:
            check_exact(f"nbody forces n={n}: tpkt_nbody_forces vs the same "
                        f"entry built from {parent}", stacked(one),
                        stacked(parent_forces(torch, parent, b, eps2, plan)))
    err = None
    for ni, nj in ((NBODY_N, NBODY_N), (NBODY_N, NBODY_N // 4),
                   (NBODY_N // 4, NBODY_N // 4), (1, 33), (33, 1),
                   (4097, 31), (31, 4097), (257, 2049)):
        i, j = bodies(gen, ni), bodies(gen, nj)
        args = (i[0], i[1], i[2], j[0], j[1], j[2], j[6], eps2)
        e = check(f"nbody forces_ij ni={ni} nj={nj}: a step vs its plain "
                  "version", ij_step(i, NB.forces_ij(*args)),
                  ij_step(i, NB.forces_ij_plain(*args)), *NBODY_BAND)
        err = e if err is None else err
    return err


_PARENT_FORCES = []


def parent_forces(torch, parent, b, eps2, plan):
    """``tpkt_nbody_forces`` built from ``parent``'s
    ``tpukernels_torch/csrc/nbody.cu`` (with this build's flags, into a
    temporary directory), called on the bodies ``b`` with ``plan``."""
    from tpukernels_torch import _build
    from tpukernels_torch.kernels import nbody as NB

    if not _PARENT_FORCES:
        src = os.path.join(parent, "tpukernels_torch", "csrc", "nbody.cu")
        lib = os.path.join(tempfile.mkdtemp(prefix="tpkt_parent_"),
                           "nbody.so")
        r = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", lib,
                            src], capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc {src}: rc {r.returncode}\n{r.stdout}"
                               f"{r.stderr}")
        fn = ctypes.CDLL(lib).tpkt_nbody_forces
        fn.argtypes = list(NB._ARGTYPES)
        fn.restype = ctypes.c_int
        _PARENT_FORCES.append(fn)
    n = b[0].numel()
    out = [torch.empty_like(b[0]) for _ in range(3)]
    rc = _build.launch(_PARENT_FORCES[0], b[0], b[0].data_ptr(),
                       b[1].data_ptr(), b[2].data_ptr(), b[6].data_ptr(),
                       *(a.data_ptr() for a in out), n, eps2, plan.bi,
                       plan.r, plan.s, plan.tile, plan.per)
    _build.check(rc, "the parent's tpkt_nbody_forces")
    return tuple(out)


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
    from tpukernels_torch.obs import metrics
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
    # the configurations of record (phase 4b guards them): every row but
    # SGEMM's tuned path and the fused scan + histogram
    of_record = [r for r in record
                 if not r[6] or r[6] == {"TPKT_SCANHIST_FUSE": "off"}]
    canaries = [
        (name, "canary", interop.to_port(name, integrity.build_args(name)),
         integrity.CANARY_CONFIGS[name]["statics"], None, None, {})
        for name in ("vector_add", "sgemm", "stencil2d", "stencil3d",
                     "nbody", "scan", "scan_exclusive", "histogram",
                     "scan_histogram")
    ]
    # a key's first dispatch also runs the integrity guard's first-trust
    # canary through the key's kernel: spend those here, before the
    # counts are zeroed, so that each dispatch below moves only its own
    # launches (phase 4b checks the guard itself)
    for name, _, args, st, _, _, env in canaries:
        registry.dispatch(name, *args, **st)
    torch.cuda.synchronize()

    deltas = []  # per call: the launch counters it moved

    def run(name, args, st, env):
        before = dict(LAUNCHES)
        with knobs(**env):
            out = registry.dispatch(name, *args, **st)
        deltas.append({k: v - before[k] for k, v in LAUNCHES.items()
                       if v != before[k]})
        return out

    canaries_before = metrics.counter("integrity.deep_checks")
    reset_launches()
    registry.reset_calls()
    outs = [run(name, args, st, env)
            for name, _, args, st, _, _, env in record + canaries]
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    calls = registry.calls()
    if metrics.counter("integrity.deep_checks") != canaries_before:
        raise AssertionError("the integrity guard ran a canary inside the "
                             "counted run: the launch deltas include it")

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
    # the distributed forms' entry runs on phase 8's path only
    idle = [k for k, v in launches.items()
            if v <= 0 and k != "nbody_forces_ij"]
    if idle:
        raise AssertionError(f"kernels not launched on the main path: {idle}")
    guard_clean(metrics, "phase 4")
    return launches, of_record


def guard_clean(metrics, where):
    """Fail unless the integrity guard counted no failure and no error
    of its own on a clean path."""
    bad = {k: metrics.counter(f"integrity.{k}")
           for k in ("failures", "check_errors", "rejections")}
    if any(bad.values()):
        raise AssertionError(f"{where}: the integrity guard counted {bad} "
                             "on a clean path")
    log(f"PASS {where}: integrity guard clean "
        f"({metrics.counter('integrity.checks')} checks, "
        f"{metrics.counter('integrity.deep_checks')} canaries)")


# the guard-cost turns: the wrapper alone, the wrapper with a
# synchronise after each call (what a synchronise a call costs by
# itself), then registry.dispatch with the guard off (TPKT_INTEGRITY=0),
# as a tripwire and full
GUARD_TURNS = ("wrapper", "synced", "off", "tripwire", "full", "full",
               "tripwire", "off", "synced", "wrapper")
GUARD_KNOB = {"off": "0", "tripwire": "tripwire", "full": None}
GUARD_CALLS = 64  # calls a turn: one sampled canary a full turn


def phase_guarded(torch, of_record, peaks):
    """Phase 4b: the output-integrity guard of ``registry.dispatch`` on
    the card, its clean path, three injected faults and its costs."""
    log("== phase 4b: guarded dispatch (the output-integrity guard)")
    from tpukernels_torch import interop, registry
    from tpukernels_torch.obs import metrics, trace
    from tpukernels_torch.resilience import faults, integrity, journal

    dev = torch.device("cuda")
    keys = registry.names()
    bw = peaks[1]
    jpath = journal.path()

    def events(since):
        return journal.load_events([jpath])[0][since:]

    def mark():
        return len(events(0))

    def plan(p):
        if p is None:
            os.environ.pop("TPKT_FAULT_PLAN", None)
        else:
            os.environ["TPKT_FAULT_PLAN"] = json.dumps(p)
        faults.reload_plan()

    def dispatch(row):
        name, _, args, st, _, _, env = row
        with knobs(**env):
            return registry.dispatch(name, *args, **st)

    # the tripwire on the card: NaN, +inf and -inf at the first, a middle
    # and the last element are each caught
    probe = torch.zeros(STENCIL3D_N ** 2, device=dev)
    for value in (float("nan"), float("inf"), float("-inf")):
        for pos in (0, probe.numel() // 2, probe.numel() - 1):
            bad = probe.clone()
            bad[pos] = value
            if integrity.tripwire_ok(bad) or integrity.tripwire_ok(
                    (probe, bad)):
                raise AssertionError(f"tripwire missed {value} at {pos}")
    if not integrity.tripwire_ok((probe, probe)):
        raise AssertionError("tripwire tripped on a finite result")
    log("PASS tripwire on the card: NaN, +inf, -inf caught at the first, "
        "a middle and the last element, alone and in a tuple")

    # 1. clean path: envelopes from the CPU oracle, every key's canary
    # operands, then the configurations of record
    integrity.reset()
    metrics.clear("integrity.")
    rows = integrity.record_all(echo=log)
    if len(rows) != len(keys) or any("error" in r for r in rows):
        raise AssertionError(f"envelopes not recorded: {rows}")
    since = mark()
    with knobs(TPKT_TRACE=1):
        trace.reload()
        for k in keys:
            registry.dispatch(k, *interop.to_port(
                k, integrity.build_args(k), dev),
                **integrity.CANARY_CONFIGS[k]["statics"])
    trace.reload()
    for row in of_record:
        dispatch(row)
    torch.cuda.synchronize()
    first_trust = {e["name"].rsplit("/", 1)[-1]: e["wall_s"] * 1e3
                   for e in events(since) if e["kind"] == "span"
                   and "/integrity/canary/" in e["name"]}
    for k in keys:
        tier = 2 if integrity.tolerance(k)[0] == "exact" else 3
        ran = {t: metrics.counter(f"integrity.tier{t}.{k}") for t in (2, 3)}
        if ran[tier] != 1 or ran[5 - tier] != 0 or k not in first_trust:
            raise AssertionError(f"{k}: first-trust canaries {ran}, span "
                                 f"{k in first_trust}; expected one at tier "
                                 f"{tier}")
        log(f"PASS guard first trust {k}: tier {tier}, "
            f"{first_trust[k]:.3f} ms")
    guard_clean(metrics, "phase 4b clean path")
    if metrics.counter("integrity.deep_checks") != len(keys):
        raise AssertionError("a canary beyond first trust on the clean path")

    # 2. chaos on the card: each injected fault is caught at its tier, in
    # a fresh guard state, as a process meeting a corrupt kernel has: the
    # first-trust canary catches a finite corruption within one call
    integrity.reset()
    gemm = next(r for r in of_record if r[0] == "sgemm" and not r[3])
    cube = next(r for r in of_record if r[0] == "stencil3d")
    hist = next(r for r in of_record if r[0] == "histogram")

    def caught(label, row, fault, tier, then=()):
        plan({fault: {"kernel": row[0], "site": "registry"}})
        since = mark()
        dispatch(row)
        torch.cuda.synchronize()
        got = [(e["kind"], e.get("tier")) for e in events(since)
               if e["kind"].startswith("output_integrity")]
        want = [("output_integrity_failed", tier), *then]
        if got != want:
            raise AssertionError(f"{label}: events {got}, expected {want}")
        log(f"PASS chaos {label}: {fault} caught at tier {tier}"
            + "".join(f", then {k}" for k, _ in then))

    caught("sgemm call 1", gemm, "corrupt_output", 3)
    caught("sgemm call 2", gemm, "corrupt_output", 3,
           [("output_integrity_quarantined", None)])
    if not integrity.is_quarantined("sgemm"):
        raise AssertionError("sgemm not quarantined after two failures")
    caught("stencil3d", cube, "nan_output", 1)
    caught("histogram", hist, "corrupt_output", 2)
    # the plan cleared: a quarantined key is canary-checked and clean;
    # the quarantine cleared: a fresh first-trust canary is clean
    plan(None)
    failures = metrics.counter("integrity.failures")
    deep = metrics.counter("integrity.tier3.sgemm")
    dispatch(gemm)
    os.remove(integrity.quarantine_path())
    integrity.reset()
    dispatch(gemm)
    torch.cuda.synchronize()
    if (metrics.counter("integrity.failures") != failures
            or metrics.counter("integrity.tier3.sgemm") != deep + 2
            or integrity.is_quarantined("sgemm")):
        raise AssertionError("no clean deep check after the chaos")
    if metrics.counter("integrity.check_errors"):
        raise AssertionError("the guard counted check errors in the chaos")
    log("PASS chaos cleared: sgemm canary-checked clean while quarantined "
        "and after the quarantine was cleared")

    # 3. costs: the wrapper alone, then dispatch with the guard off, as a
    # tripwire and full (sample 64), host clock around GUARD_CALLS calls
    # ending in a synchronise, in turns
    integrity.reset()
    metrics.clear("integrity.")
    costs = {}
    for row in of_record:
        name, label, args, st, _, _, env = row
        fn = registry.lookup(name)
        out = fn(*args, **st)
        leaves = out if isinstance(out, tuple) else (out,)
        trip_bytes = sum(4 * t.numel() for t in leaves
                         if t.is_floating_point())
        ms = {m: [] for m in GUARD_TURNS}
        with knobs(**env):
            for mode in GUARD_TURNS:
                if mode == "wrapper":
                    call = lambda: fn(*args, **st)  # noqa: E731
                elif mode == "synced":
                    call = lambda: (fn(*args, **st),  # noqa: E731
                                    torch.cuda.synchronize())
                else:
                    call = lambda: registry.dispatch(  # noqa: E731
                        name, *args, **st)
                with knobs(TPKT_INTEGRITY=GUARD_KNOB.get(mode)):
                    call()
                    call()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(GUARD_CALLS):
                        call()
                    torch.cuda.synchronize()
                    ms[mode].append((time.perf_counter() - t0)
                                    / GUARD_CALLS * 1e3)
        costs[f"{name} {label}"] = {
            "key": name, "turns_ms": ms,
            **{m: sum(v) / len(v) for m, v in ms.items()},
            "tripwire_bytes": trip_bytes,
            "tripwire_floor_ms": trip_bytes / bw * 1e3}
        c = costs[f"{name} {label}"]
        log(f"guard cost {name} {label}: wrapper {c['wrapper']:.4f} ms, "
            f"synchronised {c['synced']:.4f}, "
            f"dispatch off {c['off']:.4f}, tripwire {c['tripwire']:.4f}, "
            f"full {c['full']:.4f} (host clock, {GUARD_CALLS} calls a turn, "
            f"turns {json.dumps({m: [round(x, 4) for x in v] for m, v in ms.items()})}); "
            f"tripwire reads {trip_bytes} B, HBM floor "
            f"{c['tripwire_floor_ms']:.6f} ms")
    guard_clean(metrics, "phase 4b costs")
    reduction = tripwire_reduction(torch, of_record, bw)

    # each key's first-trust canary, split: the kernel run on the card
    # (warm, 5 runs), the whole check a sampled canary runs (warm, 5
    # runs: the envelope's CRC for an exact key, the oracle compare for a
    # float one) and the CPU oracle (cold: its memo dropped)
    canary = {}
    for k in keys:
        tier = 2 if integrity.tolerance(k)[0] == "exact" else 3

        def deep():
            if tier == 2:
                ran, failure = integrity.fingerprint_check(k, device=dev)
                if not ran:
                    raise AssertionError(f"{k}: no envelope for tier 2")
            else:
                failure = integrity.cross_check(k, device=dev)
            if failure:
                raise AssertionError(f"{k}: canary failed: {failure}")

        split = {}
        for part, fn in (("kernel_ms", lambda: integrity.run_canary(
                k, device=dev)), ("deep_ms", deep)):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                fn()
                torch.cuda.synchronize()
            split[part] = (time.perf_counter() - t0) / 5 * 1e3
        integrity.reset()
        t0 = time.perf_counter()
        integrity.oracle_outputs(k)
        split["oracle_ms"] = (time.perf_counter() - t0) * 1e3
        canary[k] = {"first_trust_ms": first_trust[k], **split}
        log(f"guard canary {k}: first trust {first_trust[k]:.3f} ms (the "
            f"span, at tier {tier}), kernel run on the card "
            f"{split['kernel_ms']:.3f} ms, whole check warm "
            f"{split['deep_ms']:.3f} ms, CPU oracle cold "
            f"{split['oracle_ms']:.3f} ms")
    return {"costs": costs, "canary": canary, "reduction": reduction,
            "idle": idle_share(torch, of_record, dispatch)}


def tripwire_reduction(torch, of_record, bw):
    """The tripwire's reduction alone on the device (CUDA events) for the
    two largest float results of record, beside ``isfinite().all()``,
    which writes and reads a bool tensor between its two passes."""
    from tpukernels_torch import registry

    inf = float("inf")
    out = {}
    for name in ("vector_add", "stencil3d"):
        row = max((r for r in of_record if r[0] == name),
                  key=lambda r: r[2][-1].numel())
        x = registry.lookup(name)(*row[2], **row[3])
        r = {"n": x.numel(),
             "vector_norm_inf_ms": time_ms(
                 lambda: torch.linalg.vector_norm(x, inf), 50),
             "isfinite_all_ms": time_ms(lambda: torch.isfinite(x).all(), 50),
             "floor_4n_ms": 4 * x.numel() / bw * 1e3,
             "floor_6n_ms": 6 * x.numel() / bw * 1e3}
        out[f"{name} {row[1]}"] = r
        log(f"tripwire reduction {name} {row[1]}: vector_norm(inf) "
            f"{r['vector_norm_inf_ms']:.4f} ms on the device (4 B an "
            f"element: floor {r['floor_4n_ms']:.4f}), isfinite().all() "
            f"{r['isfinite_all_ms']:.4f} (6 B: floor "
            f"{r['floor_6n_ms']:.4f}), CUDA events")
    return out


def idle_share(torch, of_record, dispatch):
    """The device's idle share over one guarded dispatch of each
    configuration of record (full guard, first trust spent), from
    ``torch.profiler``'s device time; None with the reason when the
    profiler shows no device time."""
    from torch.profiler import ProfilerActivity, profile

    for row in of_record:
        dispatch(row)
    torch.cuda.synchronize()
    walls = []  # the same window without the profiler, three times
    for _ in range(3):
        t0 = time.perf_counter()
        for row in of_record:
            dispatch(row)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e6)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for row in of_record:
                dispatch(row)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        busy_us = sum(getattr(e, "self_device_time_total",
                              getattr(e, "self_cuda_time_total", 0))
                      for e in prof.key_averages())
    except Exception as e:  # noqa: BLE001 — optional: reported, not fatal
        log(f"device idle share: not measured ({e!r})")
        return None
    if busy_us <= 0:
        log("device idle share: not measured (the profiler shows no device "
            "time)")
        return None
    share = max(0.0, 1.0 - busy_us / wall_us)
    plain = max(0.0, 1.0 - busy_us / min(walls))
    log(f"device idle share over one guarded dispatch of each "
        f"configuration of record: {share:.4f} under the profiler (device "
        f"busy {busy_us:.1f} us of {wall_us:.1f} us, torch.profiler); "
        f"{plain:.4f} against the same window unprofiled (host clock "
        f"{', '.join(f'{w:.1f}' for w in walls)} us)")
    return {"idle_share": share, "idle_share_unprofiled": plain,
            "busy_us": busy_us, "wall_us": wall_us,
            "unprofiled_wall_us": walls}


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


# phase 5's row of each configuration of record, by phase 4's label
PHASE5_ROW = {
    f"vector_add n={1 << 20}": f"saxpy n={1 << 20}",
    f"vector_add n={1 << 26}": f"saxpy n={1 << 26}",
    "sgemm 1024^3 (precision of record)": "sgemm[high]",
    "sgemm 1024^3 precision=float32": "sgemm[float32]",
    "sgemm 1024^3 precision=default": "sgemm[default]",
    "stencil2d 4096^2 iters=1000": "jacobi2d",
    f"stencil3d {STENCIL3D_N}^3 iters={STENCIL3D_ITERS}": "jacobi3d",
    f"nbody n={NBODY_N} steps=1": "nbody",
    "scan n=2^22": f"scan n={SCAN_N}",
    "histogram n=2^22 nbins=256": f"histogram n={SCAN_N}",
    "scan_histogram n=2^22 nbins=256 fuse=off":
        f"scan_histogram[off] n={SCAN_N}",
}


def guard_costs(guarded, times):
    """Each configuration of record's guarded dispatch (phase 4b) beside
    its wrapper's ``ms`` and ``device_ms`` (phase 5)."""
    for label, c in guarded["costs"].items():
        row = times.get(PHASE5_ROW.get(label, ""), {})
        ms = "—" if "ms" not in row else f"{row['ms']:.4f}"
        dev = "—" if "device_ms" not in row else f"{row['device_ms']:.4f}"
        log(f"guarded dispatch {label}: off {c['off']:.4f} ms, tripwire "
            f"{c['tripwire']:.4f}, full {c['full']:.4f}, wrapper "
            f"{c['wrapper']:.4f} (host clock); phase 5 ms {ms}, device_ms "
            f"{dev} (CUDA events); tripwire floor "
            f"{c['tripwire_floor_ms']:.6f} ms")


# ---------------------------------------------------------------- phase 6

# the C drivers at their configurations of record, each with --check and
# five timed reps: (label, driver, flags, env, phase 5's wrapper row).
# N-body takes one step (the C golden at 65 536 bodies and 10 steps is
# 4.3e10 double-precision pairs on one core); its metric is per step.
C_RECORD = (
    ("vector_add 2^20", "vector_add", ["--n=1048576"], {},
     f"saxpy n={1 << 20}"),
    ("sgemm 1024^3", "sgemm", ["--n=1024"], {}, "sgemm[high]"),
    ("sgemm 1024^3 depth 3", "sgemm", ["--n=1024"],
     {"TPKT_SGEMM_DEPTH": "3"}, "sgemm[high] 1024^3 depth=3 order=ij"),
    ("stencil 4096^2 x 1000", "stencil", ["--n=4096", "--iters=1000"], {},
     "jacobi2d"),
    ("stencil 384^3 x 8", "stencil", ["--z=384", "--n=384", "--iters=8"],
     {}, "jacobi3d"),
    ("scan_histogram 2^22", "scan_histogram", [f"--n={SCAN_N}"], {},
     f"scan_histogram[off] n={SCAN_N}"),
    ("scan_histogram 2^22 fuse on", "scan_histogram", [f"--n={SCAN_N}"],
     {"TPKT_SCANHIST_FUSE": "on"}, f"scan_histogram[on] n={SCAN_N}"),
    ("nbody 65536, 1 step", "nbody", ["--n=65536", "--iters=1"], {},
     "nbody"),
)
C_REPS = 5
_METRIC_LINE = re.compile(
    r"kernel=(\S+) device=tpu n=(\d+) time_ms=([\d.]+) metric=(\S+) "
    r"value=([\d.]+) unit=(\S+)")


def c_flags(args):
    """``{flag: int}`` of a driver's ``--name=value`` arguments."""
    return {a[2:].split("=")[0]: int(a.split("=")[1]) for a in args
            if "=" in a}


def c_key(driver, args):
    """The registry key a driver's row sends."""
    if driver == "stencil":
        return "stencil3d" if "z" in c_flags(args) else "stencil2d"
    return driver


def c_bytes(driver, args):
    """(bytes up, bytes down) the adapter copies a call: the buffers it
    uploads and the ones it writes back."""
    f = c_flags(args)
    n = f.get("n", 1 << 20)
    if driver == "vector_add":
        return 8 * n, 4 * n
    if driver == "sgemm":
        return 12 * n * n, 4 * n * n
    if driver == "stencil":
        cells = n * f.get("m", n) * f.get("z", 1)
        return 4 * cells, 4 * cells
    if driver == "scan_histogram":
        return 4 * n, 4 * n + 4 * f.get("nbins", 256)
    return 28 * n, 24 * n  # nbody: seven arrays up, six back


def transfer_rates(torch):
    """Host <-> card bytes/s of one 64 MiB copy each way, pageable (what
    the adapters copy from and to: the driver's malloc'd buffers) and
    pinned: host clock around a copy ending in a synchronise, best of
    three after one warm-up."""
    nbytes = 64 << 20
    host = torch.ones(nbytes // 4)
    pinned = torch.ones(nbytes // 4).pin_memory()
    dev = torch.empty(nbytes // 4, device="cuda")

    def rate(fn):
        fn()
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        return nbytes / best

    return {
        "pageable": {"h2d": rate(lambda: dev.copy_(host)),
                     "d2h": rate(lambda: host.copy_(dev))},
        "pinned": {"h2d": rate(lambda: dev.copy_(pinned, non_blocking=True)),
                   "d2h": rate(lambda: pinned.copy_(dev, non_blocking=True))},
    }


def journal_emit_us(state, calls=2000):
    """Host µs of one journaled span (``TPKT_TRACE`` on), what each C
    child pays per span in its timed calls."""
    from tpukernels_torch.obs import trace

    with knobs(TPKT_TRACE="1",
               TPKT_HEALTH_JOURNAL=os.path.join(state, "emit.jsonl")):
        trace.reload()
        with trace.span("warm"):
            pass
        t0 = time.perf_counter()
        for _ in range(calls):
            with trace.span("capi/probe", kernel="probe", device="cuda:0"):
                pass
        us = (time.perf_counter() - t0) / calls * 1e6
    trace.reload()
    return us


def c_child(cbin, state, name, driver, args, env_extra, shim):
    """Run one C driver through the port's shim, its journal and guard
    state in ``state/<name>``; returns (process, its journal's events)."""
    from tpukernels_torch.resilience import journal

    d = os.path.join(state, name)
    os.makedirs(d)
    env = {k: v for k, v in os.environ.items() if not k.startswith("TPKT_")}
    env.update(TPU_KERNELS_SHIM=str(shim), TPKT_TRACE="1",
               TPKT_HEALTH_JOURNAL=os.path.join(d, "journal.jsonl"),
               TPKT_INTEGRITY_DIR=os.path.join(d, "integrity"),
               TPKT_TUNING_CACHE_DIR=os.path.join(d, "tuning"), **env_extra)
    cmd = [str(cbin / driver), "--device=tpu", *args]
    p = subprocess.run(cmd, env=env, capture_output=True, text=True,
                       timeout=600, cwd=d)
    with open(os.path.join(d, "out.log"), "w") as f:
        f.write(f"$ {' '.join(cmd)}\n{p.stdout}\n--- stderr\n{p.stderr}")
    events, _ = journal.load_events([os.path.join(d, "journal.jsonl")])
    return p, events


def c_path_proof(label, key, events, calls):
    """Fail unless the journal shows ``calls`` C calls of ``key`` on the
    card, each through ``dispatch/<key>``, and every canary span before
    the second call ended (in the --check call); returns the C calls'
    span walls in ms."""
    spans = [e for e in events if e.get("kind") == "span"]
    capi = [i for i, e in enumerate(spans) if e["name"] == f"capi/{key}"]
    devs = {spans[i].get("device") for i in capi}
    if len(capi) != calls or not all(str(d).startswith("cuda")
                                     for d in devs):
        raise AssertionError(f"{label}: {len(capi)} capi/{key} spans on "
                             f"{devs}, expected {calls} on cuda")
    dispatched = sum(e["name"] == f"capi/{key}/dispatch/{key}"
                     for e in spans)
    if dispatched != calls:
        raise AssertionError(f"{label}: {dispatched} dispatch/{key} spans "
                             f"under capi/{key}, expected {calls}")
    canaries = [i for i, e in enumerate(spans)
                if "integrity/canary/" in e["name"]]
    if len(canaries) != 2 or max(canaries) > capi[1]:
        raise AssertionError(f"{label}: canary spans at {canaries}, capi "
                             f"calls at {capi}: expected the registry's and "
                             "the capi site's first trust in the first call")
    return [round(spans[i]["wall_s"] * 1e3, 4) for i in capi]


def c_buffers(driver, args):
    """The numpy buffers, C kernel name and params JSON a driver's row
    sends to ``capi.run_from_c``, from a seeded generator."""
    import numpy as np

    rng = np.random.default_rng(0)
    f = c_flags(args)
    n = f.get("n", 1 << 20)

    def unif(*shape):
        return rng.uniform(-1, 1, shape).astype(np.float32)

    if driver == "vector_add":
        bufs, p = [unif(n), unif(n)], {"alpha": 2.5}
    elif driver == "sgemm":
        bufs, p = [unif(n, n), unif(n, n), unif(n, n)], {"alpha": 2.5,
                                                         "beta": 0.5}
    elif driver == "stencil":
        shape = ((f["z"],) if "z" in f else ()) + (n, f.get("m", n))
        bufs, p = [unif(*shape)], {"iters": f["iters"]}
    elif driver == "scan_histogram":
        bufs = [rng.integers(0, 256, n).astype(np.int32),
                np.zeros(n, np.int32), np.zeros(256, np.int32)]
        p = {"nbins": 256}
    else:
        bufs = [unif(n) for _ in range(7)]
        p = {"dt": 1e-3, "eps": 1e-2, "steps": f["iters"]}
    names = {"f": "f32", "i": "i32"}
    p["buffers"] = [{"shape": list(b.shape), "dtype": names[b.dtype.kind]}
                    for b in bufs]
    return bufs, c_key(driver, args), json.dumps(p)


def c_breakdown(torch, driver, args, env, state):
    """Where a C call's time goes, measured in this process (a Python
    host, no embedding) on the same shapes: ``capi.run_from_c`` with
    tracing off and on, and its parts alone: the uploads of the
    buffers the adapter copies to the card, the copies back into the
    host buffers, and the capi site's host tripwire over them. Host
    clock, each ending in a synchronise, best of 5 after one warm-up."""
    from tpukernels_torch import capi
    from tpukernels_torch.obs import trace
    from tpukernels_torch.resilience import integrity

    bufs, key, params = c_buffers(driver, args)
    addrs = [b.ctypes.data for b in bufs]
    host = [torch.from_numpy(b) for b in bufs]
    outs = [host[i] for i in capi._OUTPUT_BUFFERS[key]]
    ins = host[:1] if driver == "scan_histogram" else host
    dev = [t.to("cuda") for t in host]

    def best_ms(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        return best * 1e3

    with knobs(TPKT_INTEGRITY_DIR=os.path.join(state, "breakdown"),
               TPKT_HEALTH_JOURNAL=os.path.join(state, "breakdown.jsonl"),
               **env):
        integrity.reset()
        row = {"run_from_c_ms": best_ms(
            lambda: capi.run_from_c(key, params, addrs))}
        with knobs(TPKT_TRACE="1"):
            trace.reload()
            row["run_from_c_traced_ms"] = best_ms(
                lambda: capi.run_from_c(key, params, addrs))
        trace.reload()
        row["upload_ms"] = best_ms(lambda: [t.to("cuda") for t in ins])
        row["download_ms"] = best_ms(
            lambda: [o.copy_(dev[i]) for o, i in
                     zip(outs, capi._OUTPUT_BUFFERS[key])])
        row["host_tripwire_ms"] = best_ms(lambda: integrity.tripwire_ok(outs))
    integrity.reset()
    return row


def phase_c_entry(torch, times):
    """Phase 6: the unchanged C drivers on the port through its shim."""
    log("== phase 6: the C entry (c/ drivers -> port shim -> "
        "registry.dispatch)")
    from tpukernels_torch import _build

    torch.cuda.empty_cache()
    t_phase = t0 = time.perf_counter()
    shim = _build.build_shim()
    cbin = _build.build_c_drivers()
    log(f"built {shim.name} and {len(_build.C_DRIVERS)} drivers into "
        f"{cbin.relative_to(_build.BUILD_DIR.parent)} in "
        f"{time.perf_counter() - t0:.1f} s")
    libs = sorted(p.name for p in _build.BUILD_DIR.glob("*.so"))
    rates = transfer_rates(torch)
    log("host<->card, 64 MiB, GB/s: " + ", ".join(
        f"{kind} {way} {r[way] / 1e9:.2f}" for kind, r in rates.items()
        for way in ("h2d", "d2h")))
    state = tempfile.mkdtemp(prefix="tpkt_c_entry_")
    try:
        emit_us = journal_emit_us(state)
        log(f"one journaled span: {emit_us:.1f} us (host)")
        # correctness: test_shim_abi and c/run_all.sh's single-device rows
        rows = [("test_shim_abi", "test_shim_abi", [])] + [
            (f"run_all {i}", d, ["--check", "--reps=1", *a])
            for i, (d, a) in enumerate(run_all_rows())]
        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            done = list(pool.map(
                lambda r: c_child(cbin, state, re.sub(r"\W+", "_", r[0]),
                                  r[1], r[2], {}, shim), rows))
        for (name, driver, args), (p, events) in zip(rows, done):
            want = ("test_shim_abi: ALL PASS" if driver == "test_shim_abi"
                    else f"kernel={driver} CHECK PASS")
            if p.returncode != 0 or want not in p.stdout:
                raise AssertionError(
                    f"{driver} {' '.join(args)}: rc {p.returncode}\n"
                    f"{p.stdout[-2000:]}\n{p.stderr[-3000:]}")
            if driver != "test_shim_abi":
                c_path_proof(f"{driver} {' '.join(args)}",
                             c_key(driver, args), events, 3)
            log(f"PASS C {' '.join([driver, *args])}: {want.split()[-1]}"
                + ("" if driver == "test_shim_abi" else
                   f" ({c_key(driver, args)} on the card, journal)"))
        # the configurations of record, one child at a time
        out = []
        for label, driver, args, env, p5 in C_RECORD:
            flags = ["--check", f"--reps={C_REPS}", *args]
            p, events = c_child(cbin, state, re.sub(r"\W+", "_", label),
                                driver, flags, env, shim)
            m = _METRIC_LINE.search(p.stdout)
            if (p.returncode != 0 or f"kernel={driver} CHECK PASS"
                    not in p.stdout or not m):
                raise AssertionError(f"C {label}: rc {p.returncode}\n"
                                     f"{p.stdout[-2000:]}\n"
                                     f"{p.stderr[-3000:]}")
            walls = c_path_proof(label, c_key(driver, args), events,
                                 2 + C_REPS)
            up, down = c_bytes(driver, args)
            wrapper = times[p5]["ms"]
            row = {
                "row": label, "cmd": [driver, "--device=tpu", *flags],
                "env": env, "key": c_key(driver, args), "check": True,
                "time_ms": float(m.group(3)), "metric": m.group(4),
                "value": float(m.group(5)), "unit": m.group(6),
                "wrapper_ms": wrapper, "wrapper_row": p5,
                "h2d_bytes": up, "d2h_bytes": down,
                "transfer_bound_ms": {
                    kind: (up / r["h2d"] + down / r["d2h"]) * 1e3
                    for kind, r in rates.items()},
                "capi_wall_ms": {"check": walls[0], "warm_up": walls[1],
                                 "reps": walls[2:]},
            }
            row["gap_ms"] = row["time_ms"] - wrapper
            row["in_process"] = c_breakdown(torch, driver, args, env, state)
            out.append(row)
            log(f"PASS C {label}: CHECK PASS; time_ms {row['time_ms']:.3f} "
                f"({row['metric']} {row['value']:.3f} {row['unit']}), "
                f"wrapper {wrapper:.4f} ms, gap {row['gap_ms']:.3f} ms; "
                f"transfer bound pageable "
                f"{row['transfer_bound_ms']['pageable']:.3f} ms, pinned "
                f"{row['transfer_bound_ms']['pinned']:.3f} ms; capi span "
                f"ms first {walls[0]}, warm-up {walls[1]}, reps {walls[2:]}; "
                "in this process (ms): " + ", ".join(
                    f"{k[:-3]} {v:.3f}" for k, v in row["in_process"].items()))
            print(json.dumps({"c_entry": row}), flush=True)
        c_chaos(cbin, state, shim)
        after = sorted(p.name for p in _build.BUILD_DIR.glob("*.so"))
        if after != libs:
            raise AssertionError(f"a C child built a library: {libs} -> "
                                 f"{after}")
        log(f"PASS C children built nothing ({len(libs)} libraries); "
            f"phase 6 wall {time.perf_counter() - t_phase:.1f} s")
        return {"rows": out, "rates": rates, "journal_span_us": emit_us}
    finally:
        shutil.rmtree(state, ignore_errors=True)


def c_chaos(cbin, state, shim):
    """The guard at site capi guards the C program's own buffers: an
    injected corruption fails the program's C check; ``fail_capi`` fails
    the program."""
    plan = {"corrupt_output": {"kernel": "sgemm", "site": "capi"}}
    p, events = c_child(cbin, state, "chaos_corrupt", "sgemm",
                        ["--check", "--reps=1", "--n=256"],
                        {"TPKT_FAULT_PLAN": json.dumps(plan)}, shim)
    failed = [e for e in events if e.get("kind") == "output_integrity_failed"
              and e.get("site") == "capi" and e.get("kernel") == "sgemm"]
    if p.returncode == 0 or "kernel=sgemm CHECK FAIL" not in p.stdout \
            or not failed:
        raise AssertionError(f"chaos corrupt_output at capi: rc "
                             f"{p.returncode}, {len(failed)} failures "
                             f"journaled\n{p.stdout[-2000:]}")
    log(f"PASS chaos C corrupt_output at capi: the C program's check failed "
        f"(rc {p.returncode}, {p.stdout.strip().splitlines()[0]}), tier "
        f"{failed[0]['tier']} journaled")
    p, events = c_child(cbin, state, "chaos_fail", "vector_add",
                        ["--check", "--reps=1", "--n=1000"],
                        {"TPKT_FAULT_PLAN":
                         json.dumps({"fail_capi": "vector_add"})}, shim)
    errors = [e for e in events if e.get("kind") == "capi_error"]
    if p.returncode == 0 or not errors:
        raise AssertionError(f"chaos fail_capi: rc {p.returncode}, "
                             f"{len(errors)} capi_error events")
    log(f"PASS chaos C fail_capi: rc {p.returncode}, capi_error journaled")


# ---------------------------------------------------------------- phase 7

# what the daemon launches at its avatars (aot.BENCH_CONFIGS) with no
# knob set: B7, B1 and its prep launch, B4, B6, B12, B8, B9
SERVE_PATH = ("saxpy", "sgemm_prep", "sgemm_split3", "jacobi2d", "jacobi3d",
              "nbody_forces", "scan", "histogram")
# the burst: about 200 requests at SERVE_RATE a second, Poisson, from
# two client threads, over three kernels at their avatars
SERVE_BURST = ("vector_add", "scan", "sgemm")
SERVE_BURST_N, SERVE_RATE = 200, 40.0
# phase 5's wrapper row of each burst kernel's configuration
SERVE_P5 = {"vector_add": f"saxpy n={1 << 20}", "scan": f"scan n={SCAN_N}",
            "sgemm": "sgemm[high]"}
# one request under its avatar: operand shapes (padded up, cut back)
SERVE_BELOW = {"vector_add": ((), (1_000_000,), (1_000_000,)),
               "scan": ((4_000_000,),),
               "sgemm": ((), (1000, 1000), (1000, 1000), (), (1000, 1000))}


def serve_operands(rng, key, shapes, statics):
    """Seeded numpy operands of ``key`` at ``shapes``: host scalars as
    0-d float32, floats uniform in [-1, 1) (N-body masses in [0.5,
    1.5)), int32 values in [0, nbins) (256 for the scans)."""
    import numpy as np

    out = []
    for i, shape in enumerate(shapes):
        if shape == ():
            out.append(np.float32(rng.uniform(0.5, 2.0)))
        elif key in ("scan", "scan_exclusive", "histogram",
                     "scan_histogram"):
            out.append(rng.integers(0, statics.get("nbins", 256), shape,
                                    dtype=np.int32))
        elif key == "nbody" and i == 6:
            out.append(rng.random(shape, dtype=np.float32) + 0.5)
        else:
            out.append(rng.random(shape, dtype=np.float32) * 2 - 1)
    return out


def as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def host_tensor(torch, a):
    """A numpy result as a CPU tensor; a read-only one (a view of a
    response's bytes) is copied first."""
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def serve_in_process(torch, key, args, statics):
    """``registry.dispatch`` of numpy operands on the card, in this
    process (as the daemon uploads them); numpy results, and the port
    tensors for the oracle."""
    from tpukernels_torch import interop, registry

    targs = interop.to_port(key, args)
    out = as_tuple(interop.from_port(registry.dispatch(key, *targs,
                                                       **statics)))
    return out, targs


def serve_oracle_check(torch, label, key, targs, got, statics):
    """The daemon's result against the port's oracle at
    ``integrity.tolerance`` (N-body: its chunked plain version at the C
    checker's bar, as in phase 4)."""
    from tpukernels_torch.kernels import nbody as NB
    from tpukernels_torch.resilience import integrity

    kind, rtol, atol = integrity.tolerance(key)
    fn = integrity.oracle(key)
    if key == "nbody":
        kind, (rtol, atol), fn = "band", NBODY_BAND, NB.nbody_plain
    want = as_tuple(fn(*targs, **statics))
    for i, (g, w) in enumerate(zip(got, want)):
        g = host_tensor(torch, g).to(w.device)
        part = f" [{i}]" if len(want) > 1 else ""
        if kind == "band":
            check(f"{label}{part} vs oracle", g, w, rtol, atol)
        else:
            check_exact(f"{label}{part} vs oracle", g, w)


def serve_same(torch, label, got, want):
    """Fail unless the daemon's result is bit for bit the in-process one."""
    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} outputs, expected "
                             f"{len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        part = f" [{i}]" if len(want) > 1 else ""
        check_exact(f"{label}{part}", host_tensor(torch, g),
                    host_tensor(torch, w))


class ServeDaemon:
    """One ``python -m tpukernels_torch.serve`` child on the card, its
    socket, pidfile, journal, integrity state and tuning cache in
    ``root/name``."""

    def __init__(self, root, name, **env_extra):
        self.dir = os.path.join(root, name)
        os.makedirs(self.dir)
        self.sock = os.path.join(self.dir, "s.sock")
        self.journal = os.path.join(self.dir, "journal.jsonl")
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("TPKT_")}
        env.update(PYTHONPATH=REPO, TPKT_SERVE_DIR=self.dir,
                   TPKT_HEALTH_JOURNAL=self.journal,
                   TPKT_INTEGRITY_DIR=os.path.join(self.dir, "integrity"),
                   TPKT_TUNING_CACHE_DIR=os.path.join(root, "tuning"),
                   TPKT_TRACE="1", **env_extra)
        self.out = open(os.path.join(self.dir, "stdout.txt"), "w")
        self.err = open(os.path.join(self.dir, "stderr.txt"), "w")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "tpukernels_torch.serve", "--socket",
             self.sock], cwd=REPO, env=env, stdout=self.out, stderr=self.err)
        self.ready_s = None

    def wait_ready(self, timeout=180):
        from tpukernels_torch.serve import client as serve_client

        deadline = time.monotonic() + timeout
        while True:
            if self.proc.poll() is not None:
                raise AssertionError(f"serve daemon exited rc "
                                     f"{self.proc.returncode}: "
                                     f"{self.stderr()[-3000:]}")
            try:
                with serve_client.ServeClient(self.sock, timeout_s=30) as c:
                    pong = c.ping()
                break
            except OSError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.1)
        if self.ready_s is None:
            self.ready_s = time.perf_counter() - self.t0
        return pong

    def stderr(self):
        if not self.err.closed:
            self.err.flush()
        with open(os.path.join(self.dir, "stderr.txt")) as f:
            return f.read()

    def events(self, kind=None):
        from tpukernels_torch.resilience import journal

        recs, _ = journal.load_events([self.journal])
        return [e for e in recs if kind is None or e.get("kind") == kind]

    def stats(self):
        from tpukernels_torch.serve import client as serve_client

        with serve_client.ServeClient(self.sock, timeout_s=60) as c:
            return c.stats()

    def stop(self):
        """SIGTERM; fail unless the daemon exits 0 with its socket and
        pidfile gone, ``serve_stop`` journaled and nothing on stdout."""
        import signal

        self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(60)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(30)
            raise AssertionError(f"serve daemon {self.dir}: no exit 60 s "
                                 "after SIGTERM")
        self.out.close()
        self.err.close()
        with open(os.path.join(self.dir, "stdout.txt")) as f:
            out = f.read()
        left = [p for p in ("s.sock", "serve.pid")
                if os.path.exists(os.path.join(self.dir, p))]
        stops = self.events("serve_stop")
        if rc != 0 or left or len(stops) != 1 or out:
            raise AssertionError(
                f"serve daemon {os.path.basename(self.dir)}: rc {rc}, left "
                f"{left}, {len(stops)} serve_stop, stdout {out[:200]!r}")
        return stops[0]

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(30)
        for f in (self.out, self.err):
            if not f.closed:
                f.close()


def shm_lane_ms(np, up, down, reps=5):
    """Host ms, best of ``reps``, of the client's two shm-lane steps in
    this process: staging ``up`` bytes into a new ``/dev/shm`` segment
    (create, allocate, write, close, unlink), and mapping a segment of
    ``down`` bytes and copying it out, as ``ServeClient`` does."""
    from tpukernels_torch.serve import protocol

    src = np.ones(up, np.uint8)
    seg = protocol.ShmSegment(down)
    seg.write(np.ones(down, np.uint8))
    best = {"stage_up": float("inf"), "copy_out": float("inf")}
    try:
        for _ in range(reps):
            t0 = time.perf_counter()
            _d, _w, segs, _n = protocol.stage_shm_payloads([src], 1)
            for s in segs:
                s.close()
                s.unlink()
            t1 = time.perf_counter()
            mm = protocol.open_shm(seg.name, down)
            np.array(np.frombuffer(mm, np.uint8))
            mm.close()
            t2 = time.perf_counter()
            best["stage_up"] = min(best["stage_up"], (t1 - t0) * 1e3)
            best["copy_out"] = min(best["copy_out"], (t2 - t1) * 1e3)
    finally:
        seg.close()
        seg.unlink()
    return best


def pct(vals, q):
    import numpy as np

    return float(np.percentile(vals, q)) if len(vals) else None


def serve_burst(torch, sock, operands, wants, seed):
    """The seeded Poisson burst from two client threads (shm lane);
    every response is checked bit for bit. Returns per request
    (index, kernel, request id, client wall s, rejected)."""
    import numpy as np

    from tpukernels_torch.serve import client as serve_client

    rng = np.random.default_rng(seed)
    at = np.cumsum(rng.exponential(1 / SERVE_RATE, SERVE_BURST_N))
    kinds = rng.choice(SERVE_BURST, SERVE_BURST_N)
    results, errors = [], []
    t0 = time.perf_counter() + 0.05

    def worker(part):
        with serve_client.ServeClient(sock, timeout_s=120) as c:
            for i in range(part, SERVE_BURST_N, 2):
                key = str(kinds[i])
                delay = t0 + at[i] - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
                rid = f"burst-{seed}-{i}"
                c.next_request_id = rid
                s0 = time.perf_counter()
                try:
                    got = as_tuple(c.dispatch(key, *operands[key]))
                except serve_client.ServeRejected:
                    results.append((i, key, rid, None, True))
                    continue
                wall = time.perf_counter() - s0
                if not all(np.array_equal(g, w) and g.dtype == w.dtype
                           for g, w in zip(got, wants[key])):
                    errors.append(f"{rid} ({key}): differs from the "
                                  "in-process dispatch")
                results.append((i, key, rid, wall, False))

    threads = [threading.Thread(target=worker, args=(p,)) for p in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    if any(t.is_alive() for t in threads) or errors:
        raise AssertionError(f"serve burst: {errors[:5]} "
                             f"({len(errors)} errors)")
    return sorted(results), time.perf_counter() - t0


def phase_serve(torch, times, rates, args, kept):
    """Phase 7: the serving daemon on the card."""
    log("== phase 7: the serving daemon (python -m tpukernels_torch.serve)")
    from tpukernels_torch import _build

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="tpkt_serve_")
    shim, cbin = _build.build_shim(), _build.build_c_drivers()  # phase 6's
    libs = sorted(p.name for p in _build.BUILD_DIR.glob("*.so"))
    plan = json.dumps({"wedge_dispatch": {"kernel": "scan", "times": 1}})
    main_d = ServeDaemon(root, "main")
    chaos_d = ServeDaemon(root, "chaos", TPKT_FAULT_PLAN=plan,
                          TPKT_SERVE_REQUEST_TIMEOUT_S="2")
    try:
        with knobs(TPKT_TUNING_CACHE_DIR=os.path.join(root, "tuning"),
                   TPKT_SERVE_SHM=None, TPKT_SERVE_SHM_MIN_BYTES=None):
            out = serve_drive(torch, times, rates, args, main_d, chaos_d,
                              (shim, cbin), kept)
        # 8. clean stop
        for d in (main_d, chaos_d):
            stop = d.stop()
            log(f"PASS serve clean stop {os.path.basename(d.dir)}: rc 0, "
                f"socket and pidfile gone, serve_stop (served "
                f"{stop['served']}, requeued {stop['requeued']}, uptime "
                f"{stop['uptime_s']} s), stdout empty")
        # 5. the daemons built nothing
        after = sorted(p.name for p in _build.BUILD_DIR.glob("*.so"))
        if after != libs or any("nvcc" in d.stderr()
                                for d in (main_d, chaos_d)):
            raise AssertionError(f"a serve daemon built a library: {libs} "
                                 f"-> {after}")
        log(f"PASS serve daemons built nothing ({len(libs)} libraries)")
        out["phase_s"] = round(time.perf_counter() - t_phase, 3)
        log(f"phase 7 wall {out['phase_s']:.1f} s")
        print(json.dumps({"serve": out}), flush=True)
        return out
    finally:
        main_d.kill()
        chaos_d.kill()
        shutil.rmtree(root, ignore_errors=True)


def serve_first_vs_warm(main_d, burst):
    """Step 5 of phase 7: the ``dispatch/<key>`` span of the daemon's
    first request of each burst kernel's avatar bucket (the inline one
    of step 2: it loads the kernel's library and makes its plan)
    against the burst's warm p50 of the same span."""
    spans = {(e.get("request_id"), e["name"]): e["wall_s"] * 1e3
             for e in main_d.events("span")}
    warm = {}
    for key in SERVE_BURST:
        first = spans[(f"avatar-{key}-inline",
                       f"serve/{key}/dispatch/{key}")]
        rest = burst[key]["span_ms_p50"][f"serve/{key}/dispatch/{key}"]
        warm[key] = {"first_dispatch_ms": first, "warm_dispatch_ms_p50": rest}
        if not first > rest:
            raise AssertionError(f"serve {key}: first dispatch {first:.3f} "
                                 f"ms, not slower than the warm p50 "
                                 f"{rest:.3f} ms")
        log(f"PASS serve warm {key}: first dispatch {first:.3f} ms (its "
            f"library loaded, its plan made), warm p50 {rest:.3f} ms")
    return warm


def serve_drive(torch, times, rates, args, main_d, chaos_d, c_built, kept):
    """Steps 1-7 of phase 7 (item 7 of the module docstring); each
    avatar's operands, statics and the daemon's answer go into
    ``kept`` (phase 9 holds the fleet's answers to them)."""
    import numpy as np

    from tpukernels_torch import aot
    from tpukernels_torch.resilience import integrity
    from tpukernels_torch.serve import client as serve_client

    # 1. start: both daemons were started together; wait for their pings
    pong = main_d.wait_ready()
    chaos_d.wait_ready()
    if not pong["device"].startswith("cuda") or "shm" not in pong["lanes"]:
        raise AssertionError(f"serve daemon: {pong}")
    log(f"PASS serve start: pid {pong['pid']} on {pong['device']} "
        f"({pong['device_kind']}, torch {pong['torch']}), lanes "
        f"{pong['lanes']}, ping after {main_d.ready_s:.2f} s; chaos daemon "
        f"after {chaos_d.ready_s:.2f} s")
    before = main_d.stats()["launches"]
    if any(before.values()):
        raise AssertionError(f"a fresh daemon counts launches: {before}")

    # 2. every key at its avatar, inline then shm, bitwise against the
    # in-process dispatch and against the oracle
    rng = np.random.default_rng(args.seed)
    avatar, wants, operands = {}, {}, {}
    for key, spec in aot.BENCH_CONFIGS.items():
        statics = dict(spec["statics"])
        ops = serve_operands(rng, key, [s for _k, s in spec["args"]],
                             statics)
        want, targs = serve_in_process(torch, key, ops, statics)
        row = {}
        for lane, shm in (("inline", "0"), ("shm", None)):
            with knobs(TPKT_SERVE_SHM=shm), \
                    serve_client.ServeClient(main_d.sock,
                                             timeout_s=300) as c:
                c.next_request_id = f"avatar-{key}-{lane}"
                s0 = time.perf_counter()
                got = as_tuple(c.dispatch(key, *ops, **statics))
                row[f"{lane}_ms"] = (time.perf_counter() - s0) * 1e3
                big = sum(np.asarray(a).nbytes >= 1 << 16 for a in ops)
                if c.staged_payloads != (big if lane == "shm" else 0):
                    raise AssertionError(f"serve {key} {lane}: "
                                         f"{c.staged_payloads} operands "
                                         "through /dev/shm")
            serve_same(torch, f"serve {key} avatar {lane} vs in-process "
                       "dispatch", got, want)
            if lane == "inline":
                serve_oracle_check(torch, f"serve {key} avatar", key, targs,
                                   got, statics)
        row["up_bytes"] = int(sum(np.asarray(a).nbytes for a in ops))
        row["down_bytes"] = int(sum(w.nbytes for w in want))
        avatar[key] = row
        kept[key] = (ops, statics, got)
        log(f"serve {key} avatar: client wall inline {row['inline_ms']:.3f} "
            f"ms (the daemon's first request of the bucket), shm "
            f"{row['shm_ms']:.3f} ms; {row['up_bytes'] / 2**20:.2f} MiB up, "
            f"{row['down_bytes'] / 2**20:.2f} MiB down")
        if key in SERVE_BURST:
            operands[key], wants[key] = ops, want
        del targs
    torch.cuda.empty_cache()

    # 3. below the avatar: padded up, cut back, against the unpadded
    # in-process dispatch at the oracle's tolerance
    below = {}
    for key, shapes in SERVE_BELOW.items():
        ops = serve_operands(rng, key, shapes, {})
        want, _ = serve_in_process(torch, key, ops, {})
        with serve_client.ServeClient(main_d.sock, timeout_s=300) as c:
            c.next_request_id = f"below-{key}"
            got = as_tuple(c.dispatch(key, *ops))
        kind, rtol, atol = integrity.tolerance(key)
        label = (f"serve {key} at "
                 f"{'x'.join(map(str, max(shapes, key=len)))} padded to its "
                 "avatar, vs in-process dispatch")
        for g, w in zip(got, want):
            g, w = host_tensor(torch, g), host_tensor(torch, w)
            if kind == "band":
                check(label, g, w, rtol, atol)
            else:
                check_exact(label, g, w)
        (ev,) = [e for e in main_d.events("serve_request")
                 if e.get("request_id") == f"below-{key}"]
        if not ev["bucketed"] or not ev["pad_frac"] > 0:
            raise AssertionError(f"serve {key} below its avatar: {ev}")
        below[key] = {"shapes": [list(s) for s in shapes],
                      "pad_frac": ev["pad_frac"],
                      "wall_ms": ev["wall_s"] * 1e3}

    # 4. the burst
    results, burst_s = serve_burst(torch, main_d.sock, operands, wants,
                                   args.seed)
    stats = main_d.stats()
    launches = {k: v - before.get(k, 0) for k, v in stats["launches"].items()
                if v != before.get(k, 0)}
    log("serve daemon kernels: " + json.dumps(launches))
    idle = [k for k in SERVE_PATH if launches.get(k, 0) <= 0]
    if idle:
        raise AssertionError(f"kernels the daemon never launched: {idle}")
    log(f"PASS serve path: every kernel of the daemon's default path "
        f"launched ({', '.join(SERVE_PATH)})")
    rejected = [r for r in results if r[4]]
    reqs = {e.get("request_id"): e for e in main_d.events("serve_request")}
    spans = {}
    for e in main_d.events("span"):
        rid = e.get("request_id")
        if rid and rid.startswith("burst-"):
            spans.setdefault(rid, {})[e["name"]] = e["wall_s"]
    hists = stats["metrics"]["histograms"]
    burst = {}
    for key in SERVE_BURST:
        mine = [r for r in results if r[1] == key and not r[4]]
        walls = [r[3] * 1e3 for r in mine]
        evs = [reqs[r[2]] for r in mine]
        sp = [spans.get(r[2], {}) for r in mine]

        def span_ms(name):
            return [s[name] * 1e3 for s in sp if name in s]

        up, down = avatar[key]["up_bytes"], avatar[key]["down_bytes"]
        row = {
            "n": len(mine), "rejected": sum(r[1] == key for r in rejected),
            "wall_ms_p50": pct(walls, 50), "wall_ms_p99": pct(walls, 99),
            "daemon_wall_ms_p50": pct([e["wall_s"] * 1e3 for e in evs], 50),
            "batch_size_mean": float(np.mean([e["batch_size"] for e in evs])),
            "batch_size_max": int(max(e["batch_size"] for e in evs)),
            "queue_wait_ms_p50": pct([e["queue_wait_s"] * 1e3 for e in evs],
                                     50),
            "queue_wait_ms_p99": pct([e["queue_wait_s"] * 1e3 for e in evs],
                                     99),
            "span_ms_p50": {
                name: pct(span_ms(name), 50) for name in (
                    "serve/wait/queue", "serve/pad", f"serve/{key}",
                    f"serve/{key}/dispatch/{key}")},
            "wrapper_ms": times[SERVE_P5[key]]["ms"],
            "up_bytes": up, "down_bytes": down,
            "copy_bound_ms": {kind: (up / r["h2d"] + down / r["d2h"]) * 1e3
                              for kind, r in rates.items()},
        }
        sv, dp = (row["span_ms_p50"][f"serve/{key}"],
                  row["span_ms_p50"][f"serve/{key}/dispatch/{key}"])
        row["copies_ms_p50"] = sv - dp if sv is not None and dp is not None \
            else None
        row["client_over_daemon_ms_p50"] = (row["wall_ms_p50"]
                                            - row["daemon_wall_ms_p50"])
        row["shm_lane_ms"] = shm_lane_ms(np, up, down)
        burst[key] = row
        log(f"serve burst {key}: {row['n']} requests, client wall p50 "
            f"{row['wall_ms_p50']:.3f} / p99 {row['wall_ms_p99']:.3f} ms; "
            f"batch size mean {row['batch_size_mean']:.2f} (max "
            f"{row['batch_size_max']}); queue wait p50 "
            f"{row['queue_wait_ms_p50']:.3f} / p99 "
            f"{row['queue_wait_ms_p99']:.3f} ms; rejected {row['rejected']}; "
            "span p50 ms " + ", ".join(
                f"{k} {v:.3f}" for k, v in row["span_ms_p50"].items()
                if v is not None)
            + f"; serve - dispatch {row['copies_ms_p50']:.3f} ms; client wall "
            f"- daemon wall p50 {row['client_over_daemon_ms_p50']:.3f} ms "
            f"(this process alone: stage {up / 2**20:.1f} MiB into /dev/shm "
            f"{row['shm_lane_ms']['stage_up']:.3f} ms, map and copy out "
            f"{down / 2**20:.1f} MiB {row['shm_lane_ms']['copy_out']:.3f} ms)"
            f"; wrapper "
            f"(phase 5) {row['wrapper_ms']:.4f} ms; {up / 2**20:.1f} MiB up, "
            f"{down / 2**20:.1f} MiB down: copy bound pageable "
            f"{row['copy_bound_ms']['pageable']:.3f} ms, pinned "
            f"{row['copy_bound_ms']['pinned']:.3f} ms")
    if rejected:
        raise AssertionError(f"serve burst: {len(rejected)} rejections at "
                             "the default queue")
    done = len(results)
    log(f"PASS serve burst: {done} requests in {burst_s:.2f} s "
        f"({done / burst_s:.1f}/s offered {SERVE_RATE}/s), 0 errors, 0 "
        f"rejections; daemon serve.batch_size "
        f"{ {k: hists['serve.batch_size'][k] for k in ('p50', 'max')} }, "
        f"serve.queue_wait_s p50/p99 "
        f"{hists['serve.queue_wait_s']['p50']:.6f}/"
        f"{hists['serve.queue_wait_s']['p99']:.6f}")

    warm = serve_first_vs_warm(main_d, burst)

    # 6. one chaos drive: the first scan dispatch wedges
    x = operands["scan"]
    s0 = time.perf_counter()
    with serve_client.ServeClient(chaos_d.sock, timeout_s=120) as c:
        got = as_tuple(c.dispatch("scan", *x))
    chaos_s = time.perf_counter() - s0
    serve_same(torch, "serve chaos scan (wedged once) vs in-process "
               "dispatch", got, wants["scan"])
    requeued = chaos_d.events("serve_request_requeued")
    verdicts = [e for e in chaos_d.events("wedge_classification")
                if e.get("site") == "serve"]
    if len(requeued) != 1 or not verdicts:
        raise AssertionError(f"serve chaos: {len(requeued)} requeues, "
                             f"{len(verdicts)} classifications at serve")
    log(f"PASS serve chaos wedge_dispatch: answered in {chaos_s:.2f} s, one "
        f"serve_request_requeued, wedge_classification "
        f"{[v['verdict'] for v in verdicts]} at site serve")

    # 7. a C driver through the daemon
    shim, cbin = c_built
    n_before = len(main_d.events("serve_request"))
    p, cev = c_child(cbin, main_d.dir, "c_child", "vector_add",
                     ["--check", "--reps=1", f"--n={1 << 20}"],
                     {"TPKT_SERVE_SOCKET": main_d.sock}, shim)
    served = main_d.events("serve_request")[n_before:]
    capi = [e for e in cev if e.get("kind") == "span"
            and e.get("name") == "capi/vector_add"]
    local = [e for e in cev if e.get("kind") == "span"
             and "dispatch/" in e.get("name", "")]
    if (p.returncode != 0 or "kernel=vector_add CHECK PASS" not in p.stdout
            or len(served) != len(capi) or not capi or local
            or any(e["pid"] != main_d.proc.pid or e["kernel"] != "vector_add"
                   for e in served)):
        raise AssertionError(f"serve C driver: rc {p.returncode}, "
                             f"{len(served)} served, {len(capi)} capi spans, "
                             f"{len(local)} in-process dispatches\n"
                             f"{p.stdout[-2000:]}\n{p.stderr[-2000:]}")
    m = _METRIC_LINE.search(p.stdout)
    log(f"PASS serve C vector_add --check through the daemon: CHECK PASS, "
        f"{len(served)} serve_request under the daemon's pid "
        f"{main_d.proc.pid}, none in process; time_ms "
        f"{m.group(3) if m else '?'}")
    return {
        "device": pong["device"], "device_kind": pong["device_kind"],
        "ready_s": round(main_d.ready_s, 3), "launches": launches,
        "avatar": avatar, "below": below, "burst": burst,
        "burst_s": burst_s, "warm": warm, "chaos_s": chaos_s,
        "c_time_ms": float(m.group(3)) if m else None,
        "daemon_hists": {k: {q: hists[k][q] for q in ("count", "p50", "p99",
                                                      "max")}
                         for k in ("serve.batch_size", "serve.queue_wait_s")},
    }


# ---------------------------------------------------------------- phase 8

# what the distributed path launches (the kernels of the ranks' local
# work); nbody_forces_ij is on no other path
DIST_PATH = ("jacobi2d", "jacobi3d", "scan", "histogram", "nbody_forces_ij")
DIST_RANKS = 4
DIST_K = 4  # the reference's default halo depth
STENCIL2D_N, STENCIL2D_ITERS = 4096, 1000
# phase 5's single-device row of each distributed entry
DIST_ROWS = {"jacobi2d": "jacobi2d", "jacobi3d": "jacobi3d",
             "scan": f"scan n={SCAN_N}", "scan_exclusive": f"scan n={SCAN_N}",
             "histogram": f"histogram n={SCAN_N}", "nbody_psum": "nbody",
             "nbody_ring": "nbody"}
# the N-body ring's knobs phase 8b holds against the plain ring
RING_KNOBS = (("skip_last", {"TPKT_NBODY_RING_SKIP_LAST": "1"}),
              ("bidir", {"TPKT_NBODY_RING_BIDIR": "1"}),
              ("depth 2", {"TPKT_DIST_DEPTH": "2"}))
# every knob of the distributed layer, cleared around phase 8's calls
DIST_KNOBS = ("TPKT_DIST_DEPTH", "TPKT_NBODY_RING_SKIP_LAST",
              "TPKT_NBODY_RING_BIDIR", "TPKT_STENCIL_K", "TPKT_MESH",
              "TPKT_COORDINATOR_ADDRESS", "TPKT_NUM_PROCESSES",
              "TPKT_PROCESS_ID", "TPKT_DIST_BACKEND", "TPKT_LOCAL_DEVICE",
              "TPKT_BUSBW_SWEEP", "TPKT_BUSBW_MIN", "TPKT_BUSBW_MAX",
              "TPKT_BUSBW_REPS", "TPKT_BUSBW_OP", "TPKT_NBODY_DIST",
              "TPKT_STENCIL_RESIDUAL")
# c/run_all.sh's mesh rows (its mesh block, lines 55-96), the
# knobs under the port's names: (extra env, driver, args)
C_MESH_ROWS = (
    ({}, "stencil", ["--n=256", "--iters=10"]),
    ({}, "stencil", ["--n=128", "--m=320", "--iters=5"]),
    ({}, "stencil", ["--n=64", "--z=64", "--iters=5"]),
    ({}, "scan_histogram", ["--n=100000"]),
    ({}, "nbody", ["--n=1024", "--iters=2"]),
    ({}, "allreduce_bench", ["--n=1048576"]),
    ({"TPKT_NBODY_DIST": "ring"}, "nbody", ["--n=1024", "--iters=2"]),
    ({"TPKT_NBODY_DIST": "ring", "TPKT_NBODY_RING_BIDIR": "1",
      "TPKT_NBODY_RING_SKIP_LAST": "1"}, "nbody", ["--n=1000", "--iters=2"]),
    ({"TPKT_STENCIL_RESIDUAL": "1"}, "stencil", ["--n=128", "--iters=5"]),
    ({"TPKT_STENCIL_RESIDUAL": "1"}, "stencil",
     ["--n=64", "--z=64", "--iters=5"]),
    ({"TPKT_BUSBW_SWEEP": "1", "TPKT_BUSBW_MIN": "1K",
      "TPKT_BUSBW_MAX": "16K", "TPKT_BUSBW_REPS": "2"}, "allreduce_bench",
     ["--n=1048576"]),
)


def dist_inputs(torch, seed):
    """The configurations of record as full copies on the card, the same
    on every rank (one seeded generator): the 2-D and 3-D grids, 2^22
    int32 values in [0, 256) and 65 536 bodies."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n3 = STENCIL3D_N
    return {
        "grid2d": torch.randn(STENCIL2D_N, STENCIL2D_N, device="cuda",
                              generator=gen),
        "grid3d": torch.randn(n3, n3, n3, device="cuda", generator=gen),
        "ints": torch.randint(0, SCAN_NBINS, (SCAN_N,), device="cuda",
                              generator=gen, dtype=torch.int32),
        "bodies": bodies(gen, NBODY_N),
    }


def dist_calls(mesh, inp, k=DIST_K):
    """``{label: call}``: each distributed entry at its configuration of
    record on ``mesh``, from full copies to the full result (this rank's
    block cut, the entry run, the blocks gathered)."""
    from tpukernels_torch.parallel import P, collectives as C
    from tpukernels_torch.parallel import global_to_host, host_to_global

    X = P("x")

    def blk(t):
        return host_to_global(t, mesh, X)

    def full(t):
        return global_to_host(t, mesh, X)

    b = inp["bodies"]
    return {
        "jacobi2d": lambda: full(C.jacobi2d_dist(
            blk(inp["grid2d"]), STENCIL2D_ITERS, mesh, k=k)),
        "jacobi3d": lambda: full(C.jacobi3d_dist(
            blk(inp["grid3d"]), STENCIL3D_ITERS, mesh, k=k)),
        "scan": lambda: full(C.scan_dist(blk(inp["ints"]), mesh)),
        "scan_exclusive": lambda: full(C.scan_dist(blk(inp["ints"]), mesh,
                                                   exclusive=True)),
        "histogram": lambda: C.histogram_dist(blk(inp["ints"]), SCAN_NBINS,
                                              mesh),
        "nbody_psum": lambda: stacked(C.nbody_dist_psum(
            tuple(b[:6]) + (blk(b[6]),), 1, mesh)),
        "nbody_ring": lambda: stacked(tuple(full(t) for t in
                                            C.nbody_dist_ring(
                                                tuple(map(blk, b)), 1,
                                                mesh))),
    }


def single_device(inp):
    """``{label: call}``: the single-device wrapper each distributed
    entry is held against."""
    from tpukernels_torch.kernels import histogram as H, nbody as NB
    from tpukernels_torch.kernels import scan as SC, stencil as J

    return {
        "jacobi2d": lambda: J.jacobi2d(inp["grid2d"], STENCIL2D_ITERS),
        "jacobi3d": lambda: J.jacobi3d(inp["grid3d"], STENCIL3D_ITERS),
        "scan": lambda: SC.inclusive_scan(inp["ints"]),
        "scan_exclusive": lambda: SC.exclusive_scan(inp["ints"]),
        "histogram": lambda: H.histogram(inp["ints"], SCAN_NBINS),
        "nbody_psum": lambda: stacked(NB.nbody_step(*inp["bodies"])),
        "nbody_ring": lambda: stacked(NB.nbody_step(*inp["bodies"])),
    }


def forces_ij_times(torch, peaks):
    """``forces_ij``'s ms at the shapes of the distributed forms (all
    bodies from all, world 1; all from a quarter, the psum at 4 ranks; a
    quarter from a quarter, the ring's hop at 4 ranks) against its bound,
    ni·nj·20 flops at the fp32 peak; the plain version at the first."""
    from tpukernels_torch.kernels import nbody as NB

    _, bw, _, fp32 = peaks
    gen = torch.Generator(device="cuda").manual_seed(8)
    eps2 = NB._eps2(1e-2)
    rows = []
    for ni, nj in ((NBODY_N, NBODY_N), (NBODY_N, NBODY_N // 4),
                   (NBODY_N // 4, NBODY_N // 4)):
        i, j = bodies(gen, ni), bodies(gen, nj)
        args = (i[0], i[1], i[2], j[0], j[1], j[2], j[6], eps2)
        b_ms, b_by = bound(4 * (3 * ni + 4 * nj + 3 * ni), 20 * ni * nj,
                           fp32, bw)
        row = {"ni": ni, "nj": nj,
               "ms": time_ms(lambda: NB.forces_ij(*args), 10),
               "bound_ms": b_ms, "bound_by": b_by}
        if ni == nj == NBODY_N:
            row["plain_ms"] = time_ms(lambda: NB.forces_ij_plain(*args), 1,
                                      warmup=1)
        log(f"forces_ij {ni} x {nj}: {row['ms']:.4f} ms a call, bound "
            f"{b_ms:.4f} ms ({b_by}), {b_ms / row['ms']:.0%} of it"
            + (f"; plain {row['plain_ms']:.4f} ms" if "plain_ms" in row
               else ""))
        rows.append(row)
    return rows


def phase_dist(torch, times, peaks, args):
    """Phase 8: the distributed layer on the card."""
    log("== phase 8: the distributed layer (tpukernels_torch.parallel)")
    from tpukernels_torch import _build

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    shim, cbin = _build.build_shim(), _build.build_c_drivers()  # phase 6's
    libs = sorted(p.name for p in _build.BUILD_DIR.glob("*.so"))
    state = tempfile.mkdtemp(prefix="tpkt_dist_")
    try:
        with knobs(**{k: None for k in DIST_KNOBS}):
            out = {"nccl": dist_nccl(torch, times, peaks, state, args.seed)}
            out["gloo"] = dist_gloo(torch, state, args.seed)
            out["c"] = dist_c(state, shim, cbin)
        after = sorted(p.name for p in _build.BUILD_DIR.glob("*.so"))
        if after != libs:
            raise AssertionError(f"a rank built a library: {libs} -> {after}")
        log(f"PASS phase 8 ranks built nothing ({len(libs)} libraries)")
        out["phase_s"] = round(time.perf_counter() - t_phase, 3)
        log(f"phase 8 wall {out['phase_s']:.1f} s")
        print(json.dumps({"dist": {k: v for k, v in out.items()
                                   if k != "c"}}), flush=True)
        return out
    finally:
        shutil.rmtree(state, ignore_errors=True)


def dist_nccl(torch, times, peaks, state, seed):
    """8a: one rank on NCCL (a group of one: NCCL takes one rank a card).
    The bandwidth sweeps (the n = 1 copy rate), allreduce at 2^20, and
    the distributed path counted, bitwise against the single-device
    wrappers, with 0 bytes host-staged; then each entry's time beside
    phase 5's wrapper and forces_ij's against its bound."""
    import torch.distributed as dist

    from tpukernels_torch.kernels import LAUNCHES, reset_launches
    from tpukernels_torch.obs import metrics
    from tpukernels_torch.parallel import busbw, collectives as C, make_mesh

    with knobs(TPKT_COORDINATOR_ADDRESS=f"file://{state}/nccl_rendezvous",
               TPKT_NUM_PROCESSES="1", TPKT_PROCESS_ID="0"):
        mesh = make_mesh()
    try:
        if (mesh.backend, mesh.size, C.wire(mesh)) != ("nccl", 1, "nccl"):
            raise AssertionError(f"8a: mesh {mesh.backend} x{mesh.size} "
                                 f"on {C.wire(mesh)}; expected nccl x1")
        staged = metrics.counter("dist.host_staged_bytes")
        log("8a busbw, NCCL at world size 1: the degenerate n = 1 copy "
            "rate (bytes / t, no link between cards is measured)")
        sweeps = {op: [{"bytes": s, "seconds": t, "gb_s": g}
                       for s, t, g in busbw.sweep(mesh=mesh, op=op)]
                  for op in ("allreduce", "ppermute")}
        x = torch.randn(1, 1 << 20, device="cuda")
        check_exact("8a allreduce_sum 2^20 floats, world 1 (nccl)",
                    C.allreduce_sum(x, mesh), x)
        inp = dist_inputs(torch, seed)
        calls = dist_calls(mesh, inp)
        reset_launches()
        got = {label: fn() for label, fn in calls.items()}
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
        log("8a dist kernels: " + json.dumps(launches))
        idle = [k for k in DIST_PATH if launches[k] <= 0]
        if idle:
            raise AssertionError(f"8a: not launched on the distributed "
                                 f"path: {idle}")
        ref = single_device(inp)
        for label, g in got.items():
            check_exact(f"8a {label} world 1 (nccl) vs the single-device "
                        "wrapper", g, ref[label]())
        moved = metrics.counter("dist.host_staged_bytes") - staged
        if moved:
            raise AssertionError(f"8a: {moved} bytes host-staged on NCCL")
        log("PASS 8a host-staged bytes on NCCL: 0")
        ms = {}
        for label, fn in calls.items():
            ms[label] = time_ms(fn, 3, warmup=1)
            p5 = times[DIST_ROWS[label]]["ms"]
            log(f"8a {label}: {ms[label]:.4f} ms a call at world 1 on the "
                f"card (nccl; the gather included), single-device wrapper "
                f"(phase 5) {p5:.4f} ms")
        return {"launches": launches, "busbw": sweeps, "ms": ms,
                "forces_ij": forces_ij_times(torch, peaks)}
    finally:
        dist.destroy_process_group()


def dist_gloo(torch, state, seed):
    """8b: four ranks on the one card through gloo (each a process of
    its own running ``dist_rank``; the kernels run on the card, gloo
    stages the wire through host memory). Fails unless every rank passes
    its checks and launched every kernel of the path."""
    out_dir = os.path.join(state, "gloo")
    os.makedirs(out_dir)
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import chip_smoke; "
            "sys.exit(chip_smoke.dist_rank(sys.argv[2], int(sys.argv[3])))")
    env = {k: v for k, v in os.environ.items() if k not in DIST_KNOBS}
    env.pop("TPKT_HEALTH_JOURNAL", None)
    env.update(TPKT_COORDINATOR_ADDRESS=f"file://{out_dir}/rendezvous",
               TPKT_NUM_PROCESSES=str(DIST_RANKS), TPKT_DIST_BACKEND="gloo",
               TPKT_COORDINATOR_TIMEOUT_S="300")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, REPO, out_dir, str(seed)],
        env={**env, "TPKT_PROCESS_ID": str(r)}, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(DIST_RANKS)]
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, o) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"8b rank {r}: rc {p.returncode}\n"
                                 f"{o[-4000:]}")
    for line in outs[0].splitlines():
        log(line)
    ranks = []
    for r in range(DIST_RANKS):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
        idle = [k for k in DIST_PATH if ranks[r]["launches"][k] <= 0]
        if idle:
            raise AssertionError(f"8b rank {r}: not launched: {idle}")
    log("PASS 8b every rank launched " + ", ".join(DIST_PATH) + ": "
        + json.dumps([{k: r["launches"][k] for k in DIST_PATH}
                      for r in ranks]))
    return ranks[0]


def dist_rank(out_dir, seed):
    """One rank of phase 8b, in a process of its own (``dist_gloo``
    starts four): the distributed path at the configurations of record,
    counted; then its variants (k, TPKT_DIST_DEPTH, the residual, the
    ring's knobs, the bare collectives on a ring and a 2 × 2 mesh) and,
    on rank 0, every result against the single-device wrappers; the
    times a call and the bytes host-staged a call. Writes
    ``rank<r>.json`` into ``out_dir``; returns 0 or raises."""
    import torch

    from tpukernels_torch.kernels import LAUNCHES, reset_launches
    from tpukernels_torch.kernels import stencil as J
    from tpukernels_torch.obs import metrics
    from tpukernels_torch.parallel import P, collectives as C, make_mesh
    from tpukernels_torch.parallel import global_to_host, host_to_global

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh()
    rank = mesh.rank
    if not (mesh.size == DIST_RANKS and mesh.host_staged):
        raise AssertionError(f"8b: mesh of {mesh.size} on {C.wire(mesh)}")
    inp = dist_inputs(torch, seed)
    calls = dist_calls(mesh, inp)
    reset_launches()
    got = {label: fn() for label, fn in calls.items()}
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    ref = single_device(inp) if rank == 0 else {}
    for label, g in got.items():
        if rank == 0:
            band = label.startswith("nbody")
            want = ref[label]()
            if band:
                check(f"8b {label} x{DIST_RANKS} (host-staged gloo) vs the "
                      "single-device wrapper", g, want, *NBODY_BAND)
            else:
                check_exact(f"8b {label} x{DIST_RANKS} (host-staged gloo) vs "
                            "the single-device wrapper", g, want)
    if rank == 0:
        from tpukernels_torch.kernels import nbody as NB

        b, j = inp["bodies"], slice(0, NBODY_N // DIST_RANKS)
        args = (b[0], b[1], b[2], b[0][j], b[1][j], b[2][j], b[6][j],
                NB._eps2(1e-2))
        check(f"8b forces_ij {NBODY_N} x {NBODY_N // DIST_RANKS} (rank 0's "
              "j-block): a step vs its plain version",
              ij_step(b, NB.forces_ij(*args)),
              ij_step(b, NB.forces_ij_plain(*args)), *NBODY_BAND)
    X = P("x")
    # the stencils bitwise at every k and depth, and the residual
    for nd, grid, iters in ((2, inp["grid2d"], STENCIL2D_ITERS),
                            (3, inp["grid3d"], STENCIL3D_ITERS)):
        fn = C.jacobi2d_dist if nd == 2 else C.jacobi3d_dist
        want = got[f"jacobi{nd}d"]
        for k in (1, 4, 8):
            for depth in (1, 2):
                with knobs(TPKT_DIST_DEPTH=depth):
                    g = global_to_host(fn(host_to_global(grid, mesh, X),
                                          iters, mesh, k=k), mesh, X)
                if rank == 0:
                    check_exact(f"8b jacobi{nd}d_dist k={k} depth={depth} "
                                "vs the single-device wrapper", g, want)
        g, res = fn(host_to_global(grid, mesh, X), iters, mesh, residual=True)
        if rank == 0:
            nxt = (J.jacobi2d if nd == 2 else J.jacobi3d)(want, 1)
            d = (nxt.double() - want.double())
            check(f"8b jacobi{nd}d_dist residual", res.double().reshape(1),
                  (d * d).sum().reshape(1), 1e-4, 0.0)
    # the ring's knobs against the plain ring, bitwise where the order
    # of the sums is the same
    for name, env in RING_KNOBS:
        with knobs(**env):
            g = calls["nbody_ring"]()
        if rank == 0:
            if name == "bidir":
                check(f"8b nbody_ring {name} vs the single-device wrapper",
                      g, ref["nbody_ring"](), *NBODY_BAND)
            else:
                check_exact(f"8b nbody_ring {name} vs the plain ring", g,
                            got["nbody_ring"])
    # the bare collectives, exact (integer-valued floats: any order of
    # the sums is exact)
    m2 = make_mesh((2, 2))
    ints = torch.arange(64, dtype=torch.float32, device="cuda")
    mine = (ints * (rank + 1)).reshape(1, -1)
    total = ints * sum(range(1, DIST_RANKS + 1))
    for label, m in (("allreduce_sum 1-D", mesh), ("allreduce_sum 2x2", m2)):
        g = C.allreduce_sum(mine, m)
        check_exact(f"8b {label} rank {rank}", g[0], total)
    check_exact(f"8b bcast root 2 rank {rank}",
                C.bcast(mine, mesh, root=2)[0], ints * 3)
    check_exact(f"8b ring_shift +1 rank {rank}",
                C.ring_shift(mine, mesh)[0],
                ints * ((rank - 1) % DIST_RANKS + 1))
    # times a call, and the bytes the wire staged a call
    ms, staged = {}, {}
    for label, fn in calls.items():
        before = metrics.counter("dist.host_staged_bytes")
        ms[label] = time_ms(fn, 2, warmup=0)
        staged[label] = (metrics.counter("dist.host_staged_bytes")
                         - before) // 2
        if rank == 0:
            log(f"8b {label}: {ms[label]:.4f} ms a call at {DIST_RANKS} "
                f"ranks on one card (host-staged gloo, the gather "
                f"included), {staged[label]} bytes host-staged a call")
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"rank": rank, "launches": launches, "ms": ms,
                   "staged_bytes": staged}, f)
    return 0


def c_mesh_row(cbin, state, shim, name, driver, args, env_extra, ranks):
    """One C driver as ``ranks`` processes of one group (gloo on the one
    card; NCCL when one rank), each through the port's shim with its own
    journal and guard state; returns [(rc, stdout, stderr)] by rank."""
    d = os.path.join(state, name)
    os.makedirs(d)
    env = {k: v for k, v in os.environ.items() if not k.startswith("TPKT_")}
    env.update(TPU_KERNELS_SHIM=str(shim), TPKT_MESH=str(ranks),
               TPKT_COORDINATOR_ADDRESS=f"file://{d}/rendezvous",
               TPKT_NUM_PROCESSES=str(ranks),
               TPKT_COORDINATOR_TIMEOUT_S="300", **env_extra)
    if ranks > 1:
        env["TPKT_DIST_BACKEND"] = "gloo"
    cmd = [str(cbin / driver), "--device=tpu", "--check", "--reps=1", *args]
    procs = []
    for r in range(ranks):
        rd = os.path.join(d, f"rank{r}")
        os.makedirs(rd)
        procs.append(subprocess.Popen(
            cmd, cwd=rd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env={**env, "TPKT_PROCESS_ID": str(r),
                            "TPKT_INTEGRITY_DIR": os.path.join(rd, "integ"),
                            "TPKT_TUNING_CACHE_DIR":
                                os.path.join(rd, "tune")}))
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, o, e) for p, (o, e) in zip(procs, outs)]


def dist_c(state, shim, cbin):
    """8c: the unchanged C drivers as four rank processes
    (``TPKT_MESH=4``, gloo on the one card) on c/run_all.sh's mesh rows,
    each rank printing its own CHECK PASS (the residual rows their
    stderr line, the sweep row its table), and ``allreduce_bench`` at
    ``TPKT_MESH=1`` on NCCL."""
    rows = [(f"mesh {i}", env, driver, args, DIST_RANKS)
            for i, (env, driver, args) in enumerate(C_MESH_ROWS)]
    rows.append(("nccl allreduce_bench", {}, "allreduce_bench",
                 ["--n=1048576"], 1))
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        done = list(pool.map(lambda r: c_mesh_row(
            cbin, state, shim, re.sub(r"\W+", "_", r[0]), r[2], r[3], r[1],
            r[4]), rows))
    out = []
    for (name, env, driver, args, ranks), results in zip(rows, done):
        kernel = "allreduce" if driver == "allreduce_bench" else driver
        label = " ".join([*(f"{k}={v}" for k, v in env.items()), driver,
                          *args])
        for r, (rc, o, e) in enumerate(results):
            ok = rc == 0 and f"kernel={kernel} CHECK PASS" in o
            if driver == "allreduce_bench":
                ok = ok and f" nranks={ranks} " in o
            if "TPKT_STENCIL_RESIDUAL" in env:
                ok = ok and "residual ||x_k+1 - x_k||^2 =" in e
            sweep = [line for line in o.splitlines()
                     if line.startswith("allreduce n=")]
            if "TPKT_BUSBW_SWEEP" in env:
                ok = ok and len(sweep) == 3
            if not ok:
                raise AssertionError(f"8c {label} rank {r}: rc {rc}\n"
                                     f"{o[-2000:]}\n{e[-3000:]}")
        wire = "nccl" if ranks == 1 else "host-staged gloo"
        residual = [line for line in results[0][2].splitlines()
                    if "residual ||x_k+1" in line]
        log(f"PASS C x{ranks} ({wire}) TPKT_MESH={ranks} {label}: every "
            "rank CHECK PASS" + "".join(f"; {x}" for x in residual[:1]))
        for line in (sweep if "TPKT_BUSBW_SWEEP" in env else ()):
            log(f"  rank 0 (host-staged gloo, 4 ranks on one card): {line}")
        out.append({"row": label, "ranks": ranks, "wire": wire})
    log(f"8c wall {time.perf_counter() - t0:.1f} s")
    return out



# ---------------------------------------------------------------- phase 9

# the fleet's health windows, compressed: a probe every half second, a
# respawn 0.2 s after a death, a wedged worker cooled for 2 s; hedging
# off, or a request held by the wedged worker of steps 5 and 6 would be
# answered by its hedge on the sibling (past the burst's p95) instead of
# spilling or being replayed
FLEET_ENV = {"TPKT_FLEET_PROBE_S": "0.5", "TPKT_FLEET_RESTART_BACKOFF_S": "0.2",
             "TPKT_ROUTER_RESTART_BACKOFF_S": "0.2",
             "TPKT_ROUTE_COOLDOWN_S": "2", "TPKT_ROUTE_HEDGE_PCTL": "0",
             "TPKT_TRACE": "1"}
FLEET_DRAIN_MIN = 4   # answered requests before, during and after a drain
FLEET_KR_THREADS, FLEET_KR_N = 2, 6  # the router kill's clients, requests


class Fleet:
    """``python -m tpukernels_torch.serve.ctl start-fleet`` on the card,
    its state, sockets and journal under ``root``."""

    def __init__(self, root):
        self.root = root
        self.dir = os.path.join(root, "fleet")
        self.front = os.path.join(self.dir, "front.sock")
        self.journal = os.path.join(root, "journal.jsonl")
        env = {k: v for k, v in os.environ.items() if not k.startswith("TPKT_")}
        env.update(PYTHONPATH=REPO, TPKT_SERVE_DIR=root,
                   TPKT_HEALTH_JOURNAL=self.journal,
                   TPKT_INTEGRITY_DIR=os.path.join(root, "integrity"),
                   TPKT_TUNING_CACHE_DIR=os.path.join(root, "tuning"),
                   **FLEET_ENV)
        self.env = env

    def ctl(self, *args, timeout=300, **extra):
        """One ``ctl`` verb; fails unless it exits 0."""
        p = subprocess.run(
            [sys.executable, "-m", "tpukernels_torch.serve.ctl", *args],
            cwd=REPO, env=dict(self.env, **extra), capture_output=True,
            text=True, timeout=timeout)
        if p.returncode != 0:
            raise AssertionError(f"ctl {' '.join(args)}: rc {p.returncode}\n"
                                 f"{p.stdout[-2000:]}\n{p.stderr[-2000:]}\n"
                                 f"{self.logs()[-4000:]}")
        return p.stdout

    def logs(self):
        """Every member's stderr log."""
        out = []
        for dirpath, _dirs, files in os.walk(self.dir):
            for f in sorted(files):
                if f.endswith(".log"):
                    with open(os.path.join(dirpath, f)) as fh:
                        out.append(f"--- {f}\n{fh.read()}")
        return "\n".join(out)

    def events(self, kind=None):
        from tpukernels_torch.resilience import journal

        recs, _ = journal.load_events([self.journal])
        return [e for e in recs if kind is None or e.get("kind") == kind]

    def wait(self, pred, timeout, what):
        """The journal's events matching ``pred`` once there is one."""
        deadline = time.monotonic() + timeout
        while True:
            hits = [e for e in self.events() if pred(e)]
            if hits:
                return hits
            if time.monotonic() > deadline:
                raise AssertionError(f"fleet: no {what} within {timeout} s")
            time.sleep(0.05)

    def pid(self, name):
        """The pid flocking ``name``'s pidfile (``router``, ``guardian``
        or a worker index), or None."""
        from tpukernels_torch.serve import proc

        path = (os.path.join(self.dir, f"worker{name}", "serve.pid")
                if isinstance(name, int)
                else os.path.join(self.dir, f"{name}.pid"))
        held, pid = proc.pidfile_state(path)
        return pid if held else None

    def worker_sock(self, i):
        return os.path.join(self.dir, f"worker{i}", "serve.sock")

    def stats(self):
        from tpukernels_torch.serve import client as serve_client

        with serve_client.ServeClient(self.front, timeout_s=60) as c:
            return c.stats()


def on_card(pid):
    """Whether process ``pid`` holds the card open (a ``/dev/nvidia*``
    descriptor: its CUDA context)."""
    d = f"/proc/{pid}/fd"
    for fd in os.listdir(d):
        try:
            if os.readlink(os.path.join(d, fd)).startswith("/dev/nvidia"):
                return True
        except OSError:
            continue
    return False


def running(pid):
    """Whether ``pid`` is a live process (a zombie is not)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except (OSError, IndexError):
        return False


def card_memory_used():
    """The card's ``memory.used`` in MiB (nvidia-smi), or None."""
    out = run(["nvidia-smi", "--query-gpu=memory.used",
               "--format=csv,noheader,nounits"]) or ""
    first = out.splitlines()[0].strip() if out else ""
    return int(first) if first.isdigit() else None


def compute_apps():
    """``nvidia-smi --query-compute-apps``: {pid: used MiB}."""
    out = run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
               "--format=csv,noheader,nounits"]) or ""
    apps = {}
    for line in out.splitlines():
        parts = [p.strip() for p in line.split(",")]
        if len(parts) == 2 and parts[0].isdigit():
            apps[int(parts[0])] = parts[1]
    return apps


def fleet_send(front, key, ops, statics, rid, shm=None):
    """One request through the fleet's front socket (the port's client);
    the answer as a tuple and the client wall in ms."""
    from tpukernels_torch.serve import client as serve_client

    with knobs(TPKT_SERVE_SHM=shm), \
            serve_client.ServeClient(front, timeout_s=300) as c:
        c.next_request_id = rid
        s0 = time.perf_counter()
        got = as_tuple(c.dispatch(key, *ops, **statics))
        return got, (time.perf_counter() - s0) * 1e3


def phase_fleet(torch, serve, avatars, args):
    """Phase 9: the serving fleet on the card (item 9 of the module
    docstring)."""
    log("== phase 9: the serving fleet (python -m tpukernels_torch.serve.ctl "
        "start-fleet 2)")
    from tpukernels_torch import _build

    t_phase = time.perf_counter()
    libs = sorted(p.name for p in _build.BUILD_DIR.glob("*.so"))
    root = tempfile.mkdtemp(prefix="tpkt_fleet_")
    fl = Fleet(root)
    started = False
    try:
        started = True
        out = fleet_drive(torch, fl, serve, avatars, args)
        # 8. stop
        said = fl.ctl("stop-fleet", "--wait", "60")
        started = False
        fleet_stopped(fl, out["pids"], said)
        after = sorted(p.name for p in _build.BUILD_DIR.glob("*.so"))
        logs = fl.logs()
        if after != libs or "nvcc" in logs:
            raise AssertionError(f"a fleet member built a library: {libs} -> "
                                 f"{after}")
        log(f"PASS fleet built nothing ({len(libs)} libraries before and "
            "after; no nvcc in any member's log, the respawned worker's "
            "included)")
        out["phase_s"] = round(time.perf_counter() - t_phase, 3)
        log(f"phase 9 wall {out['phase_s']:.1f} s")
        print(json.dumps({"fleet": out}), flush=True)
        return out
    finally:
        if started:
            subprocess.run(
                [sys.executable, "-m", "tpukernels_torch.serve.ctl",
                 "stop-fleet", "--wait", "30"], cwd=REPO, env=fl.env,
                capture_output=True, timeout=300)
        shutil.rmtree(root, ignore_errors=True)


def fleet_stopped(fl, pids, said):
    """Step 8: after ``stop-fleet`` no member runs, no socket, pidfile or
    config is left, and no ``tpkserve-*`` segment."""
    from tpukernels_torch.serve import protocol

    left = [os.path.relpath(os.path.join(d, f), fl.dir)
            for d, _dirs, files in os.walk(fl.dir) for f in files
            if f.endswith((".sock", ".pid")) or f == "fleet.json"]
    # a member releases its pidfile's flock, then exits: give the exits
    # a bounded while
    deadline = time.monotonic() + 60
    while any(running(pid) for pid in pids) and time.monotonic() < deadline:
        time.sleep(0.05)
    alive = [pid for pid in pids if running(pid)]
    segs = sorted(n for n in os.listdir(protocol.SHM_DIR)
                  if n.startswith("tpkserve-"))
    if left or alive or segs:
        raise AssertionError(f"fleet stop: left {left}, alive {alive}, "
                             f"segments {segs}\n{said}")
    log(f"PASS fleet clean stop: guardian, router and workers stopped "
        f"({len(pids)} processes over the phase, none alive), no socket, "
        "pidfile or fleet.json left, no tpkserve-* segment; the members' "
        "stdout is /dev/null (fleet.py), ctl said: "
        + "; ".join(said.strip().splitlines()))


def fleet_drive(torch, fl, serve, avatars, args):
    """Steps 1-7 of phase 9."""
    import numpy as np

    from tpukernels_torch import aot
    from tpukernels_torch.serve import router

    pids = set()

    # 1. start, on the card
    used0 = card_memory_used()
    t0 = time.perf_counter()
    fl.ctl("start-fleet", "2", "--wait", "240")
    start_s = time.perf_counter() - t0
    workers = [fl.pid(i) for i in range(2)]
    rpid = fl.pid("router")
    pids.update(workers + [rpid])
    apps = compute_apps()
    cards = {pid: on_card(pid) for pid in workers + [rpid]}
    if not all(cards[w] for w in workers) or cards[rpid]:
        raise AssertionError(f"fleet start: /dev/nvidia* held {cards} "
                             f"(workers {workers}, router {rpid})")
    listed = set(apps) & (set(workers) | {rpid})
    if listed and (not set(workers) <= set(apps) or rpid in apps):
        raise AssertionError(f"fleet start: nvidia-smi compute apps {apps}, "
                             f"workers {workers}, router {rpid}")
    used1 = card_memory_used()
    memory = {str(i): apps.get(w) for i, w in enumerate(workers)}
    log(f"PASS fleet start: {start_s:.2f} s; workers {workers} hold the card "
        f"(/dev/nvidia*), router {rpid} does not; nvidia-smi compute apps "
        + (f"{apps}: worker memory MiB {memory}" if listed else
           f"{apps} (lists none of the fleet's pids: not in this pid "
           "namespace)")
        + f"; the card's memory.used {used0} -> {used1} MiB")

    # 2. the nine avatars through the front socket, both lanes, bitwise
    # phase 7's daemon; each bucket served by its ring home
    avatar = {}
    for key in aot.BENCH_CONFIGS:
        ops, statics, want = avatars[key]
        row = {}
        for lane, shm in (("inline", "0"), ("shm", None)):
            got, row[f"{lane}_ms"] = fleet_send(
                fl.front, key, ops, statics, f"fleet-{key}-{lane}", shm)
            serve_same(torch, f"fleet {key} avatar {lane} vs phase 7's daemon",
                       got, want)
        avatar[key] = row
    routes = {e["request_id"]: e for e in fl.events("serve_route")
              if str(e.get("request_id")).startswith("fleet-")}
    homes = {}
    for key in aot.BENCH_CONFIGS:
        for lane in ("inline", "shm"):
            e = routes[f"fleet-{key}-{lane}"]
            home = router.ring_order(e["bucket"], 2)[0]
            if not e["ok"] or e["worker"] != home or e["spilled_from"] is not None:
                raise AssertionError(f"fleet {key} {lane}: routed {e}, ring "
                                     f"home {home}")
        homes[key] = home
        avatar[key]["worker"] = home
        avatar[key]["bucket"] = e["bucket"]
    log("PASS fleet avatars: nine keys on both lanes bitwise phase 7's "
        "daemon, each on its ring home: " + ", ".join(
            f"{k} -> worker {w} (inline {avatar[k]['inline_ms']:.1f} ms, shm "
            f"{avatar[k]['shm_ms']:.1f})" for k, w in homes.items()))
    # the roles of steps 4-6, from the ring: the wedge and the kill use
    # the avatar of the fewest bytes among those worker 0 serves; the
    # stream beside the kill, the two of the fewest among worker 1's
    def size(k):
        return sum(np.asarray(a).nbytes for a in avatars[k][0])

    on = {w: sorted((k for k, h in homes.items() if h == w), key=size)
          for w in (0, 1)}
    if not on[0] or not on[1]:
        raise AssertionError(f"fleet: the ring leaves a worker idle: {on}")
    roles = {"fault": on[0][0], "side": on[1][:2]}
    log(f"fleet roles: wedge and kill on {roles['fault']} (worker 0), the "
        f"stream beside the kill on {roles['side']} (worker 1)")

    # 3. phase 7's burst through the front
    results, burst_s = serve_burst(torch, fl.front, {k: avatars[k][0] for k in
                                                     SERVE_BURST},
                                   {k: avatars[k][2] for k in SERVE_BURST},
                                   args.seed)
    stats = fl.stats()
    per_worker = [dict((row or {}).get("launches") or {})
                  for row in stats["worker_stats"]]
    launches = {}
    for row in per_worker:
        for k, v in row.items():
            launches[k] = launches.get(k, 0) + v
    idle = [k for k in SERVE_PATH if launches.get(k, 0) <= 0]
    if idle:
        raise AssertionError(f"kernels no fleet worker launched: {idle}")
    allocator = [(row or {}).get("device_memory")
                 for row in stats["worker_stats"]]
    log("fleet workers' caching allocator on the card, MiB (allocated / "
        "reserved): " + ", ".join(
            f"worker {i} {m['allocated'] / 2**20:.1f} / "
            f"{m['reserved'] / 2**20:.1f}" if m else f"worker {i} none"
            for i, m in enumerate(allocator)))
    log("fleet kernels, per worker: " + json.dumps(
        [{k: v for k, v in row.items() if v} for row in per_worker]))
    log(f"PASS fleet path: the workers' launches cover every kernel of the "
        f"daemon's default path ({', '.join(SERVE_PATH)})")
    routes = {e["request_id"]: e for e in fl.events("serve_route")}
    burst = {}
    for key in SERVE_BURST:
        mine = [r for r in results if r[1] == key and not r[4]]
        walls = [r[3] * 1e3 for r in mine]
        split = {}
        for r in mine:
            w = str(routes[r[2]]["worker"])
            split[w] = split.get(w, 0) + 1
        p7 = serve["burst"][key]
        burst[key] = {"n": len(mine), "rejected": sum(r[4] for r in results
                                                      if r[1] == key),
                      "wall_ms_p50": pct(walls, 50),
                      "wall_ms_p99": pct(walls, 99), "per_worker": split,
                      "daemon_wall_ms_p50": p7["wall_ms_p50"],
                      "daemon_wall_ms_p99": p7["wall_ms_p99"]}
        log(f"fleet burst {key}: {len(mine)} requests, client wall p50 "
            f"{burst[key]['wall_ms_p50']:.3f} / p99 "
            f"{burst[key]['wall_ms_p99']:.3f} ms (phase 7's one daemon "
            f"{p7['wall_ms_p50']:.3f} / {p7['wall_ms_p99']:.3f}); per worker "
            f"{split}")
    if any(r[4] for r in results):
        raise AssertionError("fleet burst: rejections at the default queue")
    log(f"PASS fleet burst: {len(results)} requests in {burst_s:.2f} s, 0 "
        "errors, 0 rejections, every answer bitwise phase 7's")

    # 4. drain worker 0 in the middle of a stream, then undrain it with
    # the wedge armed for steps 5 and 6 (its env only)
    drain = fleet_drain(torch, fl, avatars, roles["fault"])
    pids.add(fl.pid(0))
    # 5. the wedge: worker 0 answers `wedged`, the router spills
    wedge = fleet_wedge(torch, fl, avatars, roles["fault"])
    # 6. kill -9 worker 0 while it holds a request
    kill = fleet_kill_worker(torch, fl, avatars, pids, roles)
    # 7. kill the router: the guardian respawns it, the WAL replays
    kr = fleet_kill_router(fl, pids)
    return {"start_s": round(start_s, 3), "worker_memory_mib": memory,
            "card_memory_used_mib": [used0, used1],
            "worker_allocator": allocator,
            "nvidia_smi_lists_fleet": bool(listed), "avatar": avatar,
            "launches": launches, "launches_per_worker": per_worker,
            "burst": burst, "burst_s": burst_s, "drain": drain,
            "roles": roles, "wedge": wedge, "kill_worker": kill,
            "kill_router": kr,
            "pids": sorted(p for p in pids if p)}


def fleet_stream(front, keys, avatars, stop, done, errors, prefix):
    """Requests of ``keys`` in turn through the front socket until
    ``stop``; each answer checked bit for bit against phase 7's."""
    import numpy as np

    from tpukernels_torch.serve import client as serve_client

    try:
        with serve_client.ServeClient(front, timeout_s=300) as c:
            k = 0
            while not stop.is_set():
                key = keys[k % len(keys)]
                ops, statics, want = avatars[key]
                c.next_request_id = f"{prefix}-{k}"
                got = as_tuple(c.dispatch(key, *ops, **statics))
                if not all(np.array_equal(g, w) for g, w in zip(got, want)):
                    errors.append(f"{prefix}-{k} ({key}): differs")
                done.append(k)
                k += 1
    except Exception as e:  # noqa: BLE001 - collected, raised below
        errors.append(repr(e))


def wait_done(done, errors, n, what, timeout=120):
    mark = len(done)
    deadline = time.monotonic() + timeout
    while len(done) < mark + n:
        if errors:
            raise AssertionError(f"fleet {what}: {errors[:3]}")
        if time.monotonic() > deadline:
            raise AssertionError(f"fleet {what}: stalled")
        time.sleep(0.02)


def fleet_drain(torch, fl, avatars, fault_key):
    """Step 4: drain worker 0 while two clients stream phase 7's burst
    kernels (all on worker 0's buckets), then undrain it."""
    stop = threading.Event()
    done, errors = [], []
    threads = [threading.Thread(target=fleet_stream, args=(
        fl.front, SERVE_BURST, avatars, stop, done, errors, f"drain{t}"))
        for t in range(2)]
    for t in threads:
        t.start()
    try:
        wait_done(done, errors, FLEET_DRAIN_MIN, "before the drain")
        t0 = time.perf_counter()
        fl.ctl("drain", "0", "--wait", "60")
        drain_s = time.perf_counter() - t0
        t_drained = time.time()
        wait_done(done, errors, FLEET_DRAIN_MIN, "while drained")
    finally:
        stop.set()
        for t in threads:
            t.join(300)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"fleet drain: {errors[:3]}")
    plan = json.dumps({"wedge_dispatch": {
        "kernel": fault_key, "times": 0,
        "env": {"TPKT_SERVE_WORKER_ID": "0"}}})
    t0 = time.perf_counter()
    fl.ctl("undrain", "0", "--wait", "240", TPKT_FAULT_PLAN=plan,
           TPKT_SERVE_REQUEST_TIMEOUT_S="1")
    undrain_s = time.perf_counter() - t0
    events = fl.events()
    drains = [e for e in events if e["kind"] == "serve_drain"]
    if [(e["phase"], e["worker"]) for e in drains] != [("begin", 0),
                                                       ("undrain", 0)]:
        raise AssertionError(f"fleet drain events: {drains}")
    routes = [e for e in events if e["kind"] == "serve_route"
              and str(e.get("request_id")).startswith("drain")]
    # routed after the drain verb returned (worker 0 stopped) and before
    # the undrain
    window = [e for e in routes if t_drained < e["t"] < drains[1]["t"]]
    if (len(routes) != len(done) or not all(e["ok"] for e in routes)
            or not window or any(e["worker"] == 0 for e in window)):
        raise AssertionError(f"fleet drain: {len(routes)} routes for "
                             f"{len(done)} answers, window {window[:3]}")
    log(f"PASS fleet drain: worker 0 drained in {drain_s:.2f} s while two "
        f"clients streamed; {len(done)} answers bitwise, 0 dropped, "
        f"{len(window)} routed to worker 1 while drained; undrain restarted "
        f"worker 0 in {undrain_s:.2f} s (its {fault_key} dispatches armed "
        "to wedge)")
    return {"answers": len(done), "drained_routes": len(window),
            "drain_s": drain_s, "undrain_s": undrain_s}


def fleet_wedge(torch, fl, avatars, key):
    """Step 5: the armed worker 0 wedges on ``key`` twice, its watchdog
    answers ``wedged``, the router spills to worker 1."""
    ops, statics, want = avatars[key]
    t0 = time.perf_counter()
    got, _ms = fleet_send(fl.front, key, ops, statics, "wedge-1")
    wedge_s = time.perf_counter() - t0
    serve_same(torch, f"fleet {key} past the wedge vs phase 7's daemon", got,
               want)
    events = fl.events()
    spills = [(e["reason"], e["from_worker"], e["to_worker"]) for e in events
              if e["kind"] == "serve_spill"]
    (route,) = [e for e in events if e["kind"] == "serve_route"
                and e.get("request_id") == "wedge-1"]
    if spills != [("wedged", 0, 1)] or route["worker"] != 1:
        raise AssertionError(f"fleet wedge: spills {spills}, route {route}")
    log(f"PASS fleet wedge: {key} wedged on worker 0, spilled to worker 1 "
        f"with reason wedged, answered in {wedge_s:.2f} s")
    return {"answered_s": wedge_s}


def fleet_kill_worker(torch, fl, avatars, pids, roles):
    """Step 6: after the cooldown worker 0 takes the fault key again and
    wedges holding it; ``kill -9`` then, while a client streams two of
    worker 1's buckets. The request is replayed once on worker 1, worker 0 is
    respawned (clean) and smoke-checked on the card."""
    import signal

    import numpy as np

    from tpukernels_torch.serve import client as serve_client

    key = roles["fault"]
    ops, statics, want = avatars[key]
    cool = float(FLEET_ENV["TPKT_ROUTE_COOLDOWN_S"])
    wedged = len([e for e in fl.events("fault_injected")
                  if e.get("fault") == "wedge_dispatch"])
    time.sleep(cool)  # the cooldown of step 5 runs out
    stop = threading.Event()
    done, errors = [], []
    stream = threading.Thread(target=fleet_stream, args=(
        fl.front, roles["side"], avatars, stop, done, errors, "side"))
    res = {}

    def held():
        try:
            res["got"] = fleet_send(fl.front, key, ops, statics,
                                    "killed-1")[0]
        except Exception as e:  # noqa: BLE001 - raised below
            res["err"] = repr(e)

    one = threading.Thread(target=held)
    stream.start()
    one.start()
    try:
        deadline = time.monotonic() + 60
        while len([e for e in fl.events("fault_injected")
                   if e.get("fault") == "wedge_dispatch"]) <= wedged:
            if time.monotonic() > deadline:
                raise AssertionError("fleet kill: worker 0 never held the "
                                     "request")
            time.sleep(0.02)
        victim = fl.pid(0)
        t_kill = time.time()
        os.kill(victim, signal.SIGKILL)
        one.join(300)
        resp = fl.wait(lambda e: e["kind"] == "worker_respawned", 120,
                       "worker_respawned")
        wait_done(done, errors, 2, "beside the kill")
    finally:
        stop.set()
        stream.join(300)
        one.join(1)
    if "err" in res or errors:
        raise AssertionError(f"fleet kill: {res.get('err')} {errors[:3]}")
    serve_same(torch, f"fleet {key} replayed after kill -9 vs phase 7's "
               "daemon", res["got"], want)
    new = fl.pid(0)
    pids.add(new)
    events = fl.events()
    dead = [e for e in events if e["kind"] == "worker_dead"]
    replays = [e for e in events if e["kind"] == "serve_request_replayed"
               and e.get("via") is None]
    served = [e for e in events if e["kind"] == "serve_request"
              and e.get("request_id") == "killed-1"]
    if ([(e["worker"], e["worker_pid"]) for e in dead] != [(0, victim)]
            or [(e["request_id"], e["from_worker"], e["to_worker"])
                for e in replays] != [("killed-1", 0, 1)]
            or [(e["worker_id"], e["replayed"]) for e in served] != [("1", 1)]
            or resp[0]["worker"] != 0 or not new or new == victim
            or not on_card(new)):
        raise AssertionError(f"fleet kill: dead {dead}, replays {replays}, "
                             f"served {served}, respawned {resp}, pid {new}")
    # the respawned worker's first dispatch (its rejoin smoke) against
    # warm ones of the same bucket, straight at its socket
    x = (np.arange(64) % 7).astype(np.int32)
    with serve_client.ServeClient(fl.worker_sock(0), timeout_s=120) as c:
        for i in range(5):
            c.next_request_id = f"warm-{i}"
            c.dispatch("scan", x)
    spans = [e for e in fl.events("span")
             if e.get("name") == "serve/scan/dispatch/scan"]
    smoke = [e for e in spans
             if str(e.get("request_id")).startswith("fleet-smoke-0-")]
    warm = [e["wall_s"] * 1e3 for e in spans
            if str(e.get("request_id")).startswith("warm-")]
    if len(smoke) != 1 or smoke[0]["pid"] != new or len(warm) != 5:
        raise AssertionError(f"fleet kill: smoke spans {smoke}, warm {warm}")
    first_ms, warm_ms = smoke[0]["wall_s"] * 1e3, pct(warm, 50)
    out = {"down_s": resp[0]["down_s"], "via": dead[0]["via"],
           "respawn_to_rejoin_s": round(resp[0]["t"] - t_kill, 3),
           "first_dispatch_ms": first_ms, "warm_dispatch_ms_p50": warm_ms,
           "side_answers": len(done)}
    log(f"PASS fleet kill -9 worker 0 (pid {victim}) holding {key}: "
        f"worker_dead via {dead[0]['via']}, one replay on "
        f"worker 1 (answer bitwise phase 7's), {len(done)} side requests on "
        f"worker 1 all bitwise, 0 dropped; respawned as pid {new} on the "
        f"card, down {resp[0]['down_s']} s; its first dispatch (the rejoin "
        f"smoke, scan of 64) {first_ms:.3f} ms against a warm p50 "
        f"{warm_ms:.3f} ms")
    return out


def fleet_kill_router(fl, pids):
    """Step 7: the guardian, carrying a ``kill_router`` plan for the routers
    it spawns; ``kill -9`` the router, then the respawned router kills
    itself at its third accepted request (durable in the WAL, not yet
    forwarded). Two clients ride through; one delivery a request_id."""
    import random
    import signal

    import numpy as np

    from tpukernels_torch.serve import client as serve_client

    once = os.path.join(fl.root, "kill_router.once")
    plan = json.dumps({"kill_router": {"on_call": 3, "once_file": once}})
    fl.ctl("guardian", "--wait", "60", TPKT_FAULT_PLAN=plan)
    gpid, first = fl.pid("guardian"), fl.pid("router")
    pids.add(gpid)
    os.kill(first, signal.SIGKILL)
    fl.wait(lambda e: e["kind"] == "router_respawned", 60, "router_respawned")
    pids.add(fl.pid("router"))
    x = (np.arange(256) % 11).astype(np.int32)
    want = np.cumsum(x, dtype=np.int64).astype(np.int32)
    ok, fail = [], []

    def burst(tid):
        jit = random.Random(1000 + tid)
        with serve_client.ServeClient(fl.front, timeout_s=300,
                                      tenant=f"t{tid}") as cli:
            for k in range(FLEET_KR_N):
                try:
                    cli.next_request_id = f"rk-{tid}-{k}"
                    got = serve_client.dispatch_with_backpressure(
                        cli, "scan", (x,), {}, jitter=jit)
                    if not np.array_equal(got, want):
                        raise AssertionError("wrong answer")
                    ok.append((tid, k))
                except Exception as e:  # noqa: BLE001 - raised below
                    fail.append((tid, k, repr(e)))
                time.sleep(0.05)

    t0 = time.perf_counter()
    with knobs(TPKT_CLIENT_RECONNECT_S="60", TPKT_SERVE_SHM="0"):
        threads = [threading.Thread(target=burst, args=(t,))
                   for t in range(FLEET_KR_THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
    burst_s = time.perf_counter() - t0
    deadline = time.monotonic() + 60
    while len(fl.events("router_respawned")) < 2:
        if time.monotonic() > deadline:
            raise AssertionError("fleet kill router: no second "
                                 "router_respawned within 60 s")
        time.sleep(0.05)
    pids.add(fl.pid("router"))
    events = fl.events()
    dead = [e for e in events if e["kind"] == "router_dead"]
    respawned = [e for e in events if e["kind"] == "router_respawned"]
    fired = [e for e in events if e["kind"] == "fault_injected"
             and e.get("fault") == "kill_router"]
    replays = [e for e in events if e["kind"] == "serve_request_replayed"
               and e.get("via") == "wal"]
    deduped = [e for e in events if e["kind"] == "serve_request_deduped"]
    per = {}
    for e in events:
        if (e["kind"] == "serve_request"
                and str(e.get("request_id")).startswith("rk-")):
            per[e["request_id"]] = per.get(e["request_id"], 0) + 1
    want_ids = {f"rk-{t}-{k}": 1 for t in range(FLEET_KR_THREADS)
                for k in range(FLEET_KR_N)}
    if (fail or len(ok) != len(want_ids) or not os.path.exists(once)
            or len(dead) != 2 or len(respawned) != 2 or len(fired) != 1
            or not replays or per != want_ids
            or any(e.get("ok") is False for e in replays)):
        raise AssertionError(
            f"fleet kill router: fail {fail[:3]}, ok {len(ok)}, dead {dead}, "
            f"respawned {respawned}, fired {fired}, replays {replays}, "
            f"deliveries {per}\n{fl.logs()[-4000:]}")
    log(f"PASS fleet kill router: kill -9 router {first}, then kill_router "
        f"at the respawned router's third request: 2 router_dead, 2 "
        f"router_respawned (down {[e['down_s'] for e in respawned]} s), "
        f"{len(replays)} WAL replay(s) ({len(deduped)} answered from the "
        f"worker's replay memo), {len(ok)} requests from "
        f"{FLEET_KR_THREADS} clients in {burst_s:.2f} s, 0 failed, exactly "
        "one serve_request per request_id")
    return {"down_s": [e["down_s"] for e in respawned],
            "wal_replays": len(replays), "deduped": len(deduped),
            "requests": len(ok), "burst_s": burst_s}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parent", metavar="DIR",
                    help="a checkout (of the parent commit) whose "
                         "tpkt_nbody_forces phase 3 holds this one's "
                         "bitwise against")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import tpukernels_torch  # noqa: F401  (fails outside the repository)

    # the integrity guard's state and the journal live in a temporary
    # directory; the guard runs as shipped (no plan, full, sample 64)
    state = tempfile.mkdtemp(prefix="tpkt_smoke_")
    for var in ("TPKT_FAULT_PLAN", "TPKT_INTEGRITY", "TPKT_INTEGRITY_SAMPLE",
                "TPKT_INTEGRITY_QUARANTINE_AFTER", "TPKT_TRACE"):
        os.environ.pop(var, None)
    os.environ["TPKT_INTEGRITY_DIR"] = os.path.join(state, "integrity")
    os.environ["TPKT_HEALTH_JOURNAL"] = os.path.join(state, "health.jsonl")
    try:
        return run_all(torch, args)
    finally:
        # the metrics exit flush must not write into the removed directory
        os.environ.pop("TPKT_HEALTH_JOURNAL", None)
        shutil.rmtree(state, ignore_errors=True)


def run_all(torch, args):
    from tpukernels_torch.kernels import TPU_KERNELS

    card = phase_toolchain(torch)
    peaks = peaks_for(torch.cuda.get_device_name(0))
    nbody = phase_build()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    errs = phase_kernels(torch, gen, args.parent)
    launches, of_record = phase_main_path(torch, gen)
    guarded = phase_guarded(torch, of_record, peaks)
    del of_record
    times = phase_times(torch, gen, peaks, nbody)
    guard_costs(guarded, times)
    c_entry = phase_c_entry(torch, times)
    avatars = {}
    serve = phase_serve(torch, times, c_entry["rates"], args, avatars)
    dist = phase_dist(torch, times, peaks, args)
    fleet = phase_fleet(torch, serve, avatars, args)
    del avatars

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
                "serve_launches": serve["launches"].get(name, 0),
                "fleet_launches": fleet["launches"].get(name, 0),
                "dist_launches": dist["nccl"]["launches"].get(name, 0),
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
        "serve_launches": serve["launches"].get("sgemm_prep", 0),
        "fleet_launches": fleet["launches"].get("sgemm_prep", 0),
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

    # the distributed forms' entry: its launches on phase 8a's path
    # (NCCL, world 1), its times at all bodies from all, with the psum's
    # and the ring's shapes at four ranks beside
    fij = dist["nccl"]["forces_ij"]
    kernels.append({
        "name": "nbody_forces_ij", "route": "cuda", "source": nb.port_source,
        "replaces": nb.where,
        "launches": dist["nccl"]["launches"]["nbody_forces_ij"],
        "serve_launches": serve["launches"].get("nbody_forces_ij", 0),
        "fleet_launches": fleet["launches"].get("nbody_forces_ij", 0),
        "max_abs_err": errs["nbody_forces_ij"], "ms": fij[0]["ms"],
        "plain_ms": fij[0]["plain_ms"], "bound_ms": fij[0]["bound_ms"],
        "bound_by": fij[0]["bound_by"], "library_ms": None,
        "shape": [fij[0]["ni"], fij[0]["nj"]],
        "per_shape": [{k: r[k] for k in ("ni", "nj", "ms", "bound_ms")}
                      for r in fij[1:]],
        "gloo_launches_rank0": dist["gloo"]["launches"]["nbody_forces_ij"]})

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
