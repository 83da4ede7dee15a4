#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``tpukernels_torch``) on one GPU.

    python3 chip_smoke.py [--seed N] [--parent DIR]

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
   entry built from DIR), N-body at 0 and -1 steps giving new tensors
   with the inputs' values, and the ij entry at the distributed forms'
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
   alone, dispatch with the guard and the compile discipline off, with
   the guard off, as a tripwire and full, host clock, in turns), each
   key's first-trust canary split into its
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
   look-back, for the 2-D Jacobi every fusion depth k, for the 3-D the
   default k and its neighbours and every ring depth (the whole space is
   the tuning runner's), for both the HBM floor of their passes
   (``pass_bytes_ms``), for the 3-D the halo's redundancy at each k and
   each instantiation's registers, and for N-body its forces launch
   alone, every (r, s) at the default tiles and every (bi, bj) at the
   default (r, s), the SM clock under load and the issue floor it gives
   (``issue_floor_ms``). ``torch.bincount`` reads its input's max back to
   the host, so no graph captures it: its device time (histogram, scan +
   histogram) is the sum of the device events ``torch.profiler`` records.
   It prints the wall of each part of the phase and of the phase.

6. runs the repository's unchanged C drivers (``c/``) on the port: builds
   the port's CPython shim (``csrc/tpkt_shim.c``) and the drivers into
   ``tpukernels_torch/_build/``, runs ``test_shim_abi`` and every
   single-device row of ``c/run_all.sh`` with ``--device=tpu --check``
   and ``TPU_KERNELS_SHIM`` naming the shim (each must print its own
   CHECK PASS), then each driver at its configuration of record with
   ``--check --reps=3`` (four children at once, so each driver's own
   ``time_ms`` shares the host and is printed as such; SGEMM also at
   depth 3 and scan + histogram also fused), and proves from each
   child's journal
   (``TPKT_TRACE``) that every call ran on the card through
   ``registry.dispatch`` and that both first-trust canaries fell in the
   checked call; an injected ``corrupt_output`` at site ``capi`` must fail
   the C program's own check and ``fail_capi`` the program (these two
   beside the run_all rows, none of them timed). It prints the
   host<->card copy rates (pageable and pinned, 64 MiB) and one
   ``{"c_entry": ...}`` JSON line a configuration: the C path's cost in
   this process (``capi.run_from_c``, one at a time, and its parts)
   beside phase 5's wrapper ``ms`` (``gap_ms``), the driver's shared-host
   ``time_ms`` and metric, the bytes the adapter copies each way and
   their transfer bound.

7. runs the serving daemon (``python -m tpukernels_torch.serve``) on the
   card with no knob but its state paths and ``TPKT_TRACE=1``, and drives
   it with the port's own client: the nine keys at their avatars
   (``aot.BENCH_CONFIGS``), each from a seeded generator, on the inline
   and the shm lane, bit for bit against ``registry.dispatch`` of the
   same operands in this process and against the oracle; one request
   under its avatar for SAXPY, scan and SGEMM (padded up, cut back); a
   seeded Poisson burst of 120 SAXPY / scan / SGEMM requests from two
   client threads, with per kernel the client's p50/p99, batch sizes,
   queue waits, rejections (none), the journal's spans beside phase 5's
   wrapper ms and the operand and result bytes against phase 6's copy
   rates; the daemon's launch counts (every kernel of its default path
   must launch); the first request of each bucket against the warm
   ones; a second daemon whose first scan dispatch wedges (requeued once,
   classified at site ``serve``, answered right); ``vector_add --check``
   through the port's shim with ``TPKT_SERVE_SOCKET`` (served by the
   daemon, under its pid); SIGTERM (rc 0, socket and pidfile gone,
   ``serve_stop``); and that neither daemon built a library. The
   daemon's ``device_inventory`` stamp is read back from its journal.
   First of all (step 9) it drives a third daemon, started with the
   other two, at ``TPKT_SERVE_MESH=2``: the mesh tier, the daemon and
   one follower rank on the card over host-staged gloo. Three requests
   over their avatars (scan 2^24 and stencil2d 8192^2 x 8 bit for bit,
   N-body 2^17 within rtol 5e-4 / atol 5e-5 of the single-device
   dispatch in this process, whose answers it makes while the daemon
   starts), their journal fields (``mesh_shape [2]``, a ``|mesh2``
   bucket, ``bucketed`` false, a ``dispatch/<key>`` span with ``mesh``);
   then the follower SIGKILLed while a histogram over its avatar is in
   flight: that request's error reply, an in-avatar scan answered
   meanwhile, the rebuilt group and the next mesh request right; then
   its clean stop with no follower left. It prints each request's
   client wall and spans beside the single-device ms, the bytes
   broadcast and host-staged, the follower's start, the rebuild's
   seconds and the tier's wall (start to stop, against 30 s), none of
   them judged. It prints one ``{"serve": ...}`` JSON line (with
   ``tier``); each kernel entry gains ``serve_tier_launches``.

8. runs the distributed layer (``tpukernels_torch.parallel``): (a) one
   rank on NCCL (a group of one: NCCL takes one rank a card), the
   bandwidth sweeps 1 KiB-64 MiB (allreduce and ppermute; the n = 1
   copy rate), the sweep's CLI, whose probed ``device_inventory`` stamp
   must read the card (platform ``cuda``, its device kind, not fake),
   and whose artifact (``obs/scaling.py``) must be written with that
   stamp,
   ``allreduce_sum`` at 2^20 floats, then each distributed
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
   bytes host-staged a call; then ``registry.dispatch_mesh`` for every
   ``MESH_KERNELS`` key at the configurations of record, its launches
   counted after a warm-up that spends the guard's first-trust canaries,
   held against the single-device wrappers (bitwise; N-body within its
   band of its plain version), each one's ms beside the entry's and phase
   5's wrapper's; and the overlap probe, both ops at depth 1 and 2 (two
   timed reps a point), its artifact flagged ``shared-card``); (c) the
   unchanged C drivers as four rank processes on c/run_all.sh's mesh
   rows (three rows at once) and ``allreduce_bench`` at ``TPKT_MESH=1``
   on NCCL, each printing CHECK PASS; (d) ``python -m
   tpukernels_torch.parallel.weak_scaling --sizes "1 4" --reps 1`` and
   ``python -m tpukernels_torch.dryrun 4`` on the card, the two at once
   and beside (c), each rc 0, their walls (never judged) and
   efficiencies printed, their artifacts flagged ``shared-card``, and
   every artifact of the phase judged (``analyze_repo``): a gating
   verdict fails the phase. It prints one ``{"dist": ...}`` JSON line.

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
   one ``serve_request`` a request_id. After (3), ``python -m
   tpukernels_torch.serve.ctl top --once`` must exit 0 with a row for
   each worker, each with requests served. (8) ``stop-fleet``: no member, socket,
   pidfile, fleet.json or ``tpkserve-*`` segment left; no library built.
   The router's and the workers' ``device_inventory`` stamps are read
   back from the fleet's journal. It prints one ``{"fleet": ...}`` JSON
   line; each kernel entry gains ``fleet_launches``.

10. runs the compile discipline (``tpukernels_torch.aot``): ``python -m
   tpukernels_torch.prewarm --check`` in processes of their own over the
   libraries phase 2 built, with a fresh manifest: every key a miss,
   then every key a hit, then under ``TPKT_SGEMM_DEPTH=3
   TPKT_SCANHIST_FUSE=on`` new keys that load B2's and B11's libraries,
   and ``TPKT_AOT_CACHE=0`` exiting 1; each key's cold and warm wall and
   each library's build seconds (phase 2), registers, shared memory and
   spills. In a process with a fresh memo (``aot_child``) every key is
   precompiled and then dispatched at its avatar, loading no library the
   precompile had not; a ``corrupt_output`` on histogram drops its
   manifest rows and no other, and the next dispatch is an ``aot_miss``
   and exact. It prints what the memo adds to a dispatch (phase 4b's
   turns) and one ``{"aot": ...}`` JSON line.

11. runs the serving control loop: (a) ``python -m
   tpukernels_torch.loadgen --mix all --shapes record --verify`` in a
   process of its own, open loop on the card, at least 20 scheduled
   requests a key: each key's p50/p99, the generator's lateness, the
   verdicts against the ``nvidia_h100_80gb_hbm3|record`` row of
   ``obs/slo.py`` (``no_target`` for a key the row does not hold); (b)
   one daemon driven by ``loadgen --serve`` with SAXPY, scan and SGEMM
   at 5 requests a second for 10 s (p50/p99 beside phase 7's closed-loop
   burst, ``slo.dropped``, the trace budget); every answer bitwise the
   first of its key, and that one bitwise this process's dispatch of the
   same ones, held against the oracle; (c) traffic at shapes that pad
   under the default table, ``python -m
   tpukernels_torch.serve.optimize propose`` (a split) and ``canary`` at
   a fixed seed, each side twice in the order incumbent, candidate,
   candidate, incumbent, every daemon on the card; on promotion a running
   daemon's ``undrain`` picks the new table up and a request at the
   split shape lands there with ``pad_frac`` 0, bitwise; on rejection
   the incumbent table file is unchanged; (d) ``python -m
   tpukernels_torch.prewarm --check --order traffic`` over (c)'s journal
   puts SAXPY and the scan first. It prints one ``{"loop": ...}`` JSON
   line.

12. runs the fleet's operations layer: (a) ``python -m
   tpukernels_torch.serve.chaos --seed 1 --events 5 --workers 2`` on the
   card, its journal and state in a temporary directory, must exit 0
   (every invariant after every event: convergence, readable artifacts,
   no unmarked duplicate dispatch, 100 % goodput, no drop, no leak, and
   ``obs.report --check`` over its own journal); it prints the schedule,
   the requests ok, within their deadline and dropped, each event's
   seconds to convergence, the workers' scan launches (the B8 kernel on
   the campaign's path, from the fleet's ``stats`` just before teardown),
   the report's lines and the card's ``memory.used`` before and after;
   (b) the readers over this run's own evidence, the journals of phases
   7, 9 and 11 and the state of phases 8 and 11: ``python -m
   tpukernels_torch.obs.rollup --date <today>`` (rc 0),
   ``python -m tpukernels_torch.obs.report --check`` (rc 0, or 1 with
   its findings printed: phase 11's SLO verdicts judge and never fail
   the script) and ``python -m tpukernels_torch.obs.trace_report
   --slowest 5`` over phase 11's served journal (rc 0). It prints one
   ``{"ops": ...}`` JSON line; each kernel entry gains
   ``chaos_launches``.

13. runs the revalidation supervisor on the card, only through ``python
   -m tpukernels_torch.revalidate`` processes, its checkpoint, stamps,
   journal, lock and every state directory in a temporary directory:
   (a) ``--plan`` (rc 0) prints the production queue's order; (b) a
   queue of production steps, cut in duration only (``prewarm_all``
   with ``--bench saxpy_gb_s`` for ``--bench all``, its one ``bench
   --prewarm`` child journaled ok, ``slo_probe`` at 10 s,
   ``integrity_envelopes``,
   ``rollup_daily``, ``fleet_fsck``, ``obs_check``): a first run with
   ``kill_supervisor`` armed at ``slo_probe`` dies by SIGKILL after the
   prewarm went green, and a second run without the plan ends green (rc
   0) without running the prewarm again and with ``slo_probe`` run
   again; (c) stub steps (``sleep 60`` under a 3 s timeout): with the
   live probe (a torch child on the card) the step is ``slow``, never
   ``wedged``, and the queue goes on; with ``"probe": ["dead", "dead"]``
   it is ``wedged`` twice, then quarantined, and the next run moves on
   to the next step. Then the card's ``memory.used`` must be within 256
   MiB of before, ``obs.report`` over the phase's journal must print the
   supervisor section with these steps and outcomes, and
   ``obs.health_report`` over it must exit 0. Each kernel's launches by
   the step children come from the exit ``metrics`` events in that
   journal (``kernel.launches.<name>``). It prints one
   ``{"supervisor": ...}`` JSON line; each kernel entry gains
   ``supervisor_launches``.

14. runs the port's jax-free tools on the card, as child processes with
   every state directory in a temporary directory: (a) ``python -m
   tpukernels_torch.profile`` traces SGEMM 1024^3 (a chain of 50
   dependent calls, three times) and the 2-D Jacobi 4096^2 (64 sweeps at
   k = 8, three times) with ``torch.profiler`` and summarizes each trace
   (``obs/profile_summary.py``); it prints each summary's device-plane
   busy % beside its prediction and its top five kernels with the port's
   source of each, and fails when a summary has no device plane or its
   top kernel is not the port's own (the SGEMM ring or its operand
   preparation for the chain, the 2-D pass for the stencil); (b)
   ``python -m tpukernels_torch.cgate --fuzz 1`` at ``TPKT_FUZZ_SEED``
   42: one extent set of the six C drivers drawn from
   ``tools/fuzz_c.sh``'s ranges, each at ``--device=omp`` and through the
   port's shim on the card, every row checked; it prints each row's
   extents, rc and wall and the kernels the C hosts launched (their exit
   ``metrics`` events), and fails on any ``FUZZ FAIL`` or a kernel of
   the drivers' path launched no time. It prints the phase's wall and
   one ``{"tools": ...}`` JSON line.

15. runs the suite's own bench and the tuning loop on the card, as child
   processes with every state directory in a temporary directory: (a)
   ``python -m tpukernels_torch.bench``, its seven metrics each a ``--one``
   child timed as a slope (SGEMM, SAXPY, SAXPY stream and scan +
   histogram over R calls captured in a CUDA graph, the stencils and
   N-body over their own iteration count); it prints the line, each
   metric's graph and host-issued value beside phase 5's number for the
   same work (no gate), its ceiling and each capture's seconds and graph
   pool peak, and fails if a metric is null, invalidated or over its
   ceiling; (b) ``python -m tpukernels_torch.autotune --kernel
   scan_histogram --quick`` (``fuse`` off, the control, and on) against a
   tuning cache of its own, then one ``bench --one scan_hist_melem_s``
   on that cache, which must journal ``tuning_resolved`` with the
   promoted entry (and none when nothing was promoted); the repository's
   own tuning cache must be untouched; (c) the revalidation queue's
   ``knob_sanity`` body, its fuse loop cut to ``on`` (fuse off is (a)'s
   metric): the fused scan + histogram and the ``float32`` SGEMM, each
   a number at or under its ceiling, its kernel launched; (d) the
   evidence layer on (a)'s line: the line persisted as an artifact in a
   temporary ``TPKT_BENCH_DIR``, promoted by ``python -m
   tpukernels_torch.promote_baseline`` into a copy of
   ``baseline_h100.json`` without its medians, then the gate
   (``bench.check_regression``, which ``bench --check-regression`` runs;
   in this process, as the promotion) must give rc 0 on the line, 1 with
   one metric at 0.8x and 2 with one metric null; the queue's ``bench``
   step under ``TPKT_BENCH_SKIP_CAPTURED=1`` must run one ``--one`` child
   (SGEMM), carry the six others and pass the union gate; ``obs.report
   --check`` and ``--roofline`` over that directory print each metric's value
   beside its H100 roofline and its ceiling; (a)'s line against the
   committed ``baseline_h100.json`` is printed with its rc, judged and
   never failing. Each kernel's launches by the bench's processes come
   from their exit ``metrics`` events. It prints the walls of (d) and of
   the phase and one ``{"bench": ...}`` JSON line; each kernel entry
   gains ``bench_launches``.

Every Python it starts shares one bytecode cache under its temporary
directory (:func:`share_bytecode`). It is the reaper of its children's
orphans: after each of phases 6 to 15 it logs any process still under it
(``LEFTOVER after phase N``, on stderr), and at its end, pass or fail, it
stops and reaps every process left under it (:func:`stop_leftovers`).

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
import io
import json
import os
import re
import shutil
import signal
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
# where phases 7-11 leave their journals and state for phase 12's readers
# (set by main, under its temporary directory)
EVIDENCE = {}


def keep_journal(path):
    """Append a phase's journal to the run's combined journal of today
    (phase 12's readers)."""
    if not EVIDENCE or not os.path.exists(path):
        return
    d = os.path.join(EVIDENCE["dir"], "journal")
    os.makedirs(d, exist_ok=True)
    day = time.strftime("%Y-%m-%d")
    with open(path) as src, open(os.path.join(d, f"health_{day}.jsonl"),
                                 "a") as dst:
        shutil.copyfileobj(src, dst)


def keep(src, name):
    """Copy a phase's file or state directory into the run's evidence as
    ``name``."""
    if not EVIDENCE or not os.path.exists(src):
        return
    dst = os.path.join(EVIDENCE["dir"], name)
    if os.path.isdir(src):
        shutil.copytree(src, dst, dirs_exist_ok=True)
    else:
        shutil.copy(src, dst)


def log(msg=""):
    print(msg, flush=True)


def warn(msg):
    print(msg, file=sys.stderr, flush=True)


def share_bytecode(prefix):
    """One bytecode cache for this process and every Python it starts
    (``PYTHONPYCACHEPREFIX``; ``PYTHONDONTWRITEBYTECODE`` dropped): the
    first start compiles torch's ~800 modules and writes them there, the
    others read them. Where the environment forbids bytecode files and
    site-packages cannot hold them, each of the script's Python starts
    (children, daemons, the C hosts' embedded interpreters) would compile
    them from source again: about 3 s a start on the H100's host."""
    os.environ["PYTHONPYCACHEPREFIX"] = prefix
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    sys.pycache_prefix = prefix
    sys.dont_write_bytecode = False


# prctl(2): orphans of this process's descendants come back to it
PR_SET_CHILD_SUBREAPER = 36


def become_subreaper():
    """Make the script the reaper of its descendants' orphans (a daemon's
    workers, a killed supervisor's step, a process in a session of its
    own), so that :func:`descendants` finds every process it started."""
    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(PR_SET_CHILD_SUBREAPER, 1, 0, 0, 0) != 0:
        warn(f"chip_smoke: prctl(PR_SET_CHILD_SUBREAPER) failed, errno "
            f"{ctypes.get_errno()}: an orphan of a child may escape the "
            "end's sweep")


def descendants():
    """``{pid: (state, command line)}`` of every process under this one,
    zombies included, read from ``/proc``."""
    parent, state = {}, {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        parent[int(d)], state[int(d)] = int(fields[1]), fields[0]
    under, todo = {}, [os.getpid()]
    while todo:
        p = todo.pop()
        for c in (c for c, pp in parent.items() if pp == p):
            try:
                with open(f"/proc/{c}/cmdline", "rb") as f:
                    cmd = f.read().replace(b"\0", b" ").decode(
                        errors="replace").strip()
            except OSError:
                cmd = "?"
            under[c] = (state[c], cmd[:200])
            todo.append(c)
    return under


def report_leftovers(after):
    """Log the processes still under the script ``after`` a phase (each
    phase stops what it starts); the list, empty when none is left."""
    left = {p: v for p, v in descendants().items() if v[0] != "Z"}
    if left:
        warn(f"LEFTOVER after {after}: {len(left)} process(es) still "
            "running: " + "; ".join(f"{p} {cmd}"
                                    for p, (_s, cmd) in sorted(left.items())))
    return sorted(left)


def stop_leftovers():
    """The end's sweep: SIGTERM to every process still under the script,
    SIGKILL to what is left 5 s later, then every zombie child reaped, so
    that the script leaves no process behind."""
    left = report_leftovers("the script's end")
    for sig in (signal.SIGTERM, signal.SIGKILL):
        for p in left:
            with contextlib.suppress(OSError):
                os.kill(p, sig)
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and any(
                v[0] != "Z" for v in descendants().values()):
            time.sleep(0.1)
        left = [p for p, v in descendants().items() if v[0] != "Z"]
    while True:  # orphans re-parented here are reaped by no one else
        try:
            if os.waitpid(-1, os.WNOHANG)[0] == 0:
                break
        except ChildProcessError:
            break
    if left:
        warn(f"chip_smoke: {len(left)} process(es) survived SIGKILL: {left}")


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


def profiled_device_ms(fn, calls):
    """Device time of one call of ``fn`` for a call a CUDA graph cannot
    capture: the durations of the kernels, copies and fills
    ``torch.profiler`` records over ``calls`` calls, summed, after one
    call outside the window. None when the profiler saw no device
    event."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / calls / 1e3 if us else None


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


# each library's nvcc seconds in phase 2 (phase 10 prints them)
BUILD_SECONDS: dict = {}


def phase_build():
    log("== phase 2: build")
    from tpukernels_torch import _build

    t0 = time.perf_counter()
    secs = _build.build()
    wall = time.perf_counter() - t0
    BUILD_SECONDS.update(secs)
    for name, s in secs.items():
        log(f"built {name}.cu in {s:.1f} s")
    log(f"build wall: {wall:.1f} s ({len(secs)} compiled, "
        f"{len(_build.SOURCES) - len(secs)} already built)")
    for name in _build.SOURCES:
        rep = _build.ptxas_report(name)
        if rep is None:
            continue
        stores, loads = rep["spill_stores"], rep["spill_loads"]
        log(f"ptxas {name}: {rep['kernels']} kernels, registers "
            f"{rep['registers_min']}..{rep['registers']} a thread, "
            f"spill stores {stores} B, spill loads {loads} B, "
            f"{rep['wgmma_serialisation']} wgmma serialisation warnings")
        # the Jacobi wavefronts keep every level in registers, N-body its
        # i-bodies and sums
        if name in _build.SPILL_FREE and (stores or loads):
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
    # no step (steps <= 0, the reference's empty fori_loop): the inputs'
    # values in new tensors, never the caller's own
    for steps in (0, -1):
        out = NB.nbody_step(*b, steps=steps)
        shared = {t.data_ptr() for t in b} & {t.data_ptr() for t in out}
        check_exact(f"nbody steps={steps} vs its inputs", stacked(out),
                    stacked(tuple(b[:6])))
        if shared:
            raise AssertionError(f"nbody steps={steps} returned an input")
    log("PASS nbody steps 0 and -1: new tensors, the inputs' values")
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
# itself), registry.dispatch with the guard and the compile discipline
# off (bare: TPKT_INTEGRITY=0 TPKT_AOT_CACHE=0), then with the guard off
# (TPKT_INTEGRITY=0; off - bare is the compile discipline's memo), as a
# tripwire and full
GUARD_TURNS = ("wrapper", "synced", "bare", "off", "tripwire", "full",
               "full", "tripwire", "off", "bare", "synced", "wrapper")
GUARD_KNOB = {"bare": "0", "off": "0", "tripwire": "tripwire", "full": None}
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
                with knobs(TPKT_INTEGRITY=GUARD_KNOB.get(mode),
                           TPKT_AOT_CACHE="0" if mode == "bare" else None):
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
            f"synchronised {c['synced']:.4f}, dispatch bare "
            f"{c['bare']:.4f} (compile discipline's memo "
            f"{(c['off'] - c['bare']) * 1e3:.2f} us a call), "
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
    walls, last = {}, [time.perf_counter()]

    def lap(part):  # the wall of each part of the phase
        now = time.perf_counter()
        walls[part] = now - last[0]
        last[0] = now

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
    lap("saxpy")

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
    lap("sgemm 1024^3 rows")
    out.update(sgemm_times(torch, gen, peaks))
    lap("sgemm depth/order/tile sweep")
    out.update(sgemm_prep_times(torch, gen, peaks))
    out["sgemm[float32]"]["contract_share"] = float32_by_six_bf16(torch, gen)
    lap("sgemm prep and float32 share")

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
    lap("jacobi2d row")
    # every fusion depth the kernel takes: the default is the fastest
    # two calls a k: phase 15a's stencil2d_mcells_s times the default k
    # within 3 % of this row
    row["per_k_ms"] = {k2: time_ms(lambda: J.jacobi2d(x, iters, k=k2), 2,
                                   warmup=1)
                       for k2 in range(1, J.HALO_MAX + 1)}
    out["jacobi2d"] = row

    canary("jacobi2d canary", J.jacobi2d, J.jacobi2d_plain, (40, 200), 4,
           kk, 5)
    lap("jacobi2d per_k and canary")

    n3, iters = STENCIL3D_N, STENCIL3D_ITERS
    x = randn(n3, n3, n3)
    k3 = J.resolve_k(None, 3)
    row = {
        "shape": [n3] * 3, "iters": iters, "k": k3,
        "depth": J.resolve_depth(),
        # 5 calls: phase 15a's stencil3d_mcells_s agrees within 3 %
        "ms": time_ms(lambda: J.jacobi3d(x, iters), 5),
        "plain_ms": time_ms(lambda: J.jacobi3d_plain(x, iters), 2, warmup=1),
        "library_ms": None,
        "launches_per_call": len(J.passes(iters, k3)),
    }
    row["bound_ms"], row["bound_by"] = bound(
        8 * n3 ** 3, 6 * (n3 - 2) ** 3 * iters, fp32, bw)
    row["pass_bytes_ms"] = 8 * n3 ** 3 * row["launches_per_call"] / bw * 1e3
    lap("jacobi3d row")
    # the default k beside its neighbours, and every ring depth, three
    # calls each: the whole (k, depth) space is the tuning runner's
    # (python -m tpukernels_torch.autotune --kernel stencil3d)
    row["per_k_ms"] = {kk3: time_ms(lambda: J.jacobi3d(x, iters, k=kk3), 3)
                       for kk3 in (k3 - 1, k3, k3 + 1)
                       if 1 <= kk3 <= J.HALO3D_MAX}
    row["per_depth_ms"] = {
        dd: time_ms(lambda: J.jacobi3d(x, iters, depth=dd), 3)
        for dd in range(1, J.RING_MAX + 1)}
    row["halo_redundancy"] = {kk3: stencil3d_redundancy(J, n3, kk3)
                              for kk3 in range(1, J.HALO3D_MAX + 1)}
    row["registers"] = jacobi3d_registers()
    out["jacobi3d"] = row
    del x
    canary("jacobi3d canary", J.jacobi3d, J.jacobi3d_plain, (8, 24, 132), 2,
           k3, 6)
    lap("jacobi3d per_k, per_depth and canary")

    out["nbody"] = nbody_times(torch, NB, gen, peaks, nbody)
    lap("nbody")
    out.update(scan_times(torch, gen, peaks))
    lap("scan")

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
            if r.get("library_device_how", "graph") != "graph":
                extra += f" ({r['library_device_how']})"
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
    log("phase 5 part walls: " + ", ".join(f"{k} {v:.1f} s"
                                           for k, v in walls.items()))
    return out


# the N-body sweep: i-bodies a thread, groups a block, i-bodies a
# block, j-bodies a tile (a block's)
NBODY_SWEEP = {"r": (2, 4), "s": (1, 2, 4, 8), "bi": (128, 256, 512),
               "bj": (512, 1024, 2048)}


def sm_clock_mhz(torch, fn, calls=300, samples=3):
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

    t_row = time.perf_counter()
    row = {
        "n": n, "steps": 1, "bi": bi, "bj": bj, "r": plan.r, "s": plan.s,
        "threads": plan.threads,
        # 5 calls: phase 15a's nbody_ginter_s agrees within 3 %
        "ms": time_ms(lambda: NB.nbody_step(*b), 5),
        "plain_ms": time_ms(lambda: NB.nbody_plain(*b), 1, warmup=1),
        "library_ms": None,
        "launches_per_call": 1,
        # the forces launch alone, without the six integration ops
        "forces_ms": time_ms(forces(plan), 5),
    }
    # 20 flops per pair, the reference's CostEstimate; 7 arrays in, 6 out
    row["bound_ms"], row["bound_by"] = bound(4 * 13 * n, 20 * n * n, fp32,
                                             bw)
    # every (r, s) at the default tiles, and every (bi, bj) at the
    # default (r, s): the whole (bi, bj) space is the tuning runner's
    # (python -m tpukernels_torch.autotune --kernel nbody)
    sweep = {}
    configs = [(r, s, bi, bj) for r in NBODY_SWEEP["r"]
               for s in NBODY_SWEEP["s"]]
    configs += [(plan.r, plan.s, bi2, bj2) for bi2 in NBODY_SWEEP["bi"]
                for bj2 in NBODY_SWEEP["bj"]]
    t_sweep = time.perf_counter()
    for r, s, bi2, bj2 in configs:
        p = NB.plan_forces(n, bi2, bj2, r, s)
        key = f"r={p.r} s={p.s} bi={bi2} bj={bj2}"
        if key not in sweep:
            sweep[key] = time_ms(forces(p), 5, warmup=1)
    row["per_config_ms"] = sweep
    t_clock = time.perf_counter()
    row["registers"] = {f"r={r} s={s}": v["registers"]
                        for (r, s), v in sorted(nbody.items())}
    row["sass_per_pair"] = nbody[(plan.r, plan.s)]["mix_per_pair"]
    slots = nbody[(plan.r, plan.s)]["slots_per_pair"]
    clock, most = sm_clock_mhz(torch, forces(plan))
    log(f"phase 5 nbody walls: row {t_sweep - t_row:.1f} s, per_config "
        f"{t_clock - t_sweep:.1f} s, SM clock "
        f"{time.perf_counter() - t_clock:.1f} s")
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


BINCOUNT_DEVICE_HOW = ("torch.profiler's device events summed: bincount "
                       "reads its input's max back to the host, so a CUDA "
                       "graph cannot capture it")


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
            # call with torch.bincount in it reads its input's max back to
            # the host (its output's size), so a graph cannot capture it:
            # its device time is the profiler's sum of its device events
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
                                          if name == "scan" else
                                          profiled_device_ms(lib, calls)),
                    "library_device_how": ("graph" if name == "scan" else
                                           BINCOUNT_DEVICE_HOW),
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
# three timed reps (five until phase 15 needed the time): (label, driver,
# flags, env, phase 5's wrapper row).
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
C_REPS = 3
# the record children run this many at once (one at a time until phase
# 15 needed the time), those with the longest serial C goldens first
C_RECORD_WIDE = 4
C_RECORD_FIRST = ("stencil 4096^2 x 1000", "nbody 65536, 1 step",
                  "sgemm 1024^3", "sgemm 1024^3 depth 3")
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
    from tpukernels_torch import _build, cgate

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
            for i, (d, a) in enumerate(cgate.run_all_rows())]
        # the chaos children beside them: none of these is timed
        with concurrent.futures.ThreadPoolExecutor(1) as side, \
                concurrent.futures.ThreadPoolExecutor(6) as pool:
            chaos = side.submit(c_chaos, cbin, state, shim)
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
        chaos.result()
        # the configurations of record, C_RECORD_WIDE children at a time,
        # the longest serial goldens first: a child's wall is mostly its
        # start and its C check's golden, so its time_ms shares the host
        # with the others' and is not the C path's cost. That cost is the
        # in-process breakdown after them, one at a time
        def record_child(row):
            label, driver, args, env, _p5 = row
            t_child = time.perf_counter()
            p, events = c_child(cbin, state, re.sub(r"\W+", "_", label),
                                driver, ["--check", f"--reps={C_REPS}", *args],
                                env, shim)
            return p, events, time.perf_counter() - t_child

        first = sorted(C_RECORD, key=lambda r: r[0] not in C_RECORD_FIRST)
        with concurrent.futures.ThreadPoolExecutor(C_RECORD_WIDE) as pool:
            futures = {r[0]: pool.submit(record_child, r) for r in first}
        out = []
        for label, driver, args, env, p5 in C_RECORD:
            flags = ["--check", f"--reps={C_REPS}", *args]
            p, events, child_s = futures[label].result()
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
                "shared_host": C_RECORD_WIDE,
                "wrapper_ms": wrapper, "wrapper_row": p5,
                "h2d_bytes": up, "d2h_bytes": down,
                "transfer_bound_ms": {
                    kind: (up / r["h2d"] + down / r["d2h"]) * 1e3
                    for kind, r in rates.items()},
                "capi_wall_ms": {"check": walls[0], "warm_up": walls[1],
                                 "reps": walls[2:]},
                "child_s": round(child_s, 3),
            }
            row["in_process"] = c_breakdown(torch, driver, args, env, state)
            row["gap_ms"] = row["in_process"]["run_from_c_ms"] - wrapper
            out.append(row)
            log(f"PASS C {label}: CHECK PASS; in this process run_from_c "
                f"{row['in_process']['run_from_c_ms']:.3f} ms, wrapper "
                f"{wrapper:.4f} ms, gap {row['gap_ms']:.3f} ms; the driver's "
                f"time_ms {row['time_ms']:.3f} ({row['metric']} "
                f"{row['value']:.3f} {row['unit']}; {C_RECORD_WIDE} children "
                f"at once: shared host, not a cost); transfer bound pageable "
                f"{row['transfer_bound_ms']['pageable']:.3f} ms, pinned "
                f"{row['transfer_bound_ms']['pinned']:.3f} ms; capi span "
                f"ms first {walls[0]}, warm-up {walls[1]}, reps {walls[2:]} "
                f"(shared host); child {child_s:.1f} s; in this process (ms): "
                + ", ".join(
                    f"{k[:-3]} {v:.3f}" for k, v in row["in_process"].items()))
            print(json.dumps({"c_entry": row}), flush=True)
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
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        corrupt = pool.submit(
            c_child, cbin, state, "chaos_corrupt", "sgemm",
            ["--check", "--reps=1", "--n=256"],
            {"TPKT_FAULT_PLAN": json.dumps(plan)}, shim)
        fail = pool.submit(
            c_child, cbin, state, "chaos_fail", "vector_add",
            ["--check", "--reps=1", "--n=1000"],
            {"TPKT_FAULT_PLAN": json.dumps({"fail_capi": "vector_add"})},
            shim)
        (p, events), (p2, events2) = corrupt.result(), fail.result()
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
    errors = [e for e in events2 if e.get("kind") == "capi_error"]
    if p2.returncode == 0 or not errors:
        raise AssertionError(f"chaos fail_capi: rc {p2.returncode}, "
                             f"{len(errors)} capi_error events")
    log(f"PASS chaos C fail_capi: rc {p2.returncode}, capi_error journaled")


# ---------------------------------------------------------------- phase 7

# what the daemon launches at its avatars (aot.BENCH_CONFIGS) with no
# knob set: B7, B1 and its prep launch, B4, B6, B12, B8, B9
SERVE_PATH = ("saxpy", "sgemm_prep", "sgemm_split3", "jacobi2d", "jacobi3d",
              "nbody_forces", "scan", "histogram")
# the burst: 120 requests (200 until phase 15 needed the time) at
# SERVE_RATE a second, Poisson, from two client threads, over three
# kernels at their avatars
SERVE_BURST = ("vector_add", "scan", "sgemm")
SERVE_BURST_N, SERVE_RATE = 120, 40.0
# phase 5's wrapper row of each burst kernel's configuration
SERVE_P5 = {"vector_add": f"saxpy n={1 << 20}", "scan": f"scan n={SCAN_N}",
            "sgemm": "sgemm[high]"}
# the mesh tier (step 9): a third daemon keeps TIER_RANKS ranks, itself
# and a follower process on the one card (gloo, host-staged); three
# requests over their avatars (aot.BENCH_CONFIGS: 2^22, 4096^2, 65 536),
# each against the single-device dispatch in this process. N-body within
# tests/test_torch_dispatch_mesh.py's band of the mesh twin
TIER_RANKS = 2
TIER_REQUESTS = (
    ("scan", ((1 << 24,),), {}),
    ("stencil2d", ((8192, 8192),), {"iters": 8}),
    ("nbody", ((1 << 17,),) * 7, {"dt": 1e-3, "eps": 1e-2, "steps": 1}),
)
TIER_NBODY_BAND = (5e-4, 5e-5)
# the request in flight when the follower is killed: a histogram over its
# avatar whose rank 0 sleeps TIER_SLOW_S in its dispatch's fault point
# (after the order went out), and the in-avatar request answered meanwhile
TIER_DOOMED = ("histogram", ((1 << 23,),), {"nbins": 256})
TIER_SLOW_S = 1.0
TIER_MEANWHILE = ("scan", ((1 << 22,),), {})
# the wedge, first: the tier's first scan dispatch (TIER_REQUESTS[0]'s)
# hangs on rank 0; its grace is 1.5 request timeouts, doubled once while
# the card and the follower answer (3 x TIER_TIMEOUT_S = 7.5 s), well
# over every tier request's serve span (at most 1.4 s in AP2/APR), so
# the case costs the grace, the rebuild and the scan: about 15 s. The
# group keeps the 60 s timeout it had at the daemon's default
TIER_TIMEOUT_S = 2.5
TIER_GROUP_TIMEOUT_S = 60
TIER_WALL_LIMIT_S = 45.0
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


def inventory_stamp(where, events, site, pid):
    """The one ``device_inventory`` event process ``pid`` stamped at
    ``site`` among ``events``, with the reference's keys; fails
    otherwise."""
    from tpukernels_torch.obs import scaling

    got = [e for e in events if e.get("kind") == "device_inventory"
           and e.get("site") == site and e.get("pid") == pid]
    if len(got) != 1 or not set(scaling.inventory()) <= set(got[0]):
        raise AssertionError(f"{where}: {len(got)} device_inventory stamps "
                             f"at {site} by pid {pid}: {got}")
    inv = {k: got[0][k] for k in scaling.inventory()}
    log(f"PASS {where} device_inventory at {site} (pid {pid}): "
        + json.dumps(inv))
    return inv


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
                   TPKT_AOT_DIR=os.path.join(root, "aot"),
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
    # the three daemons start together (the tier's follower too)
    tier_d = ServeDaemon(root, "tier", TPKT_SERVE_MESH=str(TIER_RANKS),
                         TPKT_SERVE_REQUEST_TIMEOUT_S=str(TIER_TIMEOUT_S),
                         TPKT_COORDINATOR_TIMEOUT_S=str(TIER_GROUP_TIMEOUT_S),
                         TPKT_FAULT_PLAN=json.dumps({
                             "slow_dispatch": {"kernel": TIER_DOOMED[0],
                                               "delay_s": TIER_SLOW_S},
                             "wedge_dispatch": {
                                 "kernel": TIER_REQUESTS[0][0],
                                 "times": 1}}))
    main_d = ServeDaemon(root, "main")
    chaos_d = ServeDaemon(root, "chaos", TPKT_FAULT_PLAN=plan,
                          TPKT_SERVE_REQUEST_TIMEOUT_S="2")
    try:
        with knobs(TPKT_TUNING_CACHE_DIR=os.path.join(root, "tuning"),
                   TPKT_SERVE_SHM=None, TPKT_SERVE_SHM_MIN_BYTES=None):
            # 9. the mesh tier first, so that its wall is its own
            tier = serve_tier(torch, tier_d, args)
            out = serve_drive(torch, times, rates, args, main_d, chaos_d,
                              (shim, cbin), kept)
        out["tier"] = tier
        # 8. clean stop
        for d in (main_d, chaos_d):
            stop = d.stop()
            log(f"PASS serve clean stop {os.path.basename(d.dir)}: rc 0, "
                f"socket and pidfile gone, serve_stop (served "
                f"{stop['served']}, requeued {stop['requeued']}, uptime "
                f"{stop['uptime_s']} s), stdout empty")
        # 5. the daemons (and the tier's followers) built nothing
        after = sorted(p.name for p in _build.BUILD_DIR.glob("*.so"))
        if after != libs or any("nvcc" in d.stderr()
                                for d in (main_d, chaos_d, tier_d)):
            raise AssertionError(f"a serve daemon built a library: {libs} "
                                 f"-> {after}")
        log(f"PASS serve daemons built nothing ({len(libs)} libraries)")
        for d in (main_d, chaos_d, tier_d):
            keep_journal(d.journal)
        out["phase_s"] = round(time.perf_counter() - t_phase, 3)
        log(f"phase 7 wall {out['phase_s']:.1f} s")
        print(json.dumps({"serve": out}), flush=True)
        return out
    finally:
        for d in (tier_d, main_d, chaos_d):
            d.kill()
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


def tier_request(torch, tier_d, key, ops, statics, rid):
    """One request to the tier's daemon; ``(outputs, client wall ms)``."""
    from tpukernels_torch.serve import client as serve_client

    with serve_client.ServeClient(tier_d.sock, timeout_s=300) as c:
        c.next_request_id = rid
        s0 = time.perf_counter()
        got = as_tuple(c.dispatch(key, *ops, **statics))
        return got, (time.perf_counter() - s0) * 1e3


def tier_events(tier_d, rid):
    """The tier daemon's ``serve_request`` of ``rid`` and its spans by
    name (ms)."""
    (ev,) = [e for e in tier_d.events("serve_request")
             if e.get("request_id") == rid]
    spans = {e["name"]: e for e in tier_d.events("span")
             if e.get("request_id") == rid}
    return ev, spans


def tier_check(torch, label, key, got, want):
    """The tier's answer against the single-device one: N-body within
    TIER_NBODY_BAND, the others bit for bit."""
    if key != "nbody":
        serve_same(torch, label, got, want)
        return
    for i, (g, w) in enumerate(zip(got, want)):
        check(f"{label} [{i}]", host_tensor(torch, g), host_tensor(torch, w),
              *TIER_NBODY_BAND)


def tier_wedge(torch, tier_d, case, mcase):
    """Step 9's wedge: the first scan over its avatar hangs on rank 0
    (``wedge_dispatch``, times 1); the watchdog gives it one more grace
    (the card and the follower answer), then breaks generation 1,
    abandons the worker and requeues the request once, and generation 2
    answers it bit for bit while an in-avatar scan is answered
    meanwhile. Returns the walls."""
    from tpukernels_torch.serve import client as serve_client

    key, shapes, statics, ops, want, _ = case
    mkey, mops, mstatics, mwant = mcase
    res = {}

    def send():
        try:
            res["got"], res["ms"] = tier_request(torch, tier_d, key, ops,
                                                 statics, "tier-wedged")
        except serve_client.ServeError as e:
            res["error"] = str(e)

    thread = threading.Thread(target=send)
    thread.start()
    deadline = time.monotonic() + 60
    while not [e for e in tier_d.events("fault_injected")
               if e.get("fault") == "wedge_dispatch"]:
        if time.monotonic() > deadline:
            raise AssertionError("serve tier: the wedged request's fault "
                                 "point was never reached")
        time.sleep(0.02)
    mgot, mwall = tier_request(torch, tier_d, mkey, mops, mstatics,
                               "tier-wedge-meanwhile")
    serve_same(torch, "serve tier in-avatar scan answered while a mesh "
               "order is wedged vs in-process dispatch", mgot, mwant)
    thread.join(120)
    if thread.is_alive() or "got" not in res:
        raise AssertionError(f"serve tier: the wedged request got {res}")
    tier_check(torch, f"serve tier {key} wedged, requeued and answered by "
               "generation 2 vs in-process dispatch", key, res["got"], want)
    now = tier_d.stats()["mesh_tier"]
    (wedge,) = [e for e in tier_d.events("fault_injected")
                if e.get("fault") == "wedge_dispatch"]
    fires = tier_d.events("watchdog_fire")
    requeued = tier_d.events("serve_request_requeued")
    verdicts = [e["verdict"] for e in tier_d.events("wedge_classification")]
    ups = tier_d.events("serve_mesh_up")
    ev, _ = tier_events(tier_d, "tier-wedged")
    if (len(fires) != 1 or fires[0]["mechanism"] != "serve-abandon"
            or len(requeued) != 1 or not verdicts
            or [e["generation"] for e in ups] != [1, 2]
            or len(tier_d.events("serve_mesh_broken")) != 1
            or now["generation"] != 2 or not now["up"]
            or not ev["ok"] or ev["requeues"] != 1
            or ev["mesh_shape"] != [TIER_RANKS]):
        raise AssertionError(f"serve tier wedge: fires {fires}, requeued "
                             f"{requeued}, verdicts {verdicts}, up {ups}, "
                             f"now {now}, served {ev}")
    grace = fires[0]["t"] - wedge["t"]
    log(f"PASS serve tier wedge: the {key} order wedged on rank 0, judged "
        f"{' then '.join(verdicts)}, its grace {grace:.3f} s (the fault to "
        f"the watchdog's fire), requeued once, generation 2 up after "
        f"{now['rebuild_s']:.3f} s (its follower's start "
        f"{now['start_s']:.3f} s), the client's wall {res['ms']:.3f} ms; "
        f"the in-avatar scan answered meanwhile in {mwall:.3f} ms")
    return {"grace_s": round(grace, 3), "rebuild_s": now["rebuild_s"],
            "client_ms": res["ms"], "meanwhile_ms": mwall}


def serve_tier(torch, tier_d, args):
    """Step 9 of phase 7: the mesh tier (``TPKT_SERVE_MESH``), a daemon
    that keeps a follower rank beside it on the one card. While it and
    its follower start, this process makes the operands and the
    single-device answers (and times that dispatch); then a scan over its
    avatar wedged on rank 0 (requeued once and answered by the next
    generation, an in-avatar scan answered meanwhile), three requests
    over their avatars against the single-device answers, the journal's
    fields, the follower killed while a request is in flight (one error
    reply, an in-avatar request answered meanwhile, the group rebuilt,
    the next mesh request right) and the daemon stopped. Walls, spans,
    bytes and seconds are printed, never judged."""
    import numpy as np

    from tpukernels_torch import registry
    from tpukernels_torch.serve import client as serve_client

    rng = np.random.default_rng(args.seed + 24)
    cases = []
    for key, shapes, statics in TIER_REQUESTS:
        ops = serve_operands(rng, key, shapes, statics)
        want, targs = serve_in_process(torch, key, ops, statics)
        single = time_ms(lambda: registry.dispatch(key, *targs, **statics),
                         3)
        cases.append((key, shapes, statics, ops, want, single))
        del targs
    dkey, dshapes, dstatics = TIER_DOOMED
    doomed = serve_operands(rng, dkey, dshapes, dstatics)
    mkey, mshapes, mstatics = TIER_MEANWHILE
    mops = serve_operands(rng, mkey, mshapes, mstatics)
    mwant, _ = serve_in_process(torch, mkey, mops, mstatics)
    torch.cuda.empty_cache()

    pong = tier_d.wait_ready()
    mt = pong["mesh_tier"]
    if (not mt or mt["ranks"] != TIER_RANKS or mt["backend"] != "gloo"
            or not mt["up"] or len(mt["followers"]) != TIER_RANKS - 1
            or not mt["device"].startswith("cuda")):
        raise AssertionError(f"serve tier: {pong}")
    log(f"PASS serve tier start: {mt['ranks']} ranks ({mt['backend']} on "
        f"{mt['device']}), follower pid(s) {mt['followers']}, the "
        f"follower's start {mt['start_s']:.3f} s, ping after "
        f"{tier_d.ready_s:.2f} s")
    wedge = tier_wedge(torch, tier_d, cases[0], (mkey, mops, mstatics, mwant))
    rows = {}
    for key, shapes, statics, ops, want, single in cases:
        rid = f"tier-{key}"
        got, wall = tier_request(torch, tier_d, key, ops, statics, rid)
        tier_check(torch, f"serve tier {key} "
                   f"{'x'.join(map(str, shapes[0]))} over its avatar vs "
                   "in-process dispatch", key, got, want)
        ev, spans = tier_events(tier_d, rid)
        disp = spans.get(f"serve/{key}/dispatch/{key}", {})
        if (ev["mesh_shape"] != [TIER_RANKS] or ev["bucketed"]
                or not ev["ok"]
                or not ev["bucket"].endswith(f"|mesh{TIER_RANKS}")
                or disp.get("mesh") != str(TIER_RANKS)):
            raise AssertionError(f"serve tier {key}: {ev}; span {disp}")
        rows[key] = r = {
            "shape": list(shapes[0]), "client_ms": wall,
            "dispatch_span_ms": disp["wall_s"] * 1e3,
            "serve_span_ms": spans[f"serve/{key}"]["wall_s"] * 1e3,
            "broadcast_span_ms":
                spans[f"serve/{key}/mesh/broadcast"]["wall_s"] * 1e3,
            "single_device_ms": single, "mesh_bytes": ev["mesh_bytes"],
            "bucket": ev["bucket"]}
        log(f"serve tier {key} {'x'.join(map(str, shapes[0]))}: client "
            f"wall {wall:.3f} ms, serve/{key} {r['serve_span_ms']:.3f} ms, "
            f"broadcast {r['broadcast_span_ms']:.3f} ms, dispatch/{key} "
            f"(mesh {TIER_RANKS}) {r['dispatch_span_ms']:.3f} ms; the "
            f"single-device dispatch {single:.4f} ms; bytes broadcast "
            f"{ev['mesh_bytes']['broadcast']}, host-staged "
            f"{ev['mesh_bytes']['host_staged']}")
    log(f"PASS serve tier journal: {len(rows)} serve_request with "
        f"mesh_shape [{TIER_RANKS}], bucketed false, buckets "
        f"{[r['bucket'] for r in rows.values()]}, dispatch spans mesh "
        f"{TIER_RANKS!r}")

    # the follower killed while the doomed request is in flight
    res = {}

    def send():
        try:
            tier_request(torch, tier_d, dkey, doomed, dstatics,
                         "tier-doomed")
        except serve_client.ServeError as e:
            res["error"] = str(e)
        else:
            res["error"] = None

    before = tier_d.stats()["mesh_tier"]
    thread = threading.Thread(target=send)
    thread.start()
    deadline = time.monotonic() + 60
    while not [e for e in tier_d.events("fault_injected")
               if e.get("fault") == "slow_dispatch"]:
        if time.monotonic() > deadline:
            raise AssertionError("serve tier: the doomed request's fault "
                                 "point was never reached")
        time.sleep(0.02)
    os.kill(before["followers"][0], signal.SIGKILL)
    mgot, mwall = tier_request(torch, tier_d, mkey, mops, mstatics,
                               "tier-meanwhile")
    serve_same(torch, "serve tier in-avatar scan answered while the group "
               "is broken vs in-process dispatch", mgot, mwant)
    thread.join(120)
    if thread.is_alive() or "mesh tier" not in (res.get("error") or ""):
        raise AssertionError(f"serve tier: the doomed request got {res}")
    # the next mesh request waits for the new group: the smallest of the
    # three, N-body
    key, shapes, statics, ops, want, _ = cases[-1]
    got, after_ms = tier_request(torch, tier_d, key, ops, statics,
                                 "tier-after")
    tier_check(torch, f"serve tier {key} after the rebuild vs in-process "
               "dispatch", key, got, want)
    del cases
    now = tier_d.stats()["mesh_tier"]
    failed = [e.get("request_id") for e in tier_d.events("serve_request")
              if not e["ok"]]
    broken = tier_d.events("serve_mesh_broken")
    ups = tier_d.events("serve_mesh_up")
    meanwhile, _ = tier_events(tier_d, "tier-meanwhile")
    # generation 1 went with the wedge, generation 2 with the kill
    if (failed != ["tier-doomed"] or len(broken) != 2
            or broken[1]["exited"] != [{"pid": before["followers"][0],
                                        "rc": -signal.SIGKILL}]
            or before["generation"] != 2
            or [e["generation"] for e in ups] != [1, 2, 3]
            or now["generation"] != 3 or not now["up"]
            or len(tier_d.events("serve_request_requeued")) != 1
            or tier_d.events("serve_mesh_stale_order")
            or meanwhile["mesh_shape"] is not None
            or not meanwhile["bucketed"]):
        raise AssertionError(f"serve tier kill: failed {failed}, broken "
                             f"{broken}, up {ups}, now {now}")
    log(f"PASS serve tier kill follower pid {before['followers'][0]}: one "
        f"error reply ({res['error'][:80]}...), the in-avatar scan "
        f"answered meanwhile in {mwall:.3f} ms, generation 3 up (follower "
        f"{now['followers']}, rebuild {now['rebuild_s']:.3f} s, its "
        f"follower's start {now['start_s']:.3f} s), the next {key} right "
        f"{after_ms:.3f} ms after it was sent, nothing requeued but the "
        "wedge")
    launches = {k: v for k, v in tier_d.stats()["launches"].items() if v}
    stop = tier_d.stop()
    wall = time.perf_counter() - tier_d.t0
    followers = mt["followers"] + before["followers"] + now["followers"]
    deadline = time.monotonic() + 10
    while True:
        under = descendants()
        alive = [p for p in followers if under.get(p, ("Z",))[0] != "Z"]
        if not alive or time.monotonic() > deadline:
            break
        time.sleep(0.1)
    if alive:
        raise AssertionError(f"serve tier: followers {alive} outlived "
                             "their daemon")
    log(f"PASS serve tier clean stop: rc 0, served {stop['served']}, no "
        "follower left")
    log(f"serve tier wall {wall:.1f} s from its daemon's start to its stop "
        f"(limit {TIER_WALL_LIMIT_S:.0f} s: "
        f"{'held' if wall <= TIER_WALL_LIMIT_S else 'missed'}); follower "
        f"start {mt['start_s']:.3f} s, rebuild {now['rebuild_s']:.3f} s")
    return {"ranks": TIER_RANKS, "backend": mt["backend"],
            "ready_s": round(tier_d.ready_s, 3), "wall_s": round(wall, 3),
            "follower_start_s": mt["start_s"],
            "rebuild_s": now["rebuild_s"],
            "rebuild_follower_start_s": now["start_s"],
            "requests": rows, "meanwhile_ms": mwall, "after_ms": after_ms,
            "wedge": wedge, "launches": launches}


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
    inventory_stamp("serve", main_d.events(), "serve", pong["pid"])

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
        if key == "sgemm":
            # zero padding adds exact zeros on the card too? printed, as
            # the CPU's plain version is held to it by its tests
            g, w = host_tensor(torch, got[0]), host_tensor(torch, want[0])
            diff = int((g != w).sum())
            log(f"{'PASS' if diff == 0 else 'DIFFERS'} serve sgemm at "
                f"{'x'.join(map(str, shapes[1]))} padded to its avatar: "
                f"{'bitwise' if diff == 0 else f'{diff} elements differ'} "
                "the in-process call at its own shape "
                f"(max_abs_err={max_abs_err(g, w):.3e})")
            below["sgemm_bitwise"] = diff == 0
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
              "TPKT_STENCIL_RESIDUAL", "TPKT_SCALING_DIR",
              "TPKT_SCALING_MIN_EFF", "TPKT_OVERLAP_MIN_FRAC",
              "TPKT_MULTICHIP_ARTIFACT", "TPKT_DRYRUN_TIMEOUT")
# dispatch_mesh's key -> the label of the distributed entry it runs
MESH_LABELS = {"histogram": "histogram", "nbody": "nbody_ring",
               "scan": "scan", "scan_exclusive": "scan_exclusive",
               "stencil2d": "jacobi2d", "stencil3d": "jacobi3d"}
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
    scaling_dir = os.path.join(state, "scaling")
    try:
        with knobs(**{**{k: None for k in DIST_KNOBS},
                      "TPKT_SCALING_DIR": scaling_dir}):
            out = {"nccl": dist_nccl(torch, times, peaks, state, args.seed)}
            out["gloo"] = dist_gloo(torch, times, state, args.seed)
            # 8c beside 8d: neither judges a time (8d's walls are never
            # judged: ranks on one card share it, and now the host too)
            with concurrent.futures.ThreadPoolExecutor(2) as pool:
                c_rows = pool.submit(dist_c, state, shim, cbin)
                sweeps = pool.submit(dist_sweeps, state)
                out["c"], out["sweeps"] = c_rows.result(), sweeps.result()
        after = sorted(p.name for p in _build.BUILD_DIR.glob("*.so"))
        if after != libs:
            raise AssertionError(f"a rank built a library: {libs} -> {after}")
        log(f"PASS phase 8 ranks built nothing ({len(libs)} libraries)")
        keep(scaling_dir, "scaling")
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
    from tpukernels_torch.resilience import journal

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
        # the sweep's CLI on the same group: its probed inventory stamp
        since = len(journal.load_events([journal.path()])[0])
        if busbw.main(["--min=1KB", "--max=1KB", "--reps=1"]) != 0:
            raise AssertionError("8a: busbw's CLI failed")
        inv = inventory_stamp("8a busbw", journal.load_events(
            [journal.path()])[0][since:], "busbw", os.getpid())
        kind = torch.cuda.get_device_name(0).lower().replace(" ", "_")
        if (inv["source"], inv["platform"], inv["device_kind"],
                inv["fake"]) != ("torch", "cuda", kind, False):
            raise AssertionError(f"8a busbw's stamp is not the card's: {inv}")
        log(f"PASS 8a busbw's stamp reads the card: {inv['device_kind']}, "
            "fake false")
        from tpukernels_torch.obs import scaling

        (art,) = scaling.load_artifacts()
        if (art["family"], art["n_devices"], art["fake"],
                art["device_inventory"], len(art["points"])) != (
                "busbw", 1, False, inv, 1):
            raise AssertionError(f"8a busbw's artifact: {art}")
        log(f"PASS 8a busbw's artifact {art['_source']}: n_devices 1, fake "
            f"false, stamped {inv['device_kind']}; "
            f"{art['points'][0]['gb_s']:.3f} GB/s at 1 KiB")
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


def dist_gloo(torch, times, state, seed):
    """8b: four ranks on the one card through gloo (each a process of
    its own running ``dist_rank``; the kernels run on the card, gloo
    stages the wire through host memory). Fails unless every rank passes
    its checks and launched every kernel of the path, on the entries'
    path and on ``dispatch_mesh``'s, and the overlap probe's artifact is
    flagged ``shared-card``."""
    out_dir = os.path.join(state, "gloo")
    os.makedirs(out_dir)
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import chip_smoke; "
            "sys.exit(chip_smoke.dist_rank(sys.argv[2], int(sys.argv[3])))")
    env = {k: v for k, v in os.environ.items() if k not in DIST_KNOBS}
    env.pop("TPKT_HEALTH_JOURNAL", None)
    env.update(TPKT_COORDINATOR_ADDRESS=f"file://{out_dir}/rendezvous",
               TPKT_NUM_PROCESSES=str(DIST_RANKS), TPKT_DIST_BACKEND="gloo",
               TPKT_COORDINATOR_TIMEOUT_S="300",
               TPKT_SCALING_DIR=os.environ["TPKT_SCALING_DIR"])
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
    for r in range(DIST_RANKS):
        idle = [k for k in DIST_PATH if ranks[r]["mesh_launches"][k] <= 0]
        if idle:
            raise AssertionError(f"8b rank {r}: dispatch_mesh launched no "
                                 f"{idle}")
    log("PASS 8b dispatch_mesh: every rank launched " + ", ".join(DIST_PATH)
        + ": " + json.dumps([{k: r["mesh_launches"][k] for k in DIST_PATH}
                             for r in ranks]))
    for key, ms in ranks[0]["mesh_ms"].items():
        label = MESH_LABELS[key]
        log(f"8b dispatch_mesh {key} x{DIST_RANKS}: {ms:.4f} ms a call "
            f"(host-staged gloo, one card), its entry {label} "
            f"{ranks[0]['ms'][label]:.4f} ms, the single-device wrapper "
            f"(phase 5) {times[DIST_ROWS[label]]['ms']:.4f} ms")
    from tpukernels_torch.obs import scaling

    (art,) = [a for a in scaling.load_artifacts()
              if a["family"] == "overlap"]
    inv = art["device_inventory"]
    verdicts = scaling.analyze_overlap([art])
    if (art["fake"], inv["fake_basis"], inv["process_count"]) != (
            True, "shared-card", DIST_RANKS) or {
            v["verdict"] for v in verdicts.values()} != {"no_data"}:
        raise AssertionError(f"8b overlap artifact: {art}, {verdicts}")
    for p in art["points"]:
        log(f"8b overlap_frac {p['op']} depth {p['depth']}: "
            f"{p['overlap_frac']:.4f} (comm {p['t_comm_s'] * 1e3:.3f} ms, "
            f"compute {p['t_compute_s'] * 1e3:.3f} ms, full "
            f"{p['t_full_s'] * 1e3:.3f} ms; {DIST_RANKS} ranks on one card)")
    log(f"PASS 8b overlap artifact {art['_source']}: fake, shared-card, "
        "never judged")
    out = dict(ranks[0])
    out["overlap"] = art["points"]
    return out


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
    wants = {}
    for label, g in got.items():
        if rank == 0:
            band = label.startswith("nbody")
            want = wants[label] = ref[label]()
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
    mesh_ms, mesh_launches = dist_rank_mesh(torch, inp, rank, wants)
    dist_rank_overlap(mesh)
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
                   "staged_bytes": staged, "mesh_launches": mesh_launches,
                   "mesh_ms": mesh_ms}, f)
    return 0


def dist_rank_mesh(torch, inp, rank, wants):
    """8b's ``registry.dispatch_mesh``: every ``MESH_KERNELS`` key, the
    full operands on every rank, at the configurations of record. A
    warm-up at small shapes first spends the guard's first-trust canaries
    and the compile discipline's first ensure, so the counted pass
    launches only the mesh path. On rank 0 each result against the
    single-device wrapper's (``wants``; N-body against its plain
    version, within its band). Returns ``(ms a call, launches)``."""
    from tpukernels_torch import registry
    from tpukernels_torch.kernels import LAUNCHES, reset_launches
    from tpukernels_torch.kernels import nbody as NB

    shape = (DIST_RANKS,)
    gen = torch.Generator(device="cuda").manual_seed(11)

    def calls(ints, grid2d, grid3d, bods, iters2, iters3):
        return {
            "scan": lambda: registry.dispatch_mesh(
                "scan", ints, mesh_shape=shape),
            "scan_exclusive": lambda: registry.dispatch_mesh(
                "scan_exclusive", ints, mesh_shape=shape),
            "histogram": lambda: registry.dispatch_mesh(
                "histogram", ints, mesh_shape=shape, nbins=SCAN_NBINS),
            "stencil2d": lambda: registry.dispatch_mesh(
                "stencil2d", grid2d, mesh_shape=shape, iters=iters2),
            "stencil3d": lambda: registry.dispatch_mesh(
                "stencil3d", grid3d, mesh_shape=shape, iters=iters3),
            "nbody": lambda: stacked(registry.dispatch_mesh(
                "nbody", *bods, mesh_shape=shape, dt=1e-3, eps=1e-2,
                steps=1)),
        }

    small = calls(
        torch.randint(0, SCAN_NBINS, (4096,), device="cuda", generator=gen,
                      dtype=torch.int32),
        torch.randn(64, 256, device="cuda", generator=gen),
        torch.randn(8, 32, 256, device="cuda", generator=gen),
        bodies(gen, 1024), 2, 2)
    for fn in small.values():
        fn()
    record = calls(inp["ints"], inp["grid2d"], inp["grid3d"], inp["bodies"],
                   STENCIL2D_ITERS, STENCIL3D_ITERS)
    torch.cuda.synchronize()
    reset_launches()
    got = {key: fn() for key, fn in record.items()}
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    if rank == 0:
        for key, g in got.items():
            what = f"8b dispatch_mesh {key} x{DIST_RANKS} (host-staged gloo)"
            if key == "nbody":
                check(f"{what} vs its plain version", g,
                      stacked(NB.nbody_plain(*inp["bodies"])), *NBODY_BAND)
            else:
                check_exact(f"{what} vs the single-device wrapper", g,
                            wants[MESH_LABELS[key]])
    del got
    # the stencils take 0.3-0.7 s a call at four ranks; the rest, ms
    ms = {key: time_ms(fn, 2 if key.startswith("stencil") else 10,
                       warmup=0 if key.startswith("stencil") else 1)
          for key, fn in record.items()}
    return ms, launches


def dist_rank_overlap(mesh):
    """8b's overlap probe: both ops at depth 1 and 2 on the four ranks
    (rank 0 prints each point); rank 0 writes the artifact, whose probed
    stamp must say the ranks share the card."""
    from tpukernels_torch.obs import scaling
    from tpukernels_torch.parallel import overlap

    inv = scaling.emit_inventory("overlap", probe=True)
    if (inv["fake"], inv["fake_basis"]) != (True, "shared-card"):
        raise AssertionError(f"8b overlap's stamp: {inv}")
    points = []
    for depth in (1, 2):  # two timed reps a point (the tool's default 5)
        points += overlap.measure(mesh=mesh, depth=depth, fake=inv["fake"],
                                  reps=2)
    if mesh.rank == 0:
        scaling.write_overlap_artifact(points, inv)


def run_tree(cmd, env, timeout):
    """``cmd`` in a session of its own, so its rank processes go with it
    on a timeout; returns ``(rc, stdout + stderr, seconds)``."""
    t0 = time.perf_counter()
    p = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True,
                         start_new_session=True)
    try:
        out = p.communicate(timeout=timeout)[0]
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        out = p.communicate()[0] + f"\n(killed after {timeout} s)"
    return p.returncode, out, time.perf_counter() - t0


def dist_sweeps(state):
    """8d: the weak-scaling sweep at 1 and 4 ranks and the dry run at 4,
    each as fresh rank processes on the card, the two at once; rc 0 each, their walls
    and efficiencies printed, their artifacts flagged ``shared-card``;
    then every artifact of phase 8 judged, and a gating verdict fails."""
    from tpukernels_torch.obs import scaling

    env = {k: v for k, v in os.environ.items() if k not in DIST_KNOBS}
    env.pop("TPKT_HEALTH_JOURNAL", None)
    d = scaling.scaling_dir()
    env.update(TPKT_SCALING_DIR=d, PYTHONPATH=REPO,
               TPKT_MULTICHIP_ARTIFACT=os.path.join(d, "multichip_4.json"))
    out = {}
    cmds = (("weak", [sys.executable, "-m",
                      "tpukernels_torch.parallel.weak_scaling",
                      "--sizes", "1 4", "--reps", "1"]),
            ("dryrun", [sys.executable, "-m", "tpukernels_torch.dryrun",
                        str(DIST_RANKS)]))
    # the two trees at once: their walls are never judged
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        done = list(pool.map(lambda c: run_tree(c[1], env, 600), cmds))
    for (name, cmd), (rc, text, secs) in zip(cmds, done):
        for line in text.splitlines():
            log(f"  8d {name}: {line}")
        if rc != 0:
            raise AssertionError(f"8d {name}: rc {rc}")
        log(f"PASS 8d {' '.join(cmd[2:])}: rc 0 in {secs:.1f} s")
        out[f"{name}_s"] = round(secs, 3)
    (weak,) = [a for a in scaling.load_artifacts()
               if a["family"] == "weak_scaling"]
    if (weak["fake"], weak["device_inventory"]["fake_basis"]) != (
            True, "shared-card") or not all(p["ok"] for p in weak["points"]):
        raise AssertionError(f"8d weak artifact: {weak}")
    out["weak"] = {}
    for prog, v in scaling.analyze_weak([weak]).items():
        log(f"8d weak {prog}: walls " + ", ".join(
            f"n={n} {w * 1e3:.3f} ms" for n, w in v["walls"].items())
            + f"; efficiency {v['efficiency']} (ranks share one card, "
            "and the host with 8c: contention, not scaling; never judged)")
        out["weak"][prog] = {"walls_s": v["walls"],
                             "efficiency": v["efficiency"]}
    (dry,) = scaling.load_dryruns()
    if (dry["ok"], dry["fake"], dry["n_devices"], len(dry["programs"])) != (
            True, True, DIST_RANKS, 9):
        raise AssertionError(f"8d dry-run artifact: {dry}")
    out["dryrun_walls_s"] = {p["name"]: p["wall_s"] for p in dry["programs"]}
    log("8d dryrun walls: " + ", ".join(
        f"{k} {v * 1e3:.0f} ms" for k, v in out["dryrun_walls_s"].items()))
    analysis = scaling.analyze_repo()
    gating = scaling.gating_findings(analysis)
    log("8d verdicts: " + json.dumps(
        {fam: {k: v["verdict"] for k, v in analysis[fam].items()}
         for fam in ("busbw", "weak", "overlap")}))
    if gating:
        raise AssertionError(f"8d gating verdicts: {gating}")
    log(f"PASS 8d {analysis['artifacts']} artifacts judged: nothing gates")
    return out


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
    three rows at once, each rank printing its own CHECK PASS (the
    residual rows their
    stderr line, the sweep row its table), and ``allreduce_bench`` at
    ``TPKT_MESH=1`` on NCCL."""
    rows = [(f"mesh {i}", env, driver, args, DIST_RANKS)
            for i, (env, driver, args) in enumerate(C_MESH_ROWS)]
    rows.append(("nccl allreduce_bench", {}, "allreduce_bench",
                 ["--n=1048576"], 1))
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
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
                   TPKT_AOT_DIR=os.path.join(root, "aot"),
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
        keep_journal(fl.journal)
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
    inventory_stamp("fleet", fl.events(), "serve_router", rpid)
    for w in workers:
        inventory_stamp("fleet", fl.events(), "serve", w)

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
    top = fleet_top(fl)

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
            "roles": roles, "top": top, "wedge": wedge, "kill_worker": kill,
            "kill_router": kr,
            "pids": sorted(p for p in pids if p)}


def fleet_top(fl):
    """``ctl top --once`` against the live fleet: rc 0 and a row a worker,
    each with requests served; returns {worker: served}."""
    text = fl.ctl("top", "--once")
    rows = {line.split()[0]: line.split() for line in text.splitlines()
            if line.split() and line.split()[0] in ("worker0", "worker1")}
    served = {k: int(v[7]) for k, v in rows.items() if v[7].isdigit()}
    if set(served) != {"worker0", "worker1"} or min(served.values()) <= 0:
        raise AssertionError(f"fleet top: rows {rows}\n{text}")
    log("fleet top --once:\n  " + "\n  ".join(text.strip().splitlines()))
    log(f"PASS fleet top: rc 0, a row for each worker, served {served}")
    return served


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


# ---------------------------------------------------------------- phase 10

# the knobs of phase 10's third prewarm: SGEMM at depth 3 (B2's library)
# and the fused scan + histogram (B11's)
AOT_KNOBS = {"TPKT_SGEMM_DEPTH": "3", "TPKT_SCANHIST_FUSE": "on"}


def aot_env(root, journal_name, **extra):
    """A child's env: no knob of this process, the manifest, integrity
    state and tuning cache in ``root``, a journal of its own."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("TPKT_")}
    env.update(PYTHONPATH=REPO, TPKT_AOT_DIR=os.path.join(root, "aot"),
               TPKT_INTEGRITY_DIR=os.path.join(root, "integrity"),
               TPKT_TUNING_CACHE_DIR=os.path.join(root, "tuning"),
               TPKT_HEALTH_JOURNAL=os.path.join(root, journal_name), **extra)
    return env


def prewarm_child(root, tag, **extra):
    """``python -m tpukernels_torch.prewarm --check`` in a process of its
    own: its rc, wall seconds (the process's start included), its
    ``prewarm_kernel`` events by kernel and its output."""
    from tpukernels_torch.resilience import journal

    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "tpukernels_torch.prewarm",
                        "--check"], cwd=REPO,
                       env=aot_env(root, f"{tag}.jsonl", **extra),
                       capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    events = journal.load_events([os.path.join(root, f"{tag}.jsonl")])[0]
    rows = {e["kernel"]: e for e in events
            if e.get("kind") == "prewarm_kernel"}
    return p.returncode, wall, rows, p.stdout + p.stderr


def phase_compile(torch, guarded):
    """Phase 10: the compile discipline on the card (item 10 of the
    module docstring)."""
    log("== phase 10: the compile discipline (python -m "
        "tpukernels_torch.prewarm)")
    from tpukernels_torch import _build, aot

    t_phase = time.perf_counter()
    libs = sorted(p.name for p in _build.BUILD_DIR.glob("*.so"))
    root = tempfile.mkdtemp(prefix="tpkt_aot_")
    keys = sorted(aot.BENCH_CONFIGS)
    try:
        # 1. prewarm cold, warm, under knobs, and with the layer off
        runs = {}
        for tag, want, extra in (("cold", "miss", {}), ("warm", "hit", {}),
                                 ("knobs", "miss", AOT_KNOBS)):
            rc, wall, rows, out = prewarm_child(root, tag, **extra)
            bad = [k for k in keys if k not in rows
                   or rows[k]["status"] != "ok"
                   or rows[k]["expected"] != want]
            if rc != 0 or bad or len(rows) != len(keys):
                raise AssertionError(f"10 prewarm {tag}: rc {rc}, keys not "
                                     f"{want}: {bad}\n{out[-3000:]}")
            runs[tag] = {"wall_s": round(wall, 3), "rows": rows}
            log(f"PASS 10 prewarm --check {tag}"
                + (f" ({' '.join(f'{k}={v}' for k, v in extra.items())})"
                   if extra else "")
                + f": rc 0, every key a {want}, {wall:.1f} s with the "
                "process's start")
        knob_libs = {lib for r in runs["knobs"]["rows"].values()
                     for lib in r["libraries"]}
        fresh = {r["key"] for r in runs["knobs"]["rows"].values()}
        if ({"sgemm_pipelined", "scan_histogram"} - knob_libs
                or fresh & {r["key"] for r in runs["cold"]["rows"].values()}):
            raise AssertionError(f"10 prewarm under {AOT_KNOBS}: libraries "
                                 f"{sorted(knob_libs)}, keys {sorted(fresh)}")
        log("PASS 10 the knobs' prewarm: new keys, B2's and B11's libraries "
            "(sgemm_pipelined, scan_histogram) loaded")
        rc, wall, rows, out = prewarm_child(root, "off", TPKT_AOT_CACHE="0")
        if rc != 1 or rows or "TPKT_AOT_CACHE=0" not in out:
            raise AssertionError(f"10 prewarm with the layer off: rc {rc}\n"
                                 f"{out[-2000:]}")
        log("PASS 10 prewarm with TPKT_AOT_CACHE=0: rc 1, nothing prewarmed")
        for k in keys:
            c, w, n = (runs[t]["rows"][k] for t in ("cold", "warm", "knobs"))
            log(f"10 {k}: cold {c['wall_s'] * 1e3:.3f} ms (load "
                f"{c['load_s'] * 1e3:.3f}, plan {c['plan_s'] * 1e3:.3f}, "
                f"build {c['build_s'] * 1e3:.3f}), warm "
                f"{w['wall_s'] * 1e3:.3f} ms, under the knobs "
                f"{n['wall_s'] * 1e3:.3f} ms ({','.join(n['libraries'])})")
        per_lib = {}
        for tag in ("cold", "knobs"):
            for r in runs[tag]["rows"].values():
                per_lib.update(r["libraries"])
        for lib, rep in sorted(per_lib.items()):
            spilled = rep["spill_stores"] + rep["spill_loads"]
            log(f"10 library {lib}: built in {BUILD_SECONDS.get(lib, 0.0):.1f}"
                f" s (phase 2), {rep['registers']} registers, "
                f"{rep['smem_bytes']} B smem, spills {spilled} B, "
                f"{rep['wgmma_serialisation']} wgmma serialisation warnings")
        # 2. a dispatch after precompile loads nothing; an integrity
        # failure drops only its kernel's rows, and the next dispatch is
        # a miss and right (a process of its own: a fresh memo)
        child = os.path.join(root, "child.json")
        code = ("import sys; sys.path.insert(0, sys.argv[1]); import chip_smoke; "
                "sys.exit(chip_smoke.aot_child(sys.argv[2]))")
        p = subprocess.run([sys.executable, "-c", code, REPO, child],
                           cwd=REPO, env=aot_env(root, "child.jsonl"),
                           capture_output=True, text=True, timeout=600)
        for line in p.stdout.splitlines():
            log(line)
        if p.returncode != 0:
            raise AssertionError(f"10 the precompile child: rc "
                                 f"{p.returncode}\n{p.stderr[-4000:]}")
        with open(child) as f:
            checked = json.load(f)
        # 3. what the memo adds to a dispatch: phase 4b's turns
        memo = {lbl: round((c["off"] - c["bare"]) * 1e3, 3)
                for lbl, c in guarded["costs"].items()}
        over = {lbl: round((c["off"] - c["wrapper"]) * 1e3, 3)
                for lbl, c in guarded["costs"].items()}
        log("10 dispatch memo (phase 4b, guard off minus guard and compile "
            f"discipline off), us a call: {json.dumps(memo)}")
        log("10 dispatch with the guard off over the wrapper alone, us a "
            f"call: {json.dumps(over)}")
        after = sorted(p.name for p in _build.BUILD_DIR.glob("*.so"))
        if after != libs:
            raise AssertionError(f"10: a child built a library: {libs} -> "
                                 f"{after}")
        log(f"PASS 10 children built nothing ({len(libs)} libraries)")
        out = {"prewarm": {t: {"wall_s": r["wall_s"], "keys": {
                   k: {f: v[f] for f in ("expected", "wall_s", "build_s",
                                         "load_s", "plan_s")}
                   for k, v in r["rows"].items()}} for t, r in runs.items()},
               "libraries": per_lib, "build_s": dict(BUILD_SECONDS),
               "memo_us": memo, "off_over_wrapper_us": over, **checked,
               "phase_s": round(time.perf_counter() - t_phase, 3)}
        log(f"phase 10 wall {out['phase_s']:.1f} s")
        print(json.dumps({"aot": out}), flush=True)
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def aot_child(out_path):
    """Phase 10's process with a fresh memo: every key precompiled on the
    card, then dispatched at its avatar (seeded operands) loading no
    library the precompile had not loaded and ensuring nothing more, also
    under :data:`AOT_KNOBS` for SGEMM and scan_histogram; then a
    ``corrupt_output`` on histogram's result: the guard's failure drops
    histogram's manifest rows and only those, and the next dispatch is an
    ``aot_miss`` and exact. Writes its findings to ``out_path``."""
    import numpy as np
    import torch

    from tpukernels_torch import _build, aot, interop, registry
    from tpukernels_torch.obs import metrics
    from tpukernels_torch.resilience import faults, integrity, journal

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(10)
    checked = {"no_new_library": []}
    for env, names in (({}, sorted(aot.BENCH_CONFIGS)),
                       (AOT_KNOBS, ("sgemm", "scan_histogram"))):
        with knobs(**env):
            for key in names:
                row = registry.precompile(key)
                spec = aot.BENCH_CONFIGS[key]
                statics = dict(spec["statics"])
                args = interop.to_port(key, serve_operands(
                    rng, key, [s for _, s in spec["args"]], statics))
                held, ensured = set(_build._LIBS), metrics.counter(
                    "aot.ensures")
                registry.dispatch(key, *args, **statics)
                torch.cuda.synchronize()
                new = set(_build._LIBS) - held
                if new or metrics.counter("aot.ensures") != ensured:
                    raise AssertionError(
                        f"{key} {env}: the dispatch after precompile loaded "
                        f"{sorted(new)}, ensured "
                        f"{metrics.counter('aot.ensures') - ensured} more")
                checked["no_new_library"].append(
                    {"key": row["key"], "libraries": row["libraries"]})
                log(f"PASS 10 {key}{' ' + json.dumps(env) if env else ''}: "
                    f"the dispatch after precompile loaded no library and "
                    f"ensured nothing ({','.join(row['libraries'])} held)")
                del args
    # the integrity failure
    path = aot.manifest_path()

    def rows():
        with open(path) as f:
            return set(json.load(f)["entries"])

    x = interop.to_port("histogram", serve_operands(
        rng, "histogram", [(1 << 22,)], {"nbins": 256}))[0]
    before = rows()
    hist = {k for k in before if k.split("|")[0].split("@")[0] == "histogram"}
    since = len(journal.load_events([journal.path()])[0])
    with knobs(TPKT_FAULT_PLAN=json.dumps({"corrupt_output": {
            "kernel": "histogram", "site": "registry"}}),
               TPKT_INTEGRITY_SAMPLE="1"):
        faults.reload_plan()
        registry.dispatch("histogram", x, nbins=256)
        torch.cuda.synchronize()
    faults.reload_plan()
    events = journal.load_events([journal.path()])[0][since:]
    failed = [e for e in events if e["kind"] == "output_integrity_failed"]
    left = rows()
    if (len(failed) != 1 or set(failed[0]["aot_manifest_dropped"]) != hist
            or left != before - hist or not hist):
        raise AssertionError(f"10 integrity failure: events {failed}, "
                             f"rows {sorted(before)} -> {sorted(left)}")
    log(f"PASS 10 an integrity failure on histogram dropped its {len(hist)} "
        f"manifest rows and no other ({len(left)} left), memo "
        f"{failed[0]['aot_memo_dropped']}, plans "
        f"{failed[0]['plan_memo_dropped']}")
    since = len(journal.load_events([journal.path()])[0])
    got = registry.dispatch("histogram", x, nbins=256)
    want = integrity.oracle("histogram")(x.cpu(), 256)
    check_exact("10 histogram after the invalidation vs oracle", got.cpu(),
                want)
    misses = [e for e in journal.load_events([journal.path()])[0][since:]
              if e["kind"] == "aot_miss"]
    if [e["key"].split("|")[0] for e in misses] != ["histogram@nbins=256"]:
        raise AssertionError(f"10: after the invalidation {misses}")
    log("PASS 10 the next histogram dispatch: one aot_miss, exact")
    checked["invalidated"] = sorted(hist)
    with open(out_path, "w") as f:
        json.dump(checked, f)
    return 0


# ------------------------------------------------------------------ #
# phase 11: the serving control loop                                 #
# ------------------------------------------------------------------ #

# 11a: in process, every key at its avatar, at least this many scheduled
# requests a key, Poisson at LOOP_RATE a second
LOOP_LEAST, LOOP_RATE = 20, 50.0
# 11b: one daemon, three keys at their avatars, Poisson at 5 a second for
# about 10 s (40 % of the 12.8 a second phase 7's two closed-loop threads
# completed in AC1; 25 s until phase 15 needed the time)
LOOP_SERVED = {"vector_add": 1.0, "scan": 1.0, "sgemm": 1.0}
LOOP_SERVED_RATE, LOOP_SERVED_S = 5.0, 10.0
# 11c: traffic that buckets with waste under the default table: SAXPY
# pads 42.8 % into 2^20, the scan 28.5 % into 2^22
LOOP_TRAFFIC = {"vector_add": ((), (600_000,), (600_000,)),
                "scan": ((3_000_000,),)}
LOOP_TRAFFIC_N, LOOP_TRAFFIC_RATE = 60, 5.0
# the canary: 24 requests a run (40 until phase 15 needed the time),
# each side run twice
LOOP_CANARY = ("--seed", "11", "--requests", "24", "--rate", "5")


def loop_env(root, journal_path, **extra):
    """A loop child's env: no knob of this process, the compile
    manifest, integrity state and tuning cache shared in ``root``."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("TPKT_")}
    env.update(PYTHONPATH=REPO, TPKT_AOT_DIR=os.path.join(root, "aot"),
               TPKT_INTEGRITY_DIR=os.path.join(root, "integrity"),
               TPKT_TUNING_CACHE_DIR=os.path.join(root, "tuning"),
               TPKT_HEALTH_JOURNAL=journal_path, **extra)
    return env


def loop_child(label, module, argv, env, timeout=600):
    """``python -m <module> <argv>``: its pid, rc, wall s and output;
    fails on a non-zero rc."""
    t0 = time.perf_counter()
    p = subprocess.Popen([sys.executable, "-m", module, *argv], cwd=REPO,
                         env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    try:
        out, _ = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        p.kill()
        out, _ = p.communicate()
        raise AssertionError(f"{label}: no exit in {timeout} s: "
                             f"{out[-3000:]}") from None
    wall = time.perf_counter() - t0
    if p.returncode != 0:
        raise AssertionError(f"{label}: rc {p.returncode}: {out[-3000:]}")
    return p.pid, wall, out


def loop_events(path, kind, pid=None):
    from tpukernels_torch.resilience import journal

    return [e for e in journal.load_events([path])[0]
            if e.get("kind") == kind and (pid is None or e.get("pid") == pid)]


def loop_n(mix, rate, seed, least):
    """The fewest requests whose seeded schedule gives every key of
    ``mix`` at least ``least``: ``(n, counts)``."""
    from tpukernels_torch import loadgen

    n = least * len(mix)
    while True:
        sched = loadgen.build_schedule(seed, "poisson", rate, n, None, mix)
        counts = {k: sum(1 for _, s in sched if s == k) for k in mix}
        if min(counts.values()) >= least:
            return n, counts
        n += 1


def loop_answers(torch):
    """Each key's answer at its avatar filled with ones (what the load
    generator sends), dispatched in this process and held against the
    oracle: ``{key: (crc, numpy leaves)}``."""
    from tpukernels_torch import aot, interop, loadgen, registry

    out = {}
    for key in sorted(aot.BENCH_CONFIGS):
        args, statics = loadgen.operands_np(key, "record")
        targs = interop.to_port(key, args)
        got = as_tuple(interop.from_port(registry.dispatch(key, *targs,
                                                           **statics)))
        serve_oracle_check(torch, f"11 {key} ones at its avatar", key, targs,
                           got, statics)
        out[key] = (loadgen.answer_crc(got), got)
        del targs
    return out


def loop_run_checked(label, probe, answers, want_keys):
    """A load run's ``slo_probe`` record: every key of ``want_keys`` ran,
    none dropped, no answer differed from its first, and each first
    answer is bitwise this process's (its CRC)."""
    if probe["verdicts"].keys() != set(want_keys):
        raise AssertionError(f"{label}: verdicts for "
                             f"{sorted(probe['verdicts'])}, expected "
                             f"{sorted(want_keys)}")
    dropped = sum(probe["dropped"].values())
    differ = sum(probe["mismatched"].values())
    bad = {k: c for k, c in probe["answers"].items()
           if c != answers[k][0]}
    if dropped or differ or bad or set(probe["answers"]) != set(want_keys):
        raise AssertionError(f"{label}: dropped {probe['dropped']}, "
                             f"differing {probe['mismatched']}, answers "
                             f"{probe['answers']} (CRC mismatch {bad})")


def loop_rows(label, probe, card, beside=None):
    """Print a run's per-key rows; returns them (ms)."""
    rows = {}
    for k, v in sorted(probe["verdicts"].items()):
        row = {"count": v["count"], "p50_ms": v["p50_s"] * 1e3,
               "p99_ms": v["p99_s"] * 1e3,
               "target_ms": (v["target_p99_s"] * 1e3
                             if v["target_p99_s"] is not None else None),
               "verdict": v["verdict"]}
        rows[k] = row
        extra = ""
        if beside and k in beside:
            extra = (f"; phase 7's closed-loop burst p50 "
                     f"{beside[k]['wall_ms_p50']:.3f} / p99 "
                     f"{beside[k]['wall_ms_p99']:.3f} ms")
        log(f"{label} {k}: n={v['count']}, p50 {row['p50_ms']:.3f} ms, p99 "
            f"{row['p99_ms']:.3f} ms against "
            + (f"{row['target_ms']:.1f} ms" if row["target_ms"] else "none")
            + f": {v['verdict']}{extra} [{card}]")
    late = probe["lateness_s"]
    log(f"{label} generator lateness: p50 {late['p50'] * 1e3:.3f} ms, p99 "
        f"{late['p99'] * 1e3:.3f} ms, max {late['max'] * 1e3:.3f} ms over "
        f"{late['count']} requests; wall {probe['wall_s']:.1f} s [{card}]")
    return rows


def phase_loop(torch, serve, args, card):
    """Phase 11: the serving control loop on the card (item 11 of the
    module docstring)."""
    log("== phase 11: the serving control loop (python -m "
        "tpukernels_torch.loadgen, serve.optimize, prewarm --order traffic)")
    import hashlib

    import numpy as np

    from tpukernels_torch import aot
    from tpukernels_torch.obs import slo
    from tpukernels_torch.serve import client as serve_client

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="tpkt_loop_")
    out = {"card": card}
    daemons = []
    try:
        answers = loop_answers(torch)
        log(f"PASS 11 every key's answer at its avatar of ones vs oracle "
            f"({len(answers)} keys)")

        # (11a) in process: every key, open loop
        seed = args.seed + 11
        mix = {k: 1.0 for k in sorted(aot.BENCH_CONFIGS)}
        n, counts = loop_n(mix, LOOP_RATE, seed, LOOP_LEAST)
        ja = os.path.join(root, "11a.jsonl")
        pid, wall, _ = loop_child(
            "11a loadgen", "tpukernels_torch.loadgen",
            ["--mix", "all", "--shapes", "record", "--arrivals", "poisson",
             "--rate", str(LOOP_RATE), "--requests", str(n), "--seed",
             str(seed), "--verify"],
            loop_env(root, ja, TPKT_SLO_DIR=os.path.join(root, "slo")))
        (probe,) = loop_events(ja, "slo_probe", pid)
        loop_run_checked("11a", probe, answers, mix)
        row = f"{probe['device_kind']}|record"
        if any(v["verdict"] not in (("ok", "slo_breach")
                                    if row in slo.TARGETS[k]
                                    else (slo.NO_TARGET,))
               for k, v in probe["verdicts"].items()):
            raise AssertionError(f"11a: verdicts {probe['verdicts']}")
        log(f"11a in process: {n} requests ({min(counts.values())}.."
            f"{max(counts.values())} a key), Poisson {LOOP_RATE}/s, seed "
            f"{seed}, process wall {wall:.1f} s [{card}]")
        out["in_process"] = {"requests": n, "rows": loop_rows(
            "11a", probe, card), "lateness_s": probe["lateness_s"]}
        log("PASS 11a every key in process at its avatar: 0 dropped, every "
            f"answer bitwise this process's, every verdict against the {row} "
            "row")

        # (11b) served: one daemon, three keys open loop
        burst = serve.get("burst")
        d = ServeDaemon(root, "served")
        daemons.append(d)
        d.wait_ready()
        log(f"11b daemon ready in {d.ready_s:.1f} s [{card}]")
        pid, wall, _ = loop_child(
            "11b loadgen --serve", "tpukernels_torch.loadgen",
            ["--serve", d.sock, "--mix",
             ",".join(f"{k}={w:g}" for k, w in LOOP_SERVED.items()),
             "--shapes", "record", "--arrivals", "poisson", "--rate",
             str(LOOP_SERVED_RATE), "--duration", str(LOOP_SERVED_S),
             "--requests", "0", "--seed", str(seed), "--verify"],
            loop_env(root, d.journal, TPKT_SLO_DIR=os.path.join(root, "slo")))
        (probe,) = loop_events(d.journal, "slo_probe", pid)
        loop_run_checked("11b", probe, answers, LOOP_SERVED)
        (budget,) = loop_events(d.journal, "serve_trace_budget", pid)
        served_journal = d.journal
        rows = loop_rows("11b", probe, card, burst)
        log(f"11b trace budget: {budget['assembled']} timelines, "
            f"{budget['traced']} traced, {budget['clean']} clean, coverage "
            f"mean {budget.get('coverage_mean')} low "
            f"{budget.get('coverage_low')}, phase sum / wall at most "
            f"{budget.get('sum_ratio_max')} (tolerance 1 + "
            f"{budget['sum_tol']}) [{card}]")
        if budget.get("sum_ratio_max", 0) > 1 + budget["sum_tol"]:
            raise AssertionError(f"11b trace budget inconsistent: {budget}")
        log(f"PASS 11b served open loop: {probe['requests']} requests at "
            f"{LOOP_SERVED_RATE}/s, slo.dropped 0, every answer bitwise "
            "the in-process one")
        out["served"] = {"rows": rows, "requests": probe["requests"],
                         "lateness_s": probe["lateness_s"],
                         "trace_budget": {
                             k: v for k, v in budget.items()
                             if k not in ("ts", "t", "pid", "git_head",
                                          "kind", "socket")},
                         "closed_loop_phase7": {
                             k: {"p50_ms": burst[k]["wall_ms_p50"],
                                 "p99_ms": burst[k]["wall_ms_p99"]}
                             for k in LOOP_SERVED} if burst else None}
        d.stop()

        # (11c) adaptation: traffic with waste, propose, canary
        adapt_dir = os.path.join(root, "adapt")
        os.makedirs(adapt_dir)
        table = os.path.join(adapt_dir, "buckets.json")
        with open(table, "w") as f:
            json.dump({k: {"args": [[kind, list(shape)]
                                    for kind, shape in v["args"]],
                           "statics": v["statics"]}
                       for k, v in aot.BENCH_CONFIGS.items()}, f)
        with open(table, "rb") as f:
            incumbent_sha = hashlib.sha256(f.read()).hexdigest()
        d = ServeDaemon(root, "traffic", TPKT_SERVE_BUCKETS=table)
        daemons.append(d)
        d.wait_ready()
        traffic = os.path.join(root, "traffic.json")
        with open(traffic, "w") as f:
            json.dump({"entries": [
                {"kernel": k, "args": [["i32" if k == "scan" else "f32",
                                        list(s)] for s in shapes],
                 "statics": {}, "weight": 1}
                for k, shapes in LOOP_TRAFFIC.items()]}, f)
        pid, wall, _ = loop_child(
            "11c traffic", "tpukernels_torch.loadgen",
            ["--serve", d.sock, "--shapes", traffic, "--arrivals",
             "poisson", "--rate", str(LOOP_TRAFFIC_RATE), "--requests",
             str(LOOP_TRAFFIC_N), "--seed", str(seed), "--verify"],
            loop_env(root, d.journal, TPKT_SLO_DIR=os.path.join(root, "slo")))
        (probe,) = loop_events(d.journal, "slo_probe", pid)
        if sum(probe["dropped"].values()) or \
                sum(probe["mismatched"].values()):
            raise AssertionError(f"11c traffic: {probe}")
        pads = {}
        for e in loop_events(d.journal, "serve_request"):
            if e.get("ok"):
                pads.setdefault(e["kernel"], set()).add(e["pad_frac"])
        log(f"11c traffic: {probe['requests']} requests at "
            f"{LOOP_TRAFFIC_RATE}/s under the default table, pad_frac "
            + ", ".join(f"{k} {sorted(v)}" for k, v in sorted(pads.items()))
            + f" [{card}]")
        opt_env = loop_env(root, os.path.join(root, "ops.jsonl"),
                           TPKT_ADAPT_DIR=adapt_dir, TPKT_SERVE_BUCKETS=table,
                           TPKT_SLO_DIR=os.path.join(root, "slo"),
                           TPKT_TRACE="1")
        _, wall, text = loop_child(
            "11c optimize propose", "tpukernels_torch.serve.optimize",
            ["propose", "--journal", d.journal], opt_env)
        with open(os.path.join(adapt_dir, "adapt.json")) as f:
            cand = json.load(f)
        splits = [p for p in cand["proposals"] if p["action"] == "split"]
        if cand["status"] != "proposed" or not splits:
            raise AssertionError(f"11c propose: no split: {text}")
        log(f"11c propose ({wall:.1f} s): " + text.strip().splitlines()[0])
        split_shapes = {p["kernel"]: p["spec"]["args"] for p in splits}
        _, wall, text = loop_child(
            "11c optimize canary", "tpukernels_torch.serve.optimize",
            ["canary", *LOOP_CANARY], opt_env, timeout=900)
        (ev,) = loop_events(os.path.join(root, "ops.jsonl"), "adapt_canary")
        for o in ev["orders"]:
            for s in ("incumbent", "candidate"):
                m = o[s]
                if m["dropped"] or m["requests"] == 0:
                    raise AssertionError(f"11c canary {s}: {m}")
                log(f"11c canary, {o['first']} first, {s}: pad_frac "
                    f"{m['pad_frac']:.4f}, p99 {m['p99_s'] * 1e3:.3f} ms "
                    f"over {m['requests']} requests ({m['bucketed']} "
                    "bucketed), 0 dropped; "
                    + ", ".join(f"{k} n={v['count']} p50 "
                                f"{v['p50_s'] * 1e3:.3f} / p99 "
                                f"{v['p99_s'] * 1e3:.3f} ms"
                                for k, v in m["series"].items())
                    + f" [{card}]")
            log(f"11c canary, {o['first']} first: "
                f"{'promote' if o['promote'] else 'reject'} - {o['reason']}")
        log(f"11c canary ({wall:.1f} s, four daemons in turn on the card): "
            f"{'PROMOTE' if ev['promote'] else 'REJECT'} - {ev['reason']}")
        with open(table, "rb") as f:
            after_sha = hashlib.sha256(f.read()).hexdigest()
        picked = None
        if ev["promote"]:
            with serve_client.ServeClient(d.sock, timeout_s=120) as c:
                reply = c.undrain()
                if not reply.get("ok"):
                    raise AssertionError(f"11c undrain: {reply}")
                key = next(iter(split_shapes))
                shapes = [tuple(s) for _, s in split_shapes[key]]
                ops = serve_operands(np.random.default_rng(seed), key,
                                     shapes, {})
                c.next_request_id = "loop-split-1"
                got = as_tuple(c.dispatch(key, *ops))
            want, _ = serve_in_process(torch, key, ops, {})
            serve_same(torch, f"11c {key} at the split shape vs in-process "
                       "dispatch", got, want)
            (rec,) = [e for e in loop_events(d.journal, "serve_request")
                      if e.get("request_id") == "loop-split-1"]
            if rec["pad_frac"] != 0.0 or not rec["bucketed"]:
                raise AssertionError(f"11c after undrain: {rec}")
            picked = {"kernel": key, "bucket": rec["bucket"],
                      "pad_frac": rec["pad_frac"]}
            log(f"PASS 11c promoted: after undrain a {key} request at "
                f"{shapes[1:] or shapes} landed in {rec['bucket']} with "
                "pad_frac 0.0, bitwise the in-process dispatch")
        else:
            if after_sha != incumbent_sha:
                raise AssertionError("11c rejected, but the incumbent table "
                                     "file changed")
            log("PASS 11c rejected: the incumbent table file's bytes are "
                f"unchanged (sha256 {incumbent_sha[:16]}...)")
        out["adapt"] = {"traffic_pad_frac": {k: sorted(v)
                                             for k, v in pads.items()},
                        "splits": split_shapes, "canary": ev,
                        "picked_up": picked}
        d.stop()

        # (11d) prewarm in traffic order over 11c's journal
        _, wall, text = loop_child(
            "11d prewarm --order traffic", "tpukernels_torch.prewarm",
            ["--check", "--order", "traffic"],
            loop_env(root, d.journal))
        line = next(l for l in text.splitlines()
                    if l.startswith("prewarm: traffic order "))
        order = [p.split("=")[0] for p in
                 line[len("prewarm: traffic order "):].split(", ")]
        if set(order[:2]) != set(LOOP_TRAFFIC):
            raise AssertionError(f"11d: {line}")
        log(f"PASS 11d {line} ({wall:.1f} s, a fresh process)")
        out["prewarm_order"] = order
        for j in (ja, served_journal, d.journal,
                  os.path.join(root, "ops.jsonl")):
            keep_journal(j)
        keep(served_journal, "served.jsonl")
        keep(os.path.join(root, "slo"), "slo")
        keep(adapt_dir, "adapt")
        out["phase_s"] = round(time.perf_counter() - t_phase, 3)
        log(f"phase 11 wall {out['phase_s']:.1f} s [{card}]")
        print(json.dumps({"loop": out}), flush=True)
        return out
    finally:
        for d in daemons:
            d.kill()
        shutil.rmtree(root, ignore_errors=True)


# ------------------------------------------------------------------ #
# phase 12: the fleet's operations layer                             #
# ------------------------------------------------------------------ #

# the campaign of record: seed 1, five events, two workers (the
# schedule is whatever seed 1 draws; it is printed, never re-seeded)
OPS_CAMPAIGN = ("--seed", "1", "--events", "5", "--workers", "2")
# the campaign's health windows, compressed as phase 9's (hedging stays
# on: the campaign's duplicate check accepts a hedge's replay marker)
OPS_ENV = {k: FLEET_ENV[k] for k in ("TPKT_FLEET_PROBE_S",
                                     "TPKT_FLEET_RESTART_BACKOFF_S",
                                     "TPKT_ROUTER_RESTART_BACKOFF_S",
                                     "TPKT_TRACE")}
# the pieces of the evidence phase 12b reads (phases 8 and 11)
OPS_STATE = {"TPKT_SLO_DIR": "slo", "TPKT_SCALING_DIR": "scaling",
             "TPKT_ADAPT_DIR": "adapt", "TPKT_ROLLUP_DIR": "rollup"}


def ops_child(label, module, argv, env, timeout=300, ok=(0,)):
    """``python -m <module> <argv>``: rc, wall s, stdout and stderr; fails
    on an rc outside ``ok`` (a crash included)."""
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", module, *argv], cwd=REPO,
                       env=env, capture_output=True, text=True,
                       timeout=timeout)
    wall = time.perf_counter() - t0
    if p.returncode not in ok:
        raise AssertionError(f"{label}: rc {p.returncode}\n"
                             f"{p.stdout[-4000:]}\n{p.stderr[-6000:]}")
    return p.returncode, wall, p.stdout, p.stderr


def phase_ops(card):
    """Phase 12: the seeded chaos campaign on the card, then the readers
    over this run's evidence (item 12 of the module docstring)."""
    log("== phase 12: the fleet's operations layer (python -m "
        "tpukernels_torch.serve.chaos, obs.rollup, obs.report, "
        "obs.trace_report)")
    from tpukernels_torch.resilience import journal

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="tpkt_ops_")
    out = {}
    try:
        # (12a) the campaign, on the card
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("TPKT_")}
        env.update(PYTHONPATH=REPO, TPKT_SERVE_DIR=root, **OPS_ENV)
        used0 = card_memory_used()
        _rc, wall, text, err = ops_child(
            "12a chaos", "tpukernels_torch.serve.chaos", OPS_CAMPAIGN, env,
            timeout=600)
        used1 = card_memory_used()
        # a worker's context is freed a moment after its process is gone,
        # which the campaign's teardown may not wait for: the card gets
        # up to 15 s to free it (a process left running holds it for good)
        settle_s, t_used = 15.0, time.monotonic()
        while (used0 is not None and used1 is not None
               and used1 > used0 + 256
               and time.monotonic() - t_used < settle_s):
            time.sleep(0.5)
            used1 = card_memory_used()
        settled_s = time.monotonic() - t_used
        line = next(ln for ln in err.splitlines()
                    if ln.startswith("# chaos: seed "))
        schedule = line.split("schedule: ", 1)[1].split(", ")
        verdict = text.strip().splitlines()[-1]
        if "SURVIVED" not in verdict or " 0 dropped" not in verdict:
            raise AssertionError(f"12a chaos: {verdict}\n{err[-4000:]}")
        events, _ = journal.load_events(
            [os.path.join(root, "fleet", "chaos_journal.jsonl")])
        marks = [e for e in events if e.get("kind") == "chaos_event"]
        if [e["seq"] for e in marks] != list(range(1, len(schedule) + 1)):
            raise AssertionError(f"12a chaos: markers {marks}")
        (stats,) = [e for e in events if e.get("kind") == "chaos_fleet_stats"]
        launches = {}
        for w in stats["workers"]:
            for k, v in ((w or {}).get("launches") or {}).items():
                launches[k] = launches.get(k, 0) + v
        if launches.get("scan", 0) <= 0:
            raise AssertionError(f"12a chaos: the workers launched no scan: "
                                 f"{stats}")
        left = sorted(n for n in os.listdir("/dev/shm")
                      if n.startswith("tpkserve-"))
        log(f"12a chaos schedule (seed 1, 5 events): {', '.join(schedule)}"
            + ("" if {"kill_worker", "torn_write"} <= set(schedule) else
               f"; no {' or '.join(sorted({'kill_worker', 'torn_write'} - set(schedule)))}"
               " in this schedule"))
        log(f"12a {verdict} [{card}]")
        for e in marks:
            log(f"12a chaos event {e['seq']} {e['event']}: converged in "
                f"{e['recover_s']:.3f} s"
                + "".join(f", {k} {e[k]}" for k in ("killed_pid", "worker",
                                                     "artifact")
                          if k in e))
        log(f"12a chaos workers: " + "; ".join(
            f"worker {i} served {(w or {}).get('served')} launches "
            f"{json.dumps({k: v for k, v in ((w or {}).get('launches') or {}).items() if v})}"
            for i, w in enumerate(stats["workers"])))
        for ln in err.splitlines():
            if ln.startswith(("obs.report --check", "bench trend")) or \
                    ": " in ln and ln.split(": ", 1)[1].startswith(
                        ("slo_breach", "copy_regression", "trace_",
                         "pad_waste", "overlap_low", "p99_creep")):
                log(f"12a chaos report: {ln}")
        log(f"12a chaos: the card's memory.used {used0} -> {used1} MiB "
            f"({settled_s:.1f} s after the campaign); tpkserve-* segments "
            f"left {left}; campaign wall {wall:.1f} s")
        # the workers' contexts went with them (a CUDA context holds
        # hundreds of MiB)
        if used0 is not None and used1 is not None and used1 > used0 + 256:
            raise AssertionError(f"12a chaos: the card's memory.used "
                                 f"{used0} -> {used1} MiB {settle_s:.0f} s "
                                 f"after teardown; compute apps "
                                 f"{compute_apps()}")
        log(f"PASS 12a chaos campaign on the card: rc 0, "
            f"{len(marks)} chaos_event markers, the workers launched scan "
            f"{launches['scan']} times")
        ok_n, met_n, dropped = (int(x) for x in re.search(
            r"(\d+) request\(s\) ok \((\d+) within deadline\), "
            r"(\d+) dropped", verdict).groups())
        out["chaos"] = {
            "schedule": schedule, "ok": ok_n, "within_deadline": met_n,
            "dropped": dropped, "wall_s": round(wall, 3),
            "recover_s": [e["recover_s"] for e in marks],
            "workers": stats["workers"], "memory_used_mib": [used0, used1]}
        out["launches"] = launches

        # (12b) the readers over this run's evidence
        ev = EVIDENCE["dir"]
        renv = {k: v for k, v in os.environ.items()
                if not k.startswith("TPKT_")}
        renv.update(PYTHONPATH=REPO,
                    TPKT_HEALTH_JOURNAL=os.path.join(ev, "journal"),
                    TPKT_INTEGRITY_DIR=os.environ["TPKT_INTEGRITY_DIR"],
                    **{k: os.path.join(ev, v) for k, v in OPS_STATE.items()})
        day = time.strftime("%Y-%m-%d")
        _rc, wall, text, _err = ops_child(
            "12b rollup", "tpukernels_torch.obs.rollup", ["--date", day],
            renv)
        with open(os.path.join(ev, "rollup", f"rollup_{day}.json")) as f:
            art = json.load(f)
        reqs = {k: (r["count"], r["p99"]) for k, r in
                art["requests"].items()}
        log(f"12b rollup --date {day} ({wall:.1f} s): {art['events']} "
            f"events, {art['pids']} pids, requests (count, p99 s) {reqs}")
        journal_file = os.path.join(ev, "journal", f"health_{day}.jsonl")
        rc, wall, text, _err = ops_child(
            "12b report --check", "tpukernels_torch.obs.report",
            ["--check", "--journal", journal_file], renv, ok=(0, 1))
        for ln in text.strip().splitlines():
            log(f"12b report: {ln}")
        log(f"12b report --check: rc {rc} ({wall:.1f} s)"
            + (" - a finding over phase 11's evidence, printed above; "
               "phase 11's SLO verdicts judge and never fail the script"
               if rc else ""))
        _rc, wall, text, _err = ops_child(
            "12b trace_report", "tpukernels_torch.obs.trace_report",
            [os.path.join(ev, "served.jsonl"), "--slowest", "5"], renv)
        lines = text.strip().splitlines()
        table = [ln for ln in lines[:40] if ln.startswith(("scan|",
                                                           "vector_add|",
                                                           "sgemm|"))]
        slowest = [ln for ln in lines if ln.startswith("request ")]
        log(f"12b trace_report ({wall:.1f} s): {lines[1]}")
        for ln in table + slowest:
            log(f"12b trace_report: {ln}")
        if not table or len(slowest) != 5:
            raise AssertionError(f"12b trace_report: {text[-3000:]}")
        log(f"PASS 12b readers over this run's evidence: rollup rc 0, "
            f"report --check rc {rc}, trace_report rc 0 ({len(slowest)} "
            "waterfalls)")
        out["readers"] = {"rollup_requests": reqs, "report_rc": rc,
                          "trace_rows": len(table)}
        out["phase_s"] = round(time.perf_counter() - t_phase, 3)
        log(f"phase 12 wall {out['phase_s']:.1f} s [{card}]")
        print(json.dumps({"ops": out}), flush=True)
        return out
    finally:
        subprocess.run([sys.executable, "-m", "tpukernels_torch.serve.ctl",
                        "stop-fleet", "--wait", "30"], cwd=REPO,
                       env=dict(os.environ, TPKT_SERVE_DIR=root),
                       capture_output=True, timeout=300)
        shutil.rmtree(root, ignore_errors=True)


# ------------------------------------------------------------------ #
# phase 13: the revalidation supervisor on the card                  #
# ------------------------------------------------------------------ #

# 13b's queue: production steps, in the order they are listed
SUPERVISOR_STEPS = ("prewarm_all", "slo_probe", "integrity_envelopes",
                    "rollup_daily", "fleet_fsck", "obs_check")
SUPERVISOR_SLO_S = 10   # slo_probe's load, cut from the queue's 60 s
SUPERVISOR_BENCH = "saxpy_gb_s"  # prewarm_all's bench metric (was all)
SUPERVISOR_STUCK_S = 3  # 13c's stub step's timeout
# the kernels phase 13's step children must launch: the prewarm's
# first-trust canaries and the SLO probe's avatars of every key
# (scan_histogram's fuse is off: B11 is not on the path; nor is B2)
SUPERVISOR_PATH = ("saxpy", "sgemm_prep", "sgemm_split3", "jacobi2d",
                   "jacobi3d", "nbody_forces", "scan", "histogram")


def supervisor_queue(path):
    """Write 13b's queue file: the production steps of SUPERVISOR_STEPS,
    cut in duration only (the SLO probe's load, the prewarm's bench
    metrics: one graphed metric of the seven), their ``after`` edges
    kept where the step is in the queue."""
    from tpukernels_torch import revalidate

    prod = {s.name: s for s in revalidate.PRODUCTION_QUEUE}
    fields = ("gating", "timeout_s", "cost_min", "value",
              "max_attempts_per_day", "quarantine_after", "stamp",
              "needs_chip", "inputs", "cost_from")
    steps = []
    for name in SUPERVISOR_STEPS:
        spec = prod[name]
        shell = spec.shell
        if name == "slo_probe":
            shell = shell.replace("--duration 60",
                                  f"--duration {SUPERVISOR_SLO_S}")
            if shell == spec.shell:
                raise AssertionError("13b: slo_probe's body has no "
                                     "--duration 60 to cut")
        if name == "prewarm_all":
            # one bench --prewarm child, at the metric with the largest
            # graph (21 000 SAXPY calls); phase 15 runs all seven metrics
            shell = shell.replace("--bench all ",
                                  f"--bench {SUPERVISOR_BENCH} ")
            if shell == spec.shell:
                raise AssertionError("13b: prewarm_all's body has no "
                                     "--bench all to cut")
        after = [a for a in spec.after if a in SUPERVISOR_STEPS]
        if name == "obs_check" and not after:
            # it follows the bench in production; with no bench here it
            # follows the probe whose evidence it judges in this queue
            after = ["slo_probe"]
        steps.append({"name": name, "shell": shell, "after": after,
                      **{f: getattr(spec, f) for f in fields}})
    with open(path, "w") as f:
        json.dump(steps, f)


def supervisor_records(path, kind=None):
    from tpukernels_torch.resilience import journal

    events, _ = journal.load_events([path])
    return [e for e in events if kind is None or e.get("kind") == kind]


def exit_launches(path):
    """``{kernel: launches}`` summed over the exit ``metrics`` events of a
    journal (``kernel.launches.<name>``: one event a child process)."""
    launches = {}
    for e in supervisor_records(path, "metrics"):
        for k, v in (e.get("counters") or {}).items():
            if k.startswith("kernel.launches."):
                name = k[len("kernel.launches."):]
                launches[name] = launches.get(name, 0) + v
    return launches


def phase_supervisor(card):
    """Phase 13: the revalidation supervisor on the card (item 13 of the
    module docstring)."""
    log("== phase 13: the revalidation supervisor (python -m "
        "tpukernels_torch.revalidate, obs.report, obs.health_report)")
    from tpukernels_torch import _cachedir, revalidate

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="tpkt_supervisor_")
    journal_dir = os.path.join(root, "journal")
    os.makedirs(journal_dir)
    base = {k: v for k, v in os.environ.items() if not k.startswith("TPKT_")}
    base.update(PYTHONPATH=REPO, TPKT_HEALTH_JOURNAL=journal_dir,
                TPKT_SERVE_DIR=os.path.join(root, "serve"),
                TPKT_REVALIDATE_LOCK=os.path.join(root, "gpu_wait.lock"),
                **_cachedir.state_dirs_under(os.path.join(root, "state")))

    def env(sup, plan=None):
        e = dict(base, TPKT_SUPERVISOR_DIR=os.path.join(root, sup))
        if plan is not None:
            e["TPKT_FAULT_PLAN"] = json.dumps(plan)
        return e

    def checkpoint(sup):
        return os.path.join(root, sup,
                            f"supervisor_{time.strftime('%Y-%m-%d')}.jsonl")

    def dones(sup):
        return [(e["step"], e["outcome"])
                for e in supervisor_records(checkpoint(sup), "step_done")]

    out = {"walls_s": {}}

    def revalidate_run(label, sup, argv, plan=None, ok=(0,)):
        rc, wall, text, err = ops_child(
            label, "tpukernels_torch.revalidate", argv, env(sup, plan),
            timeout=600, ok=ok)
        out["walls_s"][label] = round(wall, 3)
        for ln in (text + err).strip().splitlines():
            log(f"  {label}: {ln}")
        return rc, text, err

    used0 = card_memory_used()
    try:
        # (13a) the plan
        _rc, text, _err = revalidate_run("13a --plan", "plan", ["--plan"])
        order = [ln.split()[0] for ln in text.strip().splitlines()[2:]]
        if sorted(order) != sorted(s.name for s in
                                   revalidate.PRODUCTION_QUEUE):
            raise AssertionError(f"13a: --plan listed {order}")
        log(f"PASS 13a --plan: rc 0, the production queue's order on the "
            f"card: {', '.join(order)}; waiting: "
            + ", ".join(f"{k} ({v.split(' (')[0]})"
                        for k, v in revalidate.WAITING.items()))
        out["plan"] = order

        # (13b) production steps, a SIGKILL mid-queue and the resume
        qf = os.path.join(root, "queue.json")
        supervisor_queue(qf)
        rc, _t, _e = revalidate_run(
            "13b run 1", "sup", ["--queue", qf],
            plan={"kill_supervisor": "slo_probe"},
            ok=(-signal.SIGKILL.value,))
        starts = [e["step"] for e in
                  supervisor_records(checkpoint("sup"), "step_start")]
        if starts != ["prewarm_all", "slo_probe"] or dones("sup") != [
                ("prewarm_all", "green")]:
            raise AssertionError(f"13b run 1: started {starts}, done "
                                 f"{dones('sup')}")
        warmed = [e for e in supervisor_records(os.path.join(
            journal_dir, f"health_{time.strftime('%Y-%m-%d')}.jsonl"),
            "prewarm_kernel") if e.get("mode") == "bench"]
        if [(e["kernel"], e["status"]) for e in warmed] != [
                (SUPERVISOR_BENCH, "ok")]:
            raise AssertionError(f"13b run 1: prewarm_all's bench children "
                                 f"{warmed}")
        log("PASS 13b run 1: rc -9 (SIGKILL) after slo_probe's step_start; "
            f"prewarm_all green before it, its bench --prewarm "
            f"{SUPERVISOR_BENCH} child ok in {warmed[0]['wall_s']} s")
        revalidate_run("13b run 2", "sup", ["--queue", qf])
        got = dones("sup")[1:]
        skips = [(e["step"], e["reason"]) for e in
                 supervisor_records(checkpoint("sup"), "step_skipped")]
        resume = supervisor_records(checkpoint("sup"), "supervisor_resume")
        ran = [s for s, _o in got]
        if ("prewarm_all", "green-today") not in skips or \
                "prewarm_all" in ran or sorted(ran) != sorted(
                    set(SUPERVISOR_STEPS) - {"prewarm_all"}) or \
                any(o != "green" for _s, o in got) or \
                resume[-1]["interrupted"] != ["slo_probe"]:
            raise AssertionError(f"13b run 2: done {got}, skipped {skips}, "
                                 f"resume {resume}")
        walls = {e["step"]: e["wall_s"] for e in
                 supervisor_records(checkpoint("sup"), "step_done")}
        log("PASS 13b run 2: rc 0, prewarm_all skipped (green-today), "
            "slo_probe ran again, every step green; step walls s: "
            + ", ".join(f"{k} {v:.3f}" for k, v in walls.items()))
        out["steps"] = {"order": ["prewarm_all"] + ran, "wall_s": walls}

        # (13c) slow versus wedged, and the quarantine
        stuck = {"name": "stuck", "shell": "sleep 60",
                 "timeout_s": SUPERVISOR_STUCK_S, "cost_min": 1,
                 "value": 10}
        nxt = {"name": "next", "shell": "true", "cost_min": 1, "value": 1,
               "needs_chip": False, "stamp": "never"}
        qs = os.path.join(root, "stub.json")
        with open(qs, "w") as f:
            json.dump([dict(stuck, gating=False), nxt], f)
        revalidate_run("13c live probe", "slow", ["--queue", qs])
        probes = [e for e in supervisor_records(
            os.path.join(journal_dir, f"health_{time.strftime('%Y-%m-%d')}"
                         ".jsonl"), "probe") if not e.get("injected")]
        if dones("slow") != [("stuck", "slow"), ("next", "green")] or \
                not probes or probes[-1]["outcome"] != "alive":
            raise AssertionError(f"13c live probe: {dones('slow')}, probes "
                                 f"{probes}")
        log(f"PASS 13c live probe: stuck timed out after "
            f"{SUPERVISOR_STUCK_S} s, the probe on the card answered, "
            "classified slow (not wedged); next ran")
        with open(qs, "w") as f:
            json.dump([dict(stuck, quarantine_after=2), nxt], f)
        dead = {"probe": ["dead", "dead"]}
        for i in (1, 2):
            revalidate_run(f"13c dead probe {i}", "wedge", ["--queue", qs],
                           plan=dead, ok=(124,))
        revalidate_run("13c after the quarantine", "wedge", ["--queue", qs])
        quar = supervisor_records(checkpoint("wedge"), "step_quarantined")
        skips = [(e["step"], e["reason"]) for e in
                 supervisor_records(checkpoint("wedge"), "step_skipped")]
        if dones("wedge") != [("stuck", "wedged"), ("stuck", "wedged"),
                              ("next", "green")] or \
                [(q["step"], q["wedges"]) for q in quar] != [("stuck", 2)] \
                or ("stuck", "quarantined") not in skips:
            raise AssertionError(f"13c dead probe: {dones('wedge')}, "
                                 f"{quar}, {skips}")
        log("PASS 13c dead probe: stuck wedged twice (rc 124 each), "
            "step_quarantined after 2, the next run skipped it and ran "
            "next (rc 0)")
        out["stub"] = {"slow": dones("slow"), "wedge": dones("wedge")}

        # the card after the phase, and the launches of the step children
        used1 = card_memory_used()
        journal_file = os.path.join(
            journal_dir, f"health_{time.strftime('%Y-%m-%d')}.jsonl")
        launches = exit_launches(journal_file)
        log(f"13 the step children's launches (their exit metrics): "
            f"{json.dumps(launches, sort_keys=True)}")
        missing = [k for k in SUPERVISOR_PATH if not launches.get(k)]
        if missing:
            raise AssertionError(f"13: the step children launched no "
                                 f"{missing}: {launches}")
        log(f"13 the card's memory.used {used0} -> {used1} MiB")
        if used0 is not None and used1 is not None and used1 > used0 + 256:
            raise AssertionError(f"13: the card's memory.used {used0} -> "
                                 f"{used1} MiB: a step child left a context")

        # the readers over the phase's journal
        _rc, wall, text, _err = ops_child(
            "13 obs.report", "tpukernels_torch.obs.report",
            ["--journal", journal_file], base)
        lines = text.splitlines()
        i = next(i for i, ln in enumerate(lines)
                 if ln.startswith("== supervisor step breakdown"))
        rows = {}
        for ln in lines[i + 3:]:
            if not ln.strip() or ln.startswith("=="):
                break
            rows[ln.split()[0]] = ln
            log(f"13 obs.report: {ln}")
        want = set(SUPERVISOR_STEPS) | {"stuck", "next"}
        if set(rows) != want or "QUARANTINED" not in rows["stuck"] or \
                "slow=1" not in rows["stuck"] or \
                "wedged=2" not in rows["stuck"]:
            raise AssertionError(f"13 obs.report: {lines[i:i + 14]}")
        _rc, hwall, text, _err = ops_child(
            "13 obs.health_report", "tpukernels_torch.obs.health_report",
            [journal_file], base)
        table = [ln.strip() for ln in text.splitlines()
                 if ln.startswith("  ") and "attempts=" in ln]
        for ln in table:
            log(f"13 health_report: {ln}")
        verdict = text.strip().splitlines()[-1]
        log(f"13 health_report: {verdict}")
        log(f"PASS 13 readers: obs.report's supervisor section holds the "
            f"{len(rows)} steps and their outcomes ({wall:.1f} s), "
            f"health_report rc 0 ({hwall:.1f} s)")
        out.update(launches=launches, memory_used_mib=[used0, used1],
                   health_table=table)
        out["phase_s"] = round(time.perf_counter() - t_phase, 3)
        log(f"phase 13 wall {out['phase_s']:.1f} s [{card}]")
        print(json.dumps({"supervisor": out}), flush=True)
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ------------------------------------------------------------------ #
# phase 14: the jax-free tools on the card                           #
# ------------------------------------------------------------------ #

# 14a: each profile's predicted device-plane busy % (PERF.md §6) and
# the port's sources its top kernel must come from
PROFILE_PREDICTED = {"sgemm": (25.0, 45.0), "stencil": (90.0, 100.0)}
PROFILE_TOP = {"sgemm": ("tpukernels_torch/csrc/sgemm_ring.cuh",
                         "tpukernels_torch/csrc/sgemm_prep.cu"),
               "stencil": ("tpukernels_torch/csrc/jacobi2d.cu",)}
FUZZ_ROUNDS, FUZZ_SEED = 1, 42
# the kernels the fuzz's C hosts must launch: one draw of each driver at
# the default knobs (SGEMM `high`, scan + histogram unfused)
FUZZ_PATH = ("saxpy", "sgemm_prep", "sgemm_split3", "jacobi2d", "jacobi3d",
             "nbody_forces", "scan", "histogram")


def phase_tools(card):
    """Phase 14: the jax-free tools on the card (item 14 of the module
    docstring)."""
    log("== phase 14: the jax-free tools (python -m tpukernels_torch.profile, "
        "python -m tpukernels_torch.cgate --fuzz)")
    from tpukernels_torch import _cachedir

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="tpkt_tools_")
    base = {k: v for k, v in os.environ.items() if not k.startswith("TPKT_")}
    base.update(PYTHONPATH=REPO,
                **_cachedir.state_dirs_under(os.path.join(root, "state")))
    out = {}
    try:
        # (14a) a trace each of the two headline kernels, summarized
        _rc, wall, text, err = ops_child(
            "14a profile", "tpukernels_torch.profile",
            [os.path.join(root, "profile")], base, timeout=600)
        for ln in text.splitlines():
            if ln.startswith(("plane ", "# ")):
                log(f"  14a: {ln}")
        record = json.loads(text.strip().splitlines()[-1])["profile"]
        out["profile"] = {"wall_s": round(wall, 3)}
        for label, (lo, hi) in PROFILE_PREDICTED.items():
            planes = record[label]["planes"]
            device = [p for p in planes if p["name"].startswith("/device:")]
            if record[label]["rc"] != 0 or not device:
                raise AssertionError(f"14a {label}: no device plane "
                                     f"(rc {record[label]['rc']}): {planes}")
            dev = device[0]
            host = [p for p in planes if not p["name"].startswith("/device:")]
            log(f"14a {label}: device plane {dev['name']} busy "
                f"{dev['busy_pct']:.2f} % of {dev['span_ms']:.3f} ms "
                f"(predicted {lo:g}-{hi:g} %: "
                f"{'held' if lo <= dev['busy_pct'] <= hi else 'missed'})"
                + (f"; host plane busy {host[0]['busy_pct']:.2f} %"
                   if host else "") + f" [{card}]")
            for name, ms, src in dev["top"]:
                log(f"14a {label} top: {ms:10.3f} ms  "
                    f"{src or 'not the port'}  {name[:100]}")
            if dev["top"][0][2] not in PROFILE_TOP[label]:
                raise AssertionError(f"14a {label}: the top kernel "
                                     f"{dev['top'][0]} is not from "
                                     f"{PROFILE_TOP[label]}")
            out["profile"][label] = {
                "busy_pct": dev["busy_pct"], "span_ms": dev["span_ms"],
                "predicted_pct": [lo, hi],
                "host_busy_pct": host[0]["busy_pct"] if host else None,
                "top": dev["top"]}
        log(f"PASS 14a profile: two summaries with a device plane, each top "
            f"kernel the port's own ({wall:.1f} s)")

        # (14b) the C fuzz through the port's shim, on the card
        journal_file = os.path.join(root, "fuzz.jsonl")
        env = dict(base, TPKT_HEALTH_JOURNAL=journal_file,
                   TPKT_FUZZ_SEED=str(FUZZ_SEED))
        _rc, wall, text, err = ops_child(
            "14b cgate --fuzz", "tpukernels_torch.cgate",
            ["--fuzz", str(FUZZ_ROUNDS)], env, timeout=900, ok=(0, 1))
        rows = [ln for ln in text.splitlines() if ln.startswith("fuzz round")]
        for ln in rows:
            log(f"14b {ln}")
        verdict = text.strip().splitlines()[-1] if text.strip() else ""
        want = (f"FUZZ: PASS ({FUZZ_ROUNDS} rounds x 6 drivers x 2 devices, "
                f"seed {FUZZ_SEED})")
        if "FUZZ FAIL" in text or verdict != want or len(rows) != 12:
            raise AssertionError(f"14b fuzz: {verdict!r}\n{text[-6000:]}\n"
                                 f"{err[-4000:]}")
        launches = exit_launches(journal_file)
        log(f"14b the C hosts' launches (their exit metrics): "
            f"{json.dumps(launches, sort_keys=True)}")
        missing = [k for k in FUZZ_PATH if not launches.get(k)]
        if missing:
            raise AssertionError(f"14b: the fuzz's C hosts launched no "
                                 f"{missing}: {launches}")
        log(f"PASS 14b {verdict} ({wall:.1f} s)")
        out["fuzz"] = {"rows": rows, "launches": launches,
                       "wall_s": round(wall, 3)}
        out["phase_s"] = round(time.perf_counter() - t_phase, 3)
        log(f"phase 14 wall {out['phase_s']:.1f} s [{card}]")
        print(json.dumps({"tools": out}), flush=True)
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ------------------------------------------------------------------ #
# phase 15: the suite's bench and the tuning loop on the card         #
# ------------------------------------------------------------------ #

# phase 5's number for each bench metric's work: (phase 5 row, its key,
# the metric from ms a call); the scan + histogram chain adds an xor a
# round, and the bench's stencils and N-body run other iteration counts
BENCH_BESIDE = {
    "sgemm_gflops": ("sgemm[high]", "device_ms",
                     lambda ms, r: 2 * 1024 ** 3 / ms / 1e6),
    "saxpy_gb_s": (f"saxpy n={1 << 20}", "device_ms",
                   lambda ms, r: 12 * (1 << 20) / ms / 1e6),
    "scan_hist_melem_s": (f"scan_histogram[off] n={SCAN_N}", "device_ms",
                          lambda ms, r: SCAN_N / ms / 1e3),
    "nbody_ginter_s": ("nbody", "ms", lambda ms, r: NBODY_N ** 2 / ms / 1e6),
    "stencil2d_mcells_s": ("jacobi2d", "ms",
                           lambda ms, r: 4096 ** 2 * r["iters"] / ms / 1e3),
    "saxpy_stream_gb_s": (f"saxpy n={STREAM_N}", "device_ms",
                          lambda ms, r: 12 * STREAM_N / ms / 1e6),
    "stencil3d_mcells_s": ("jacobi3d", "ms",
                           lambda ms, r: STENCIL3D_N ** 3 * r["iters"]
                           / ms / 1e3),
}
# 15b's sweep: the control (fuse off) and the fused pass
TUNE_KERNEL, TUNE_METRIC = "scan_histogram", "scan_hist_melem_s"
# 15c: the queue's knob_sanity body, its fuse loop cut to the fused pass
# (fuse off is 15a's scan_hist_melem_s), and the kernel each of its two
# processes must launch
KNOB_LOOP = ("for fuse in off on; do", "for fuse in on; do")
KNOB_LINES = {"scan_hist fuse=on:": ("scan_histogram", "scan_hist_melem_s",
                                     None),
              "sgemm float32 (six bf16 products):": (
                  "sgemm_float32", "sgemm_gflops", "float32")}


def knob_sanity(base, root, card):
    """15c: ``revalidate``'s ``knob_sanity`` body as the queue runs it,
    its fuse loop cut to ``on``: each value a number at or under its
    ceiling, and each of its kernels launched (exit metrics)."""
    from tpukernels_torch import revalidate
    from tpukernels_torch.bench import ceilings

    shell = {s.name: s for s in revalidate.PRODUCTION_QUEUE}[
        "knob_sanity"].shell
    if KNOB_LOOP[0] not in shell:
        raise AssertionError(f"15c: knob_sanity's body has no "
                             f"{KNOB_LOOP[0]!r} to cut")
    shell = shell.replace(*KNOB_LOOP)
    journal_file = os.path.join(root, "knob.jsonl")
    t0 = time.perf_counter()
    p = subprocess.run(["bash", "-c", shell], cwd=REPO, capture_output=True,
                       text=True, timeout=900,
                       env=dict(base, TPKT_HEALTH_JOURNAL=journal_file))
    wall = time.perf_counter() - t0
    if p.returncode != 0:
        raise AssertionError(f"15c knob_sanity: rc {p.returncode}\n"
                             f"{p.stdout[-2000:]}\n{p.stderr[-6000:]}")
    launches = exit_launches(journal_file)
    values = {}
    for prefix, (kernel, metric, precision) in KNOB_LINES.items():
        hits = [ln for ln in p.stdout.splitlines() if ln.startswith(prefix)]
        value = float(hits[-1].split()[-1]) if hits else float("nan")
        ceiling = ceilings(precision)[metric]
        if not 0 < value <= ceiling or not launches.get(kernel):
            raise AssertionError(f"15c knob_sanity {prefix} {value} (ceiling "
                                 f"{ceiling}), {kernel} launched "
                                 f"{launches.get(kernel)}\n{p.stdout}")
        values[prefix.rstrip(":")] = value
        log(f"15c knob_sanity {prefix} {value} {metric} ({value / ceiling:.1%}"
            f" of its ceiling {ceiling}); {kernel} launched "
            f"{launches[kernel]} [{card}]")
    log(f"PASS 15c knob_sanity's body (fuse loop cut to on): rc 0 in "
        f"{wall:.1f} s")
    return {"values": values, "wall_s": round(wall, 3)}


# 15d: the metric the gate's rc 1 case scales, and the one its rc 2 case
# empties (neither the headline)
EVIDENCE_SCALED, EVIDENCE_NULLED = "nbody_ginter_s", "stencil3d_mcells_s"


def gate(line, **env):
    """``bench.check_regression`` on ``line`` in this process (what
    ``--check-regression`` runs, without a child's start) under ``env``:
    ``(rc, what it printed)``."""
    from tpukernels_torch import bench

    out = io.StringIO()
    with knobs(**env), contextlib.redirect_stdout(out):
        rc = bench.check_regression(json.dumps(line))
    return rc, out.getvalue().strip()


def bench_evidence(base, root, card, line):
    """15d: the bench's evidence layer on 15a's line (item 15 (d) of the
    module docstring)."""
    from tpukernels_torch import bench, revalidate
    from tpukernels_torch.obs import trend
    from tpukernels_torch.tuning import roofline

    t0 = time.perf_counter()
    names = [n for n, _fn in bench.BENCH_METRICS]
    bdir = os.path.join(root, "evidence")
    os.makedirs(bdir)
    first = os.path.join(bdir, time.strftime("bench_%Y-%m-%d_%H%M%S.json"))
    with open(first, "w") as f:
        f.write(json.dumps(line) + "\n")
    # a copy of the committed baseline without its medians, so that they
    # cannot refuse this run's
    from tpukernels_torch import _cachedir

    with open(_cachedir.bench_baseline_path({})) as f:
        committed = json.load(f)
    tmp_base = os.path.join(root, "baseline_h100.json")
    with open(tmp_base, "w") as f:
        json.dump(dict(committed, measured={}), f)
    env = dict(base, TPKT_BENCH_DIR=bdir, TPKT_BENCH_BASELINE=tmp_base,
               TPKT_HEALTH_JOURNAL=os.path.join(root, "evidence.jsonl"))
    from tpukernels_torch import promote_baseline

    # in this process (no child's start): what the CLI runs
    with knobs(TPKT_BENCH_DIR=bdir, TPKT_BENCH_BASELINE=tmp_base):
        _measured, text = promote_baseline.promote(run="15d")
    with open(tmp_base) as f:
        promoted = json.load(f)["measured"]
    want = {n: round(float(line["details"][n]), 2) for n in names}
    if {n: promoted.get(n) for n in names} != want or \
            promoted.get("measured_from", {}).get("artifact") != \
            os.path.basename(first):
        raise AssertionError(f"15d promote_baseline wrote {promoted}, not "
                             f"15a's {want}\n{text}")
    log(f"PASS 15d promote_baseline: 15a's artifact "
        f"{os.path.basename(first)} into a copy of baseline_h100.json "
        f"(seven medians, measured_from {promoted['measured_from']})")

    def judged(details):
        base_tbl = {"measured": promoted}
        return dict(line, details=details,
                    vs_measured=bench._ratios_vs_baseline(details, base_tbl))

    cases = (("15a's line", dict(line["details"]), 0),
             (f"{EVIDENCE_SCALED} x 0.8",
              dict(line["details"], **{EVIDENCE_SCALED: round(
                  line["details"][EVIDENCE_SCALED] * 0.8, 2)}), 1),
             (f"{EVIDENCE_NULLED} null",
              dict(line["details"], **{EVIDENCE_NULLED: None}), 2))
    gates = {}
    for label, details, want_rc in cases:
        rc, out = gate(judged(details), TPKT_BENCH_DIR=bdir,
                       TPKT_BENCH_BASELINE=tmp_base)
        log(f"15d gate on {label}: rc {rc} (want {want_rc}): "
            + " | ".join(out.splitlines()))
        if rc != want_rc:
            raise AssertionError(f"15d gate on {label}: rc {rc}, not "
                                 f"{want_rc}\n{out}")
        gates[label] = rc
    log("PASS 15d the gate's exit codes: 0 on 15a's line, 1 with one metric "
        "at 0.8x, 2 with one metric null")

    # the queue's bench step, as a watch runs it: only the canary is
    # measured, the six others carried from 15a's artifact
    shell = {s.name: s for s in revalidate.PRODUCTION_QUEUE}["bench"].shell
    t1 = time.perf_counter()
    p = subprocess.run(["bash", "-c", shell], cwd=REPO, capture_output=True,
                       text=True, timeout=900,
                       env=dict(env, TPKT_BENCH_SKIP_CAPTURED="1"))
    step_s = time.perf_counter() - t1
    children = [ln.split()[2] for ln in p.stderr.splitlines()
                if ln.startswith("# one: ") and ln.endswith(" starting")]
    union_line = json.loads([ln for ln in p.stdout.splitlines()
                             if ln.startswith("{")][-1])
    carried = sorted(union_line.get("carried") or {})
    skips = supervisor_records(env["TPKT_HEALTH_JOURNAL"], "skip_captured")
    written = sorted(os.listdir(bdir))
    log(f"15d bench step under TPKT_BENCH_SKIP_CAPTURED=1: rc {p.returncode}"
        f" in {step_s:.1f} s; --one children {children}; carried {carried};"
        f" sgemm_gflops {union_line['details'].get('sgemm_gflops')}; "
        f"artifacts {written}; the gate: "
        + " | ".join(ln for ln in p.stdout.splitlines()
                     if not ln.startswith("{")))
    if (p.returncode != 0 or children != ["sgemm_gflops"]
            or carried != sorted(names[1:]) or len(written) != 2
            or not skips or skips[-1]["measuring"] != ["sgemm_gflops"]
            or "regression check OK over persisted union" not in p.stdout):
        raise AssertionError(f"15d bench step: rc {p.returncode}\n"
                             f"{p.stdout}\n{p.stderr[-6000:]}")
    log("PASS 15d the union path: one --one child (sgemm_gflops), six "
        "carried, the union gate rc 0")

    reports = {}
    for flag in ("--check", "--roofline"):
        rc, _w, out, _e = ops_child(f"15d obs.report {flag}",
                                    "tpukernels_torch.obs.report", [flag],
                                    env, ok=(0, 1))
        reports[flag] = rc
        log(f"15d obs.report {flag}: rc {rc}")
        for ln in out.splitlines():
            if flag == "--roofline" or ":" in ln:
                log(f"  15d {ln}")
    saved = {k: os.environ.get(k) for k in ("TPKT_BENCH_BASELINE",)}
    os.environ["TPKT_BENCH_BASELINE"] = tmp_base
    try:
        rows = roofline.report_rows(trend.analyze_repo(bdir))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    table = {}
    for r in rows:
        if r["device_kind"] != "h100" or r["achieved"] is None:
            raise AssertionError(f"15d roofline row {r}")
        table[r["metric"]] = {k: r[k] for k in (
            "achieved", "peak", "frac", "bound", "ceiling", "ceiling_frac",
            "verdict")}
        cfrac = ("none (L2-resident)" if r["ceiling_frac"] is None
                 else f"{r['ceiling_frac']:.1%} of ceiling {r['ceiling']}")
        log(f"15d roofline {r['metric']}: achieved {r['achieved']}, peak "
            f"{r['peak']:.1f} ({r['bound']}-bound), {r['frac']:.1%} of the "
            f"roofline, {cfrac}, verdict {r['verdict']} [{card}]")
    if reports["--roofline"] not in (0, 1) or sorted(table) != sorted(names):
        raise AssertionError(f"15d roofline: {reports} {sorted(table)}")
    log("PASS 15d obs.report --check and --roofline over the evidence: "
        "seven h100 rows")

    # the committed medians: judged, never failing the script
    rc, out = gate(line, TPKT_BENCH_DIR=bdir, TPKT_BENCH_BASELINE=None)
    log(f"15d 15a's line against the committed baseline_h100.json: rc {rc} "
        f"(judged, never fails the script): " + " | ".join(out.splitlines()))
    wall = time.perf_counter() - t0
    log(f"15d wall {wall:.1f} s [{card}]")
    return {"gates": gates, "union": {"rc": p.returncode,
                                      "children": children,
                                      "carried": carried,
                                      "wall_s": round(step_s, 3)},
            "reports": reports, "roofline": table, "committed_rc": rc,
            "committed_ratios": line.get("vs_measured"),
            "wall_s": round(wall, 3)}


def phase_bench(card, times):
    """Phase 15: the suite's bench and the tuning loop on the card (item
    15 of the module docstring)."""
    log("== phase 15: the bench and the tuning loop (python -m "
        "tpukernels_torch.bench, python -m tpukernels_torch.autotune)")
    from tpukernels_torch import _cachedir
    from tpukernels_torch.bench import BENCH_METRICS

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="tpkt_bench_")
    base = {k: v for k, v in os.environ.items() if not k.startswith("TPKT_")}
    base.update(PYTHONPATH=REPO, TPKT_BENCH_PROBE_ATTEMPTS="1",
                **_cachedir.state_dirs_under(os.path.join(root, "state")))
    if os.environ.get("TPKT_GIT_HEAD"):  # a copy without .git: its commit
        base["TPKT_GIT_HEAD"] = os.environ["TPKT_GIT_HEAD"]
    repo_cache = os.path.join(REPO, ".tpkt_cache", "tuning.json")
    cache_before = (os.stat(repo_cache).st_mtime_ns
                    if os.path.exists(repo_cache) else None)
    out = {}
    try:
        # (15a) the whole bench
        journal_file = os.path.join(root, "bench.jsonl")
        _rc, wall, text, err = ops_child(
            "15a bench", "tpukernels_torch.bench", [],
            dict(base, TPKT_HEALTH_JOURNAL=journal_file), timeout=900)
        line = json.loads(text.strip().splitlines()[-1])
        log(f"15a bench line: {json.dumps(line)}")
        for ln in err.splitlines():
            if ln.startswith("# graph R="):
                log(f"  15a {ln[2:]}")
        bad = []
        for name, _fn in BENCH_METRICS:
            value, host = line["details"][name], \
                line["details"][f"{name}_host"]
            ceiling = line["ceilings"].get(name)
            if value is None or host is None:
                bad.append(f"{name}: {line.get('reasons', {}).get(name)}")
                continue
            if ceiling is not None and max(value, host) > ceiling:
                bad.append(f"{name}: {max(value, host)} over {ceiling}")
            row_label, key, rate = BENCH_BESIDE[name]
            row = times[row_label]
            p5 = rate(row[key], row)
            caps = line.get("captures", {}).get(name, [])
            log(f"15a {name}: {value:.2f} ({line['timing'].get(name)}), "
                f"host-issued {host:.2f} ({value / host:.2f}x); phase 5's "
                f"{row_label} {key} {row[key]:.4f} ms gives {p5:.2f}, "
                f"ratio {value / p5:.3f}; ceiling "
                + ("none (L2-resident)" if ceiling is None
                   else f"{ceiling:.1f} ({value / ceiling:.1%})")
                + "".join(f"; R={c['R']} capture {c['capture_s']} s "
                          f"instantiate {c['instantiate_s']} s pool "
                          f"{c['pool_peak_mib']} MiB" for c in caps)
                + f" [{card}]")
        if line.get("invalidated"):
            bad.append(f"invalidated: {line['invalidated']}")
        if bad:
            raise AssertionError("15a bench: " + "; ".join(bad)
                                 + f"\n{err[-6000:]}")
        launches = exit_launches(journal_file)
        log(f"15a the bench children's launches (their exit metrics): "
            f"{json.dumps(launches, sort_keys=True)}")
        log(f"PASS 15a bench: seven metrics, none null, invalidated or over "
            f"its ceiling ({wall:.1f} s)")
        out["bench"] = {"line": line, "wall_s": round(wall, 3)}

        # (15b) one sweep of scan_histogram's fuse, then the read side
        tune_dir = os.path.join(root, "tune")
        env = dict(base, TPKT_TUNING_CACHE_DIR=tune_dir,
                   TPKT_HEALTH_JOURNAL=os.path.join(root, "tune.jsonl"))
        _rc, wall_t, text, err = ops_child(
            "15b autotune", "tpukernels_torch.autotune",
            ["--kernel", TUNE_KERNEL, "--quick"], env, timeout=900)
        for ln in text.splitlines():
            log(f"  15b {ln}")
        cands = supervisor_records(env["TPKT_HEALTH_JOURNAL"],
                                   "tuning_candidate")
        values = {c["params"]["fuse"]: c["value"] for c in cands}
        if sorted(values) != ["off", "on"] or None in values.values():
            raise AssertionError(f"15b: candidates {cands}")
        (promo,) = supervisor_records(env["TPKT_HEALTH_JOURNAL"],
                                      "tuning_sweep_end") or [None]
        promoted = (promo or {}).get("promoted")
        _rc, wall_o, text, err = ops_child(
            "15b bench --one", "tpukernels_torch.bench",
            ["--one", TUNE_METRIC], env, timeout=600)
        resolved = [e for e in supervisor_records(
            env["TPKT_HEALTH_JOURNAL"], "tuning_resolved")
            if e.get("kernel") == TUNE_KERNEL]
        one = json.loads(text.strip().splitlines()[-1])
        gain = values["on"] / values["off"] - 1
        log(f"15b fuse=off (control) {values['off']:.2f}, fuse=on "
            f"{values['on']:.2f} {TUNE_METRIC} ({gain:+.1%}; margin 3%); "
            f"promoted {promoted}; bench --one on the tuned cache "
            f"{one['value']:.2f} [{card}]")
        if promoted:
            if not resolved or resolved[-1]["params"] != promoted or \
                    set(resolved[-1]["sources"].values()) != {"cache"}:
                raise AssertionError(f"15b: bench --one resolved "
                                     f"{resolved}, not {promoted}")
            log(f"PASS 15b promoted {promoted} and bench --one resolved it "
                f"from the cache ({wall_t:.1f} + {wall_o:.1f} s)")
        else:
            if resolved:
                raise AssertionError(f"15b: nothing promoted, yet "
                                     f"resolved {resolved}")
            log(f"PASS 15b nothing promoted (fuse=on {gain:+.1%}, under the "
                f"3% margin); bench --one ran at the defaults ({wall_t:.1f} "
                f"+ {wall_o:.1f} s)")
        after = (os.stat(repo_cache).st_mtime_ns
                 if os.path.exists(repo_cache) else None)
        if after != cache_before:
            raise AssertionError("15b wrote the repository's tuning cache")
        out["tune"] = {"values": values, "gain": round(gain, 4),
                       "promoted": promoted, "one": one,
                       "wall_s": round(wall_t + wall_o, 3)}

        # (15c) the queue's knob_sanity body on the card
        out["knob_sanity"] = knob_sanity(base, root, card)
        for path in (env["TPKT_HEALTH_JOURNAL"],
                     os.path.join(root, "knob.jsonl")):
            for k, v in exit_launches(path).items():
                launches[k] = launches.get(k, 0) + v
        # (15d) the evidence layer on 15a's line
        out["evidence"] = bench_evidence(base, root, card, line)
        for k, v in exit_launches(os.path.join(root,
                                               "evidence.jsonl")).items():
            launches[k] = launches.get(k, 0) + v
        out["launches"] = launches
        out["phase_s"] = round(time.perf_counter() - t_phase, 3)
        log(f"phase 15 wall {out['phase_s']:.1f} s [{card}]")
        print(json.dumps({"bench": out}), flush=True)
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


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

    # the integrity guard's state, the compile discipline's manifest and
    # the journal live in a temporary directory; the guard runs as
    # shipped (no plan, full, sample 64), the compile discipline on
    state = tempfile.mkdtemp(prefix="tpkt_smoke_")
    for var in ("TPKT_FAULT_PLAN", "TPKT_INTEGRITY", "TPKT_INTEGRITY_SAMPLE",
                "TPKT_INTEGRITY_QUARANTINE_AFTER", "TPKT_TRACE",
                "TPKT_AOT_CACHE"):
        os.environ.pop(var, None)
    os.environ["TPKT_INTEGRITY_DIR"] = os.path.join(state, "integrity")
    os.environ["TPKT_AOT_DIR"] = os.path.join(state, "aot")
    os.environ["TPKT_HEALTH_JOURNAL"] = os.path.join(state, "health.jsonl")
    EVIDENCE["dir"] = os.path.join(state, "evidence")
    share_bytecode(os.path.join(state, "pycache"))
    become_subreaper()
    try:
        return run_all(torch, args)
    finally:
        stop_leftovers()
        # the metrics exit flush must not write into the removed directory
        os.environ.pop("TPKT_HEALTH_JOURNAL", None)
        shutil.rmtree(state, ignore_errors=True)


T0 = time.perf_counter()  # the script's start, for the wall it prints


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
    t5 = time.perf_counter()
    times = phase_times(torch, gen, peaks, nbody)
    log(f"phase 5 wall {time.perf_counter() - t5:.1f} s [{card}]")
    guard_costs(guarded, times)
    c_entry = phase_c_entry(torch, times)
    report_leftovers("phase 6")
    avatars = {}
    serve = phase_serve(torch, times, c_entry["rates"], args, avatars)
    report_leftovers("phase 7")
    dist = phase_dist(torch, times, peaks, args)
    report_leftovers("phase 8")
    fleet = phase_fleet(torch, serve, avatars, args)
    report_leftovers("phase 9")
    del avatars
    phase_compile(torch, guarded)
    report_leftovers("phase 10")
    phase_loop(torch, serve, args, card)
    report_leftovers("phase 11")
    ops = phase_ops(card)
    report_leftovers("phase 12")
    sup = phase_supervisor(card)
    report_leftovers("phase 13")
    phase_tools(card)
    report_leftovers("phase 14")
    bench = phase_bench(card, times)
    report_leftovers("phase 15")

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
                "serve_tier_launches":
                    serve["tier"]["launches"].get(name, 0),
                "fleet_launches": fleet["launches"].get(name, 0),
                "chaos_launches": ops["launches"].get(name, 0),
                "supervisor_launches": sup["launches"].get(name, 0),
                "bench_launches": bench["launches"].get(name, 0),
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
        "serve_tier_launches":
            serve["tier"]["launches"].get("sgemm_prep", 0),
        "fleet_launches": fleet["launches"].get("sgemm_prep", 0),
        "chaos_launches": ops["launches"].get("sgemm_prep", 0),
        "supervisor_launches": sup["launches"].get("sgemm_prep", 0),
        "bench_launches": bench["launches"].get("sgemm_prep", 0),
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
        "serve_tier_launches":
            serve["tier"]["launches"].get("nbody_forces_ij", 0),
        "fleet_launches": fleet["launches"].get("nbody_forces_ij", 0),
        "chaos_launches": ops["launches"].get("nbody_forces_ij", 0),
        "supervisor_launches": sup["launches"].get("nbody_forces_ij", 0),
        "bench_launches": bench["launches"].get("nbody_forces_ij", 0),
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
           "library_device_ms", "library_device_how", "launches_per_call",
           "bound_ms", "bound_by")
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
                         library_device_ms=t["library_device_ms"],
                         library_device_how=t["library_device_how"],
                         stream=at(f"histogram {big}", *one),
                         wide=[at(f"histogram[{WIDE_NBINS}] {size}", "nbins",
                                  *one) for size in (rec, big)]))
    t = times[f"scan_histogram[on] {rec}"]
    kernels.append(entry(
        "scan_histogram", by_id["B11"], t, errs["scan_histogram"], n=SCAN_N,
        nbins=SCAN_NBINS, fuse="on",
        **{k: t[k] for k in ("scan_hist_melem_s", "device_ms",
                             "launches_per_call", "per_tile_device_ms",
                             "library_device_ms", "library_device_how")},
        stream=at(f"scan_histogram[on] {big}", *sh, "per_tile_device_ms"),
        off=[at(f"scan_histogram[off] {size}", *sh) for size in (rec, big)]))
    log(f"chip_smoke wall {time.perf_counter() - T0:.1f} s [{card}]")
    log(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
