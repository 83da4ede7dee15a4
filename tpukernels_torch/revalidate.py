"""Checkpointed revalidation queue of the port, on the H100.

Usage:
    python -m tpukernels_torch.revalidate                 # one queue attempt
    python -m tpukernels_torch.revalidate --wait [--max-hours H]
    python -m tpukernels_torch.revalidate --plan          # schedule only
    python -m tpukernels_torch.revalidate --whos-holding  # lock diagnosis
    python -m tpukernels_torch.revalidate --queue FILE    # custom steps

The port's copy of ``tools/revalidate.py``. :data:`PRODUCTION_QUEUE` is
the reference's queue with the port's bodies: each step keeps its name,
gating, stamp policy, timeout, device-minute cost, value, dependencies,
``needs_chip`` and attempts a day; only its shell body and its
``inputs`` change (and ``obs_check``'s dependencies, as the bench's).
:data:`WAITING` would name a step that waits for a module the port does
not have yet, with the ROADMAP Queue A item it waits for; it is empty,
so the queue names every step of the reference's. After the first green
queue of a ``--wait``, the production queue's harvest runs one
best-effort SGEMM sweep (:func:`_harvest`), as the reference's does.
The queue logic (stamps, checkpoint resume, quarantine, admission,
backoff) is ``resilience/supervisor.py``; this process never imports
torch, and only its step and probe children touch the card.

State: ``_cachedir.supervisor_dir()`` (``TPKT_SUPERVISOR_DIR``, default
``.tpkt_cache/supervisor``) holds the checkpoint, the stamps and the
steps' logs (``logs/``); with no ``TPKT_HEALTH_JOURNAL`` the journal is
a dated ``health_<date>.jsonl`` there too, shared with the step
children. The other state (the AOT manifest, ``slo.json``, the serve
dir, ...) is each module's own, under ``.tpkt_cache`` unless its
``TPKT_*_DIR`` knob moves it.

The lock: a queue run and ``--wait`` hold ``flock`` on
``$HOME/.tpkt_gpu_wait.lock`` (``TPKT_REVALIDATE_LOCK`` moves it) on
fd 9, and write their pid into it, so step children inherit the lock
and probe children do not. The reference takes its lock in the shell
wrappers (``tools/tpu_wait_and_revalidate.sh``); here the CLI takes it.
A held lock is waited for ``TPKT_REVALIDATE_LOCK_WAIT_S`` seconds
(default 1800 with ``--wait``, 0 without) and then gives rc 3.

Exit codes (the reference's contract):
    0   — the queue is green (quarantined steps reported loudly);
    2   — incomplete but nothing regressed (deferred steps), retryable;
    124 — a step wedged or timed out, retryable;
    3   — the lock is held by another queue;
    64  — usage error (never 2, which the watch loop retries);
    else — a gating step failed loudly with that rc.

``--queue FILE`` / ``TPKT_SUPERVISOR_QUEUE`` name a JSON list of step
specs (``supervisor.StepSpec``): how the CPU tests drive the real
supervisor against stub steps, and how an operator runs a cut-down
queue. ``--whos-holding`` reads the pid in the lock file, tests the
flock, classifies the holder from ``/proc/<pid>/cmdline`` and says what
to do (rc 0 not held, 3 held).
"""

from __future__ import annotations

import os
import sys
import time

from tpukernels_torch import _cachedir
from tpukernels_torch.resilience import supervisor

S = supervisor.StepSpec

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_LOGS = '"$TPKT_SUPERVISOR_DIR/logs"'
# the keys the served probes send: those obs/slo.py's H100 row judges
_SERVED_MIX = "vector_add=1,scan=1,sgemm=1"

# The reference's steps, one spec each, in its declaration order;
# EXECUTION order is value a device-minute under the `after` edges
# (supervisor.plan). Bodies run in the repository root with
# TPKT_SUPERVISOR_DIR and TPKT_HEALTH_JOURNAL set by main().
PRODUCTION_QUEUE = [
    # every registry key built, loaded, planned and trusted at its
    # configuration of record, in traffic order, so the window after it
    # measures instead of building. Non-gating, stamped daily on success
    # with git-aware inputs, two attempts a day (a deterministic failure,
    # rc 1, is not a wedge, and quarantine never catches it);
    # cost_from="prewarm" re-derives its device-minute cost from the
    # journal's prewarm_kernel walls. `--bench all` also builds and warms
    # the bench's chains, one killable child a metric.
    S("prewarm_all", f"""
set -o pipefail
mkdir -p {_LOGS}
prewarm_log={_LOGS}/"prewarm_$(date +%Y-%m-%d_%H%M%S).log"
if timeout -k 10 3540 python3 -m tpukernels_torch.prewarm --bench all \\
    --check --order traffic --timeout-s 420 >"$prewarm_log" 2>&1; then
  tail -1 "$prewarm_log"
else
  echo "WARN: prewarm_all failed rc=$? (non-gating) -" \\
       "$prewarm_log is the postmortem evidence"
  exit 1
fi
""", gating=False, stamp="daily", timeout_s=3600, cost_min=12,
      value=50, cost_from="prewarm", max_attempts_per_day=2,
      inputs=("tpukernels_torch",)),
    # 60 s of open-loop Poisson load in process on the card at the
    # configurations of record, judged against obs/slo.py's H100 row
    # and persisted to slo.json; never stamped, after the prewarm so it
    # measures the warm path
    S("slo_probe", f"""
set -o pipefail
mkdir -p {_LOGS}
slo_log={_LOGS}/"slo_probe_$(date +%Y-%m-%d_%H%M%S).log"
if timeout -k 10 120 python3 -m tpukernels_torch.loadgen --mix all \\
    --arrivals poisson --duration 60 --rate 8 --requests 0 \\
    --shapes record >"$slo_log" 2>&1; then
  tail -1 "$slo_log"
else
  echo "WARN: slo probe failed rc=$? (non-gating) - $slo_log"
  exit 1
fi
""", gating=False, stamp="never", timeout_s=150, cost_min=2,
      value=12, after=("prewarm_all",),
      inputs=("tpukernels_torch/loadgen.py", "tpukernels_torch/obs")),
    # load through the serving daemon, 30 s traced (seeded, with
    # generous deadlines) and 30 s untraced; the daemon stops whatever
    # the loadgen rcs, so a failed burst leaks no daemon. The reference
    # sends all nine keys at 8/s; through the port's daemon the 3-D
    # avatar alone (216 MiB each way) takes about 1.9 s a request, so
    # that load never drains (both halves hit their 70 s timeout on the
    # H100): the port sends the three keys its H100 SLO row judges at
    # chip_smoke.py phase 11b's 5/s
    S("serve_probe", f"""
set -o pipefail
mkdir -p {_LOGS}
serve_log={_LOGS}/"serve_probe_$(date +%Y-%m-%d_%H%M%S).log"
serve_probe_body() {{
  env TPKT_TRACE=1 python3 -m tpukernels_torch.serve.ctl start --wait 30 \\
      || return $?
  timeout -k 10 70 env TPKT_TRACE=1 python3 -m tpukernels_torch.loadgen \\
      --serve default --mix {_SERVED_MIX} --arrivals poisson \\
      --duration 30 --rate 5 --requests 0 --shapes record --seed 5 \\
      --deadline-ms 30000
  rc_traced=$?
  timeout -k 10 70 python3 -m tpukernels_torch.loadgen --serve default \\
      --mix {_SERVED_MIX} --arrivals poisson --duration 30 --rate 5 \\
      --requests 0 --shapes record
  rc=$?
  python3 -m tpukernels_torch.serve.ctl stop
  [ $rc_traced -eq 0 ] && [ $rc -eq 0 ]
}}
if serve_probe_body >"$serve_log" 2>&1; then
  tail -1 "$serve_log"
else
  echo "WARN: serve probe failed rc=$? (non-gating) - $serve_log"
  exit 1
fi
""", gating=False, stamp="never", timeout_s=200, cost_min=2, value=10,
      after=("prewarm_all",),
      inputs=("tpukernels_torch/serve", "tpukernels_torch/loadgen.py")),
    # a two-worker fleet under a hot bursty tenant and a steady traced
    # one for 60 s: worker 0 drained and restored, worker 1 killed -9
    # and healed, the router killed -9 and respawned by its guardian,
    # then a clean stop; every rc is part of the verdict. The mix and
    # the hot rate are serve_probe's (the reference's nine keys at 10/s
    # left the hot tenant undrained at its 120 s timeout on the H100),
    # and the clients ride out the router's respawn for up to 60 s, as
    # the chaos campaign's do (the 5 s default dropped a request there)
    S("fleet_probe", f"""
set -o pipefail
mkdir -p {_LOGS}
fleet_log={_LOGS}/"fleet_probe_$(date +%Y-%m-%d_%H%M%S).log"
fleet_probe_body() {{
  env TPKT_TRACE=1 python3 -m tpukernels_torch.serve.ctl start-fleet 2 \\
      --wait 60 || return $?
  python3 -m tpukernels_torch.serve.ctl guardian --wait 30 || return $?
  front=$(python3 -c "from tpukernels_torch.serve import fleet
print(fleet.front_socket_path())")
  export TPKT_CLIENT_RECONNECT_S=60
  timeout -k 10 120 python3 -m tpukernels_torch.loadgen --serve "$front" \\
      --mix {_SERVED_MIX} --arrivals bursty --duration 60 --rate 5 \\
      --requests 0 --shapes record --tenant hot &
  lg_hot=$!
  timeout -k 10 120 env TPKT_TRACE=1 python3 -m tpukernels_torch.loadgen \\
      --serve "$front" \\
      --mix {_SERVED_MIX} --arrivals poisson --duration 60 --rate 2 \\
      --requests 0 --shapes record --tenant steady --seed 3 &
  lg_steady=$!
  sleep 20
  python3 -m tpukernels_torch.serve.ctl drain 0 --wait 30; rc_drain=$?
  python3 -m tpukernels_torch.serve.ctl undrain 0 --wait 30; rc_undrain=$?
  w1pid=$(head -1 "$(python3 -c "from tpukernels_torch.serve import fleet
print(fleet.worker_dir(1))")/serve.pid")
  kill -9 "$w1pid"
  python3 -m tpukernels_torch.serve.ctl health --wait 90; rc_heal=$?
  rpid=$(head -1 "$(python3 -c "from tpukernels_torch.serve import fleet
print(fleet.router_pidfile_path())")")
  kill -9 "$rpid"
  rc_heal2=1
  for _i in $(seq 90); do
    if python3 -m tpukernels_torch.serve.ctl status >/dev/null 2>&1; then
      rc_heal2=0; break
    fi
    sleep 1
  done
  python3 -m tpukernels_torch.serve.ctl health --wait 90 || rc_heal2=1
  wait $lg_hot; rc_hot=$?
  wait $lg_steady; rc_steady=$?
  python3 -m tpukernels_torch.serve.ctl stop-fleet
  [ $rc_hot -eq 0 ] && [ $rc_steady -eq 0 ] && \\
    [ $rc_drain -eq 0 ] && [ $rc_undrain -eq 0 ] && \\
    [ $rc_heal -eq 0 ] && [ $rc_heal2 -eq 0 ]
}}
if fleet_probe_body >"$fleet_log" 2>&1; then
  tail -1 "$fleet_log"
else
  echo "WARN: fleet probe failed rc=$? (non-gating) - $fleet_log"
  exit 1
fi
""", gating=False, stamp="never", timeout_s=420, cost_min=3, value=9,
      after=("prewarm_all",),
      inputs=("tpukernels_torch/serve", "tpukernels_torch/loadgen.py")),
    # the collective bandwidth sweep (one NCCL rank a card), and one 2-D
    # mesh point when the host has four cards or more (asked in a child,
    # so this process never opens a CUDA context)
    S("busbw_sweep", f"""
set -o pipefail
mkdir -p {_LOGS}
busbw_log={_LOGS}/"busbw_$(date +%Y-%m-%d_%H%M%S).log"
if timeout -k 10 240 python3 -m tpukernels_torch.parallel.busbw \\
    --max=16M --reps=5 >"$busbw_log" 2>&1; then
  tail -2 "$busbw_log"
else
  echo "WARN: busbw sweep failed rc=$? (non-gating) - $busbw_log"
  exit 1
fi
ndev=$(python3 -c "import torch; print(torch.cuda.device_count())" \\
    2>/dev/null)
if [ "${{ndev:-0}}" -ge 4 ]; then
  if timeout -k 10 240 python3 -m tpukernels_torch.parallel.busbw \\
      --mesh=2x$((ndev / 2)) --max=4M --reps=5 \\
      >>"$busbw_log" 2>&1; then
    tail -2 "$busbw_log"
  else
    echo "WARN: 2-D busbw sweep failed rc=$? (non-gating) - $busbw_log"
    exit 1
  fi
fi
""", gating=False, stamp="never", timeout_s=540, cost_min=3, value=11,
      after=("prewarm_all",),
      inputs=("tpukernels_torch/parallel",
              "tpukernels_torch/obs/scaling.py")),
    # the seven metrics and the 15 % gate against the port's H100
    # medians; the line is persisted as $TPKT_BENCH_DIR/bench_<stamp>.json,
    # so an unattended run leaves its evidence. Never stamped: its
    # skip-captured logic keeps it cheap and the SGEMM canary runs every
    # attempt. Under TPKT_BENCH_SKIP_CAPTURED=1 (the watch's mode) it
    # measures only what the persisted union lacks and judges the union
    S("bench", f"""
set -e -o pipefail
union_flag=""
if [ "${{TPKT_BENCH_SKIP_CAPTURED:-}}" = "1" ]; then
  union_flag="--union-persisted"
fi
bench_dir=$(python3 -c "from tpukernels_torch import _cachedir
print(_cachedir.bench_dir())")
mkdir -p "$bench_dir"
bench_out=$(timeout 5400 python3 -m tpukernels_torch.bench)
printf '%s\\n' "$bench_out"
printf '%s\\n' "$bench_out" | tail -1 \\
  > "$bench_dir/bench_$(date +%Y-%m-%d_%H%M%S).json"
printf '%s\\n' "$bench_out" | tail -1 \\
  | python3 -m tpukernels_torch.bench --check-regression $union_flag
""", stamp="never", timeout_s=5460, cost_min=15, value=100,
      after=("prewarm_all",), inputs=("tpukernels_torch",)),
    # the trend tripwire over the bench's lines and the day's journal and
    # state, non-gating (the 15 % gate above is the authority); CPU only
    S("obs_check", """
python3 -m tpukernels_torch.obs.report --check && echo "obs check: OK"
""", gating=False, stamp="never", timeout_s=300, cost_min=1, value=5,
      needs_chip=False, after=("bench",)),
    # the roofline table over the persisted lines: each metric's latest
    # value against its H100 roofline and its ceiling, below_roofline
    # flagged non-gating. CPU only, daily
    S("roofline_report", """
python3 -m tpukernels_torch.obs.report --roofline && echo "roofline report: OK"
""", gating=False, stamp="daily", timeout_s=300, cost_min=1, value=4,
      needs_chip=False, after=("bench",),
      inputs=("tpukernels_torch/tuning/roofline.py",
              "tpukernels_torch/obs/report.py")),
    # the C acceptance gate: test_shim_abi and c/run_all.sh's rows at
    # serial, omp and the port through its shim
    S("c_gate", """
set -e -o pipefail
timeout 900 python3 -m tpukernels_torch.cgate | tail -3
""", timeout_s=1500, cost_min=18, value=60,
      inputs=("c", "tpukernels_torch")),
    # the C path's scan + histogram at 2^22, checked
    S("c_scan_timing", """
set -e -o pipefail
timeout 600 python3 -m tpukernels_torch.cgate scan_histogram --n=4194304
""", timeout_s=660, cost_min=10, value=25, after=("c_gate",),
      inputs=("c", "tpukernels_torch")),
    # profiler evidence: a trace each of SGEMM 1024^3 and the 2-D Jacobi
    # 4096^2, summarized into the supervisor's logs/; non-gating, as the
    # reference's (a failed capture must not abort a queue whose gates
    # passed)
    S("profile", """
set -o pipefail
timeout -k 10 1140 python3 -m tpukernels_torch.profile | grep -E '^(==|plane)'
""", gating=False, timeout_s=1200, cost_min=10, value=20,
      inputs=("tpukernels_torch/profile.py",
              "tpukernels_torch/obs/profile_summary.py")),
    # the knobs' sanity while the card is warm: scan + histogram unfused
    # and fused, SGEMM at float32 (six bf16 products). The reference
    # loops over its two histogram kernels (its histogram-implementation
    # knob); the port has one histogram kernel for both (B9/B10), so its
    # loop runs over the fuse knob
    S("knob_sanity", """
set -e -o pipefail
for fuse in off on; do
  timeout 600 env TPKT_SCANHIST_FUSE=$fuse python3 -c "
from tpukernels_torch.bench import bench_scan_hist
print('scan_hist fuse=$fuse:', round(bench_scan_hist(), 1))"
done
timeout 600 env TPKT_SGEMM_PRECISION=float32 python3 -c "
from tpukernels_torch.bench import bench_sgemm
print('sgemm float32 (six bf16 products):', round(bench_sgemm(), 1))"
""", timeout_s=1860, cost_min=10, value=18,
      inputs=("tpukernels_torch/kernels", "tpukernels_torch/bench.py")),
]

# the port's tests on the card, in stamped groups (pytest has no resume;
# groups let the card's evidence accrue across windows), values
# descending as the reference's. A test that skips on the card fails the
# step: the reference's require-the-TPU switch lives in its conftest,
# which the port does not change, so the body reads pytest's summary.
# Where pytest-xdist is installed the files of a group run in four
# workers: run one after another, pytest_rest's files outlast the 1200 s
# the reference gives a group (killed at 1200 s on the H100 host)
_PYTEST_GROUPS = [
    ("pytest_vector_add", "tests/test_torch_vector_add.py", 16),
    ("pytest_sgemm", "tests/test_torch_sgemm.py "
     "tests/test_torch_sgemm_pipelined.py tests/test_torch_sgemm_prep.py",
     15),
    ("pytest_stencil",
     "tests/test_torch_stencil.py tests/test_torch_stencil3d.py", 14),
    ("pytest_scan_hist", "tests/test_torch_scan.py "
     "tests/test_torch_histogram.py tests/test_torch_scan_histogram.py", 13),
    ("pytest_nbody", "tests/test_torch_nbody.py", 12),
    ("pytest_determinism", "tests/test_torch_slice.py", 11),
]
_GROUPED = " ".join(a for _n, a, _v in _PYTEST_GROUPS).split()
# the rest as the reference writes it, a directory less the groups'
# files (pytest ignores no file it is named explicitly)
_PYTEST_GROUPS.append(
    ("pytest_rest", "tests/ -o 'python_files=test_torch_*.py' "
     + " ".join(f"--ignore={f}" for f in _GROUPED), 10))
for _name, _args, _value in _PYTEST_GROUPS:
    PRODUCTION_QUEUE.append(S(_name, f"""
set -o pipefail
mkdir -p {_LOGS}
pytest_log={_LOGS}/"{_name}_$(date +%Y-%m-%d_%H%M%S).log"
xdist=""
if python3 -c "import xdist" 2>/dev/null; then
  xdist="-p xdist -n 4 --dist loadfile"
fi
out=$(timeout 1200 python3 -m pytest {_args} -q -rfEs -p no:cacheprovider \\
    $xdist 2>&1)
rc=$?
printf '%s\\n' "$out" > "$pytest_log"
printf '%s\\n' "$out" | tail -2
if printf '%s\\n' "$out" | tail -1 | grep -q skipped; then
  echo "FAIL: a test skipped on the card"
  exit 1
fi
exit $rc
""", timeout_s=1260, cost_min=15, value=_value,
        inputs=("tpukernels_torch", "tests")))

PRODUCTION_QUEUE += [
    # the tuner's pipeline on the CPU (children with TPKT_BENCH_SMOKE=1
    # and no card): sweep -> cache -> dispatch, never the card's time;
    # non-gating, daily
    S("autotune_smoke", f"""
set -o pipefail
mkdir -p {_LOGS}
autotune_log={_LOGS}/"autotune_smoke_$(date +%Y-%m-%d_%H%M%S).log"
if timeout -k 10 600 python3 -m tpukernels_torch.autotune --kernel sgemm \\
    --smoke >"$autotune_log" 2>&1; then
  echo "autotune smoke: OK (pipeline proven; $autotune_log)"
else
  echo "WARN: autotune smoke failed rc=$? (non-gating) - $autotune_log"
  exit 1
fi
""", gating=False, timeout_s=660, cost_min=8, value=4, needs_chip=False,
      inputs=("tpukernels_torch/tuning", "tpukernels_torch/autotune.py")),
    # the integrity guard's envelopes, re-recorded daily from the CPU
    # oracle; a failed refresh degrades tier 2 to the live oracle
    S("integrity_envelopes", """
set -o pipefail
if timeout -k 10 600 python3 -m tpukernels_torch.resilience.integrity \\
    --record; then
  echo "integrity envelopes: refreshed"
else
  echo "WARN: integrity envelope refresh failed rc=$? (non-gating) -" \\
       "tier-2 checks degrade to the live oracle"
  exit 1
fi
""", gating=False, stamp="daily", timeout_s=660, cost_min=2, value=4,
      needs_chip=False,
      inputs=("tpukernels_torch/resilience/integrity.py",
              "tpukernels_torch/resilience/canary.py",
              "tpukernels_torch/kernels")),
    # the crash-residue janitor: stale pidfiles, orphaned shm segments,
    # a torn fleet.json
    S("fleet_fsck", """
python3 -m tpukernels_torch.serve.ctl fsck
""", gating=False, stamp="daily", timeout_s=120, cost_min=1, value=2,
      needs_chip=False, inputs=("tpukernels_torch/serve",)),
    # the day's journals compacted into a rollup (the multi-day series)
    S("rollup_daily", f"""
set -o pipefail
mkdir -p {_LOGS}
rollup_log={_LOGS}/"rollup_daily_$(date +%Y-%m-%d_%H%M%S).log"
if timeout -k 10 240 python3 -m tpukernels_torch.obs.rollup \\
    >"$rollup_log" 2>&1; then
  tail -1 "$rollup_log"
else
  echo "WARN: daily rollup failed rc=$? (non-gating) - $rollup_log"
  exit 1
fi
""", gating=False, stamp="daily", timeout_s=300, cost_min=1, value=2,
      needs_chip=False,
      inputs=("tpukernels_torch/obs/rollup.py",
              "tpukernels_torch/obs/metrics.py")),
    # a bucket split/merge proposal from the served traffic; after the
    # serve probe's traffic and the rollup's series
    S("adapt_propose", f"""
set -o pipefail
mkdir -p {_LOGS}
adapt_log={_LOGS}/"adapt_propose_$(date +%Y-%m-%d_%H%M%S).log"
if timeout -k 10 240 python3 -m tpukernels_torch.serve.optimize \\
    propose >"$adapt_log" 2>&1; then
  tail -1 "$adapt_log"
else
  echo "WARN: adapt propose failed rc=$? (non-gating) - $adapt_log"
  exit 1
fi
""", gating=False, stamp="daily", timeout_s=300, cost_min=1, value=2,
      needs_chip=False, after=("serve_probe", "rollup_daily"),
      inputs=("tpukernels_torch/serve",)),
    # the proposal's canary on the card: the candidate table's kernels
    # re-tuned (`--autotune quick`, the 3 % margin), then incumbent and
    # candidate daemons on the frozen mix at one seed
    S("adapt_canary", f"""
set -o pipefail
mkdir -p {_LOGS}
adapt_log={_LOGS}/"adapt_canary_$(date +%Y-%m-%d_%H%M%S).log"
if timeout -k 10 900 python3 -m tpukernels_torch.serve.optimize canary \\
    --autotune quick >"$adapt_log" 2>&1; then
  tail -2 "$adapt_log"
else
  echo "WARN: adapt canary failed rc=$? (non-gating) - $adapt_log"
  exit 1
fi
""", gating=False, stamp="daily", timeout_s=960, cost_min=6, value=11,
      after=("prewarm_all", "adapt_propose"),
      inputs=("tpukernels_torch/serve", "tpukernels_torch/tuning",
              "tpukernels_torch/loadgen.py")),
]
# the C gate under the sanitizers, drivers and shim rebuilt apart, the
# port on the CPU; last on purpose (lowest density)
for _san, _value in (("asan", 3), ("ubsan", 2)):
    PRODUCTION_QUEUE.append(S(f"san_{_san}", f"""
set -e -o pipefail
timeout 1800 env TPKT_CAPI_DEVICE=cpu python3 -m tpukernels_torch.cgate \\
    --sanitize {_san} | tail -3
""", timeout_s=2100, cost_min=25, value=_value, needs_chip=False,
        inputs=("c", "tpukernels_torch")))

# the reference's steps the port cannot run yet -> the ROADMAP Queue A
# item each waits for: none
WAITING: dict = {}

# the harvest's sweep may take this long before it is killed
_HARVEST_TIMEOUT_S = 3600


def _harvest():
    """After the first green queue of a watch: one best-effort SGEMM sweep
    (``python -m tpukernels_torch.sgemm_tune --quick``), its log under the
    supervisor's ``logs/``. It never gates: a wedge in the sweep must not
    turn a green queue into a failure."""
    import datetime
    import subprocess

    logs = os.path.join(_cachedir.supervisor_dir(), "logs")
    os.makedirs(logs, exist_ok=True)
    stamp = datetime.datetime.now().strftime("%Y-%m-%d_%H%M%S")
    log = os.path.join(logs, f"sgemm_tune_{stamp}.log")
    with open(log, "w") as f:
        try:
            rc = subprocess.run(
                [sys.executable, "-m", "tpukernels_torch.sgemm_tune",
                 "--quick"], stdout=f, stderr=subprocess.STDOUT, cwd=_REPO,
                timeout=_HARVEST_TIMEOUT_S).returncode
        except subprocess.TimeoutExpired:
            rc = "timeout"
    print(f"supervisor: harvest sgemm_tune --quick rc={rc} (non-gating) - "
          f"{log}")


def lock_wait_s(wait: bool) -> float:
    """``TPKT_REVALIDATE_LOCK_WAIT_S``, else 1800 s for ``--wait`` (long
    enough to outlive an orphaned step) and 0 for one queue run."""
    raw = os.environ.get("TPKT_REVALIDATE_LOCK_WAIT_S")
    try:
        return float(raw) if raw else (1800.0 if wait else 0.0)
    except ValueError:
        return 1800.0 if wait else 0.0


def take_lock(path: str, wait_s: float) -> bool:
    """Hold ``flock`` on ``path`` on fd 9 for this process's life and
    write its pid there; False when another holder keeps it past
    ``wait_s``. Opened for append: a losing contender must not wipe the
    holder's recorded pid, which ``--whos-holding`` reads."""
    import fcntl

    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    deadline = time.monotonic() + wait_s
    while True:
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
            break
        except OSError:
            if time.monotonic() >= deadline:
                os.close(fd)
                return False
            time.sleep(min(1.0, max(deadline - time.monotonic(), 0.01)))
    if fd != supervisor.LOCK_FD:
        os.dup2(fd, supervisor.LOCK_FD)
        os.close(fd)
    with open(path, "w") as f:
        f.write(f"{os.getpid()}\n")
    return True


_WATCHER_MARKS = ("tpukernels_torch.revalidate --wait",
                  "tpukernels_torch/revalidate.py --wait")
_RUN_MARKS = ("tpukernels_torch.revalidate", "tpukernels_torch/revalidate.py")
_STEP_MARKS = ("tpukernels_torch.prewarm", "tpukernels_torch.loadgen",
               "tpukernels_torch.serve", "tpukernels_torch.cgate",
               "tpukernels_torch.parallel", "tpukernels_torch.profile",
               "tpukernels_torch.bench", "tpukernels_torch.autotune",
               "pytest")


def classify_holder(cmdline: str) -> str:
    """live-watcher | live-queue | orphaned-queue | unknown. A queue run
    holds the lock itself (in the reference only the watcher does), so a
    revalidate process without ``--wait`` is a live queue, and a step's
    command is an orphan."""
    if any(m in cmdline for m in _WATCHER_MARKS):
        return "live-watcher"
    if any(m in cmdline for m in _RUN_MARKS):
        return "live-queue"
    if any(m in cmdline for m in _STEP_MARKS):
        return "orphaned-queue"
    return "unknown"


def whos_holding(lock_path=None) -> int:
    """Diagnose the queue lock: is it held, by which pid, and is that a
    live queue (leave it alone) or an orphaned step child (kill it and
    run the queue again)? rc 0 not held, rc 3 held."""
    import fcntl

    lock_path = lock_path or supervisor.lock_path()
    if not lock_path or not os.path.exists(lock_path):
        print(f"whos-holding: no lock file at {lock_path} - no queue has "
              "run on this machine")
        return 0
    held = False
    try:
        with open(lock_path) as f:
            content = f.readline().strip()
            try:
                fcntl.flock(f.fileno(), fcntl.LOCK_EX | fcntl.LOCK_NB)
                fcntl.flock(f.fileno(), fcntl.LOCK_UN)
            except OSError:
                held = True
    except OSError as e:
        print(f"whos-holding: cannot open {lock_path}: {e}")
        return 0
    pid = int(content) if content.isdigit() else None
    if not held:
        print(f"whos-holding: lock {lock_path} is NOT held"
              + (f" (stale pid {pid} in file)" if pid else "")
              + " - safe to start a queue")
        return 0
    if pid is None:
        print("whos-holding: lock HELD but no pid recorded - fall back "
              "to: pgrep -af tpukernels_torch")
        return 3
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            cmdline = f.read().replace(b"\0", b" ").decode(
                errors="replace").strip()
    except OSError:
        cmdline = ""
    if not cmdline:
        # flock held but the recorded pid is gone: a child inherited the
        # lock fd when the queue died — the orphan case
        print(f"whos-holding: lock HELD but recorded queue pid {pid} is "
              "dead - an orphaned step child inherited the fd.")
        print("  pgrep -af 'tpukernels_torch|pytest'  "
              "# kill these, then run the queue again")
        return 3
    verdict = classify_holder(cmdline)
    print(f"whos-holding: lock HELD by pid {pid}: {cmdline}")
    if verdict == "live-watcher":
        print("  verdict: LIVE WATCHER - leave it alone (it exits on "
              "the first green queue or its deadline)")
    elif verdict == "live-queue":
        print("  verdict: LIVE QUEUE - leave it alone (it exits at the "
              "end of its queue)")
    elif verdict == "orphaned-queue":
        print(f"  verdict: ORPHANED step child - kill {pid} and run "
              "python -m tpukernels_torch.revalidate again")
    else:
        print("  verdict: unrecognized holder - inspect before "
              "killing")
    return 3


def _load_specs(queue_file):
    """The steps of ``queue_file``, else :data:`PRODUCTION_QUEUE`; raises
    SystemExit(64) on a malformed file: a usage error, not a gating
    step's rc, and never rc 2, which the watch loop would retry until
    its deadline."""
    if queue_file:
        try:
            return supervisor.load_queue_file(queue_file)
        except (OSError, ValueError, KeyError, TypeError) as e:
            print(f"revalidate: bad queue file {queue_file}: {e}",
                  file=sys.stderr)
            raise SystemExit(64)
    return PRODUCTION_QUEUE


def _plan(specs) -> int:
    """The read-only schedule: the window estimate, then each step's
    density, cost and state in the order the planner would run them on
    a fresh window (steps it would not admit last, in declaration
    order)."""
    from tpukernels_torch.resilience import journal

    sup = supervisor.Supervisor(specs, repo=_REPO, announce=False)
    events, _bad = journal.load_events(sup._history_paths())
    est = supervisor.estimate_window_minutes(events)
    print(f"window estimate: {est['minutes']:.1f} min "
          f"({est['basis']}, {est['windows']} observed)")
    order = []
    while True:
        spec, _forced = sup.plan(float("inf"), may_force=False)
        if spec is None:
            break
        order.append(spec)
        sup._settled.add(spec.name)
        sup._attempted.add(spec.name)
    order += [s for s in specs if s not in order]
    print(f"{'step':<22} {'density':>8} {'cost':>6} {'state'}")
    for s in order:
        st = sup.state["steps"].get(s.name, {})
        state = ("quarantined" if st.get("quarantined")
                 else "green" if st.get("green")
                 else "stamped" if supervisor.stamp_fresh(s, _REPO)
                 else "pending")
        fit = ("" if not s.needs_chip
               else " (fits)" if s.cost_min <= est["minutes"]
               else " (exceeds window)")
        print(f"{s.name:<22} {s.density:>8.2f} "
              f"{s.cost_min:>5.0f}m {state}{fit}")
    return 0


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    wait = plan_only = holding = False
    max_hours = 10.0
    queue_file = os.environ.get("TPKT_SUPERVISOR_QUEUE") or None
    it = iter(argv)
    try:
        for a in it:
            if a == "--wait":
                wait = True
            elif a == "--plan":
                plan_only = True
            elif a == "--whos-holding":
                holding = True
            elif a == "--max-hours":
                max_hours = float(next(it))
            elif a == "--queue":
                queue_file = next(it)
            else:
                print(__doc__, file=sys.stderr)
                print(f"revalidate: unknown argument {a!r}",
                      file=sys.stderr)
                return 64
    except (StopIteration, ValueError):
        print(f"revalidate: {a} needs a value", file=sys.stderr)
        return 64
    if holding:
        return whos_holding()
    # resolve the queue path against the caller's cwd before the chdir
    if queue_file:
        queue_file = os.path.abspath(queue_file)
    specs = _load_specs(queue_file)
    os.chdir(_REPO)
    # the steps' logs, and the journal the supervisor and its step
    # children share when the caller named none (--plan creates nothing)
    state = _cachedir.supervisor_dir()
    os.environ["TPKT_SUPERVISOR_DIR"] = state
    if not plan_only:
        os.makedirs(os.path.join(state, "logs"), exist_ok=True)
    if os.environ.get("TPKT_HEALTH_JOURNAL") is None and \
            os.path.isdir(state):
        os.environ["TPKT_HEALTH_JOURNAL"] = state
    if plan_only:
        return _plan(specs)
    lock = supervisor.lock_path()
    if lock is None:
        print("revalidate: HOME unset and no TPKT_REVALIDATE_LOCK - "
              "refusing to run without the queue lock", file=sys.stderr)
        return 64
    if not take_lock(lock, lock_wait_s(wait)):
        print(f"revalidate: lock {lock} is held; exiting 3. Diagnose the "
              "holder with:")
        print("  python -m tpukernels_torch.revalidate --whos-holding")
        return 3
    if wait:
        # a watch spends a short window only on the metrics the persisted
        # union lacks, and probes no longer inside the queue (it has just
        # probed the card healthy)
        os.environ["TPKT_BENCH_SKIP_CAPTURED"] = "1"
        os.environ["TPKT_BENCH_PROBE_ATTEMPTS"] = "1"
        return supervisor.watch(
            lambda: supervisor.Supervisor(specs, repo=_REPO), max_hours,
            harvest=None if queue_file else _harvest)
    return supervisor.Supervisor(specs, repo=_REPO).run_queue()


if __name__ == "__main__":
    sys.exit(main())
