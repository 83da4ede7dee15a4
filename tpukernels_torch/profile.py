"""Profiler evidence for the two headline kernels on the card.

    python -m tpukernels_torch.profile [OUTDIR] [--device cpu]

The port's copy of ``tools/profile_headline.sh``: one ``torch.profiler``
trace each of

- ``sgemm``: SGEMM 1024^3 at the default precision (``high``), a chain of
  R = 50 dependent calls ``sgemm(1.0, a, b, 0.5, c)`` on the previous C,
  the scheme of the reference's ``bench_sgemm`` slope loop
  (``bench.py:276-281``), warmed before the trace and traced three times;
- ``stencil``: the 2-D Jacobi 4096^2, ``jacobi2d(x, 64)`` at its default
  k = 8, warmed and traced three times,

with inputs from ``np.random.default_rng(0)`` and ``(1)``, as in the
reference. Each trace is written to ``OUTDIR/profile_<label>_<date>.json``
and summarized by ``python -m tpukernels_torch.obs.profile_summary`` into
``OUTDIR/profile_<label>_<date>.log``. ``OUTDIR`` defaults to the
revalidation supervisor's ``logs/`` directory
(``_cachedir.supervisor_dir()``), never the reference's ``docs/logs/``.
The last line of the output is one JSON object, ``{"profile": {label:
{"log", "trace", "rc", "planes": [{"name", "busy_pct", "span_ms",
"top": [[kernel, ms, port source or null], ...]}]}}}``.

It runs on the card; with no card it exits 2 unless ``--device cpu`` is
given, which profiles the plain versions on the CPU at a small size, in a
process that sees no card (for the tests). Exit codes: 0 both summaries
written; 1 a summary failed (a trace taken on the card with no device
plane); 2 usage or no card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from tpukernels_torch import _cachedir

CHAIN = 50   # dependent SGEMM calls a traced repetition
REPS = 3     # traced repetitions of each body
TOP = 10
# (SGEMM m = n = k, 2-D Jacobi side, its sweeps) on each device: the
# configurations of record on the card, small ones for the CPU's plain
# versions
SIZES = {"cuda": (1024, 4096, 64), "cpu": (128, 256, 64)}


def default_outdir() -> str:
    return os.path.join(_cachedir.supervisor_dir(), "logs")


def bodies(torch, device, sizes):
    """``[(label, fn)]``: the two bodies on ``device``, each returning a
    host float (so a repetition ends when its device work does)."""
    import numpy as np

    from tpukernels_torch.kernels.sgemm import sgemm
    from tpukernels_torch.kernels.stencil import jacobi2d

    m, side, iters = sizes
    rng = np.random.default_rng(0)
    a, b, c = (torch.from_numpy(rng.standard_normal((m, m)).astype(
        np.float32)).to(device) for _ in range(3))

    def sgemm_chain():
        cc = c
        for _ in range(CHAIN):
            cc = sgemm(1.0, a, b, 0.5, cc)
        return float(cc.sum())

    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (side, side)).astype(np.float32)).to(device)

    def stencil():
        return float(jacobi2d(x, iters).sum())

    return [("sgemm", sgemm_chain), ("stencil", stencil)]


def capture(device, fn, trace_path: str) -> None:
    """Warm ``fn`` (builds, plans, first launches) outside the profiler,
    then run it once more under the profiler's warm-up step, which is not
    kept (the first kernel launch under the profiler set up its device
    tracing for 3.8 ms on the H100, inside a 4.9 ms window), then trace
    :data:`REPS` calls and write the Chrome trace."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=REPS, repeat=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(
                     trace_path)) as prof:
        for _ in range(1 + REPS):
            fn()
            prof.step()


def summary_record(summaries) -> list:
    """Each plane's busy % and span, and its five top ops with the port's
    source of each (None for a kernel that is not the port's own)."""
    from tpukernels_torch.obs import profile_summary as ps

    known = ps.port_kernels()
    return [{"name": s["name"], "busy_pct": s["busy_pct"],
             "span_ms": s["span_ms"],
             "top": [[n, ms, ps.kernel_source(n, known)
                      if ps.is_device(s) else None]
                     for n, ms in ps.top_ops(s, 5)]}
            for s in summaries]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tpukernels_torch.profile",
        description="Trace SGEMM 1024^3 and the 2-D Jacobi 4096^2 and "
                    "summarize each trace.")
    ap.add_argument("outdir", nargs="?", default=None,
                    help="where the traces and logs go (default: the "
                         "supervisor's logs/ directory)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="where to run (default: the card)")
    try:
        args = ap.parse_args(argv)
    except SystemExit as e:
        return 0 if e.code == 0 else 2
    if args.device == "cpu":
        # a CPU profile sees no card: on a host with one, a trace that
        # lists the card and holds no device event would be a failed
        # capture (profile_summary's rc 1)
        os.environ["CUDA_VISIBLE_DEVICES"] = ""

    import torch

    from tpukernels_torch.obs import profile_summary
    from tpukernels_torch.utils import pick_device

    try:
        device = pick_device(args.device)
    except RuntimeError as e:
        print(f"profile: {e}", file=sys.stderr)
        return 2
    outdir = args.outdir or default_outdir()
    os.makedirs(outdir, exist_ok=True)
    stamp = time.strftime("%Y-%m-%d")
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    record, rc = {}, 0
    for label, fn in bodies(torch, device, SIZES[device.type]):
        trace = os.path.join(outdir, f"profile_{label}_{stamp}.json")
        log = os.path.join(outdir, f"profile_{label}_{stamp}.log")
        print(f"== profiling {label} on {device} ({name}) -> {trace}",
              flush=True)
        capture(device, fn, trace)
        _path, summaries, card = profile_summary.summarize(trace)
        one, lines = profile_summary.render(summaries, card, TOP)
        text = "\n".join([f"# device: {device} ({name}), torch "
                          f"{torch.__version__}", f"# trace: {trace}",
                          *lines]) + "\n"
        with open(log, "w") as f:
            f.write(text)
        sys.stdout.write(text)
        print(f"== summary saved: {log} (rc {one})", flush=True)
        record[label] = {"log": log, "trace": trace, "rc": one,
                         "planes": summary_record(summaries)}
        rc = rc or one
    print(json.dumps({"profile": record}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
