"""Prewarm the port: build, load, plan and trust every configuration of
record ahead of traffic.

    python -m tpukernels_torch.prewarm [--kernels a,b] [--check]
        [--device cuda|cpu] [--order registry|traffic]
        [--bench METRICS|all] [--timeout-s S]

The counterpart of ``tools/prewarm.py``. For each registry key (or the
``--kernels`` named) it runs ``aot.precompile`` at the key's
``aot.BENCH_CONFIGS`` avatar on the card (``--device cpu`` plans the CPU
path and builds nothing): the libraries the key's knobs launch are
built where missing and loaded, its launch plan is made, its manifest row
is written, and the integrity guard's first-trust canary runs. A fresh
process that then dispatches the key finds it warm.

It journals ``prewarm_start``, one ``prewarm_kernel`` a key (its wall,
``expected`` hit or miss, build, load and plan seconds, and for each
library the registers, shared memory and spills of its ptxas report),
then ``prewarm_end``; with no ``TPKT_HEALTH_JOURNAL`` the journal is a
dated file beside the manifest. As ``chip_smoke.py`` phase 2 does, a
spill in a library whose design keeps its state in registers
(``_build.SPILL_FREE``) is a failure, and a ``wgmma`` serialisation
warning is reported. ``--check`` prints only failures, the traffic order
and the summary.

``--bench all`` (or a comma-separated list of the bench's metrics) also
warms the bench's chains: one ``python -m tpukernels_torch.bench
--prewarm <metric>`` child a metric under the watchdog's hard kill
(``--timeout-s``, default 900), which builds the metric's operands, runs
its key through the compile discipline, builds and warms both repeat
counts (the CUDA graphs included) and exits without timing and without a
stdout line; each journals a ``prewarm_kernel`` row with ``mode:
bench``. With ``--device cpu`` a child runs the CPU's plain versions,
which only ``TPKT_BENCH_SMOKE=1`` allows (collapsed repeat counts).

``--order traffic`` warms the keys in the order traffic hits them: ranked
by the journal's ``serve_request`` count (``serve/adapt.traffic_order``),
the keys no request named after them in registry order, so a prewarm cut
short still warmed what is served most. With no ``serve_request`` in the
journal it says so on stderr and keeps registry order.

Exit codes (the reference's): 0 every key asked for is built and
trusted; 1 a key failed (a build, a plan, a spill or its canary) or a
bench metric did (its child's rc or its kill), or the
layer is off (``TPKT_AOT_CACHE=0``: a prewarm that builds nothing never
reports success); 2 a usage error (an unknown flag or key, or no card
without ``--device cpu``).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from tpukernels_torch import _cachedir, aot
from tpukernels_torch.resilience import journal, watchdog


def _prewarm_bench_metric(metric: str, timeout_s: float, device=None):
    """One ``bench --prewarm <metric>`` child under the watchdog's hard
    kill: ``(status, wall_s)``, status ok, timeout or error."""
    import subprocess

    argv = [sys.executable, "-m", "tpukernels_torch.bench", "--prewarm",
            metric]
    if device is not None and device.type == "cpu":
        argv += ["--device", "cpu"]
    t0 = time.monotonic()
    r, status = watchdog.kill_after(argv, timeout_s,
                                    site=f"prewarm --prewarm {metric}",
                                    cwd=_cachedir._REPO,
                                    stdout=subprocess.DEVNULL)
    if status == "ok" and r.returncode != 0:
        status = "error"
    return status, round(time.monotonic() - t0, 3)


def _libraries(names, failures: list, echo) -> dict:
    """Each library's ptxas report; a spill where the design allows
    none goes into ``failures``."""
    from tpukernels_torch import _build

    out = {}
    for lib in names:
        rep = out[lib] = _build.ptxas_report(lib)
        if rep is None:
            continue
        spilled = rep["spill_stores"] + rep["spill_loads"]
        if lib in _build.SPILL_FREE and spilled:
            failures.append(f"ptxas spills {spilled} B in {lib}")
        if rep["wgmma_serialisation"]:
            print(f"prewarm: {lib}: {rep['wgmma_serialisation']} wgmma "
                  "serialisation warning(s) in its ptxas report",
                  file=sys.stderr)
        echo(f"    {lib:<16} {rep['registers']} registers, "
             f"{rep['smem_bytes']} B smem, spills {spilled} B")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tpukernels_torch.prewarm",
        description="Build, load, plan and trust every configuration of "
                    "record.")
    ap.add_argument("--kernels", help="comma-separated registry keys")
    ap.add_argument("--check", action="store_true",
                    help="print only failures and the summary")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="where to prewarm (default: the card)")
    ap.add_argument("--order", choices=("registry", "traffic"),
                    default="registry",
                    help="registry order, or hottest first by the "
                         "journal's serve_request count")
    ap.add_argument("--bench", default="",
                    help="also warm these bench metrics' chains "
                         "(comma-separated, or all)")
    ap.add_argument("--timeout-s", type=float, default=900.0,
                    help="each bench --prewarm child's hard kill")
    try:
        args = ap.parse_args(argv)
    except SystemExit as e:
        return 0 if e.code == 0 else 2
    if not aot.enabled():
        print("prewarm: TPKT_AOT_CACHE=0 turns the compile discipline off "
              "- nothing to prewarm", file=sys.stderr)
        return 1
    from tpukernels_torch import registry
    from tpukernels_torch.obs import metrics
    from tpukernels_torch.utils import pick_device

    known = registry.precompilable_kernels()
    kernels = known
    if args.kernels is not None:
        kernels = [k.strip() for k in args.kernels.split(",") if k.strip()]
        unknown = [k for k in kernels if k not in known]
        if unknown or not kernels:
            print(f"prewarm: unknown kernel(s) {unknown}; known: {known}",
                  file=sys.stderr)
            return 2
    try:
        device = pick_device(args.device)
    except RuntimeError as e:
        print(f"prewarm: {e}", file=sys.stderr)
        return 2
    from tpukernels_torch.bench import BENCH_METRICS

    metric_names = [n for n, _f in BENCH_METRICS]
    bench_metrics = [m.strip() for m in args.bench.split(",") if m.strip()]
    if bench_metrics == ["all"]:
        bench_metrics = metric_names
    unknown = [m for m in bench_metrics if m not in metric_names]
    if unknown:
        print(f"prewarm: unknown bench metric(s) {unknown}; known: "
              f"{metric_names}", file=sys.stderr)
        return 2
    if os.environ.get("TPKT_HEALTH_JOURNAL") is None:
        d = os.path.dirname(aot.manifest_path())
        os.makedirs(d, exist_ok=True)
        os.environ["TPKT_HEALTH_JOURNAL"] = d

    if args.order == "traffic":
        from tpukernels_torch.serve import adapt

        events, _bad = journal.load_events([journal.path()])
        kernels, counts = adapt.traffic_order(events, kernels)
        if counts:
            print("prewarm: traffic order "
                  + ", ".join(f"{k}={counts.get(k, 0)}" for k in kernels))
        else:
            print("prewarm: --order traffic but the journal holds no "
                  "serve_request evidence - keeping registry order",
                  file=sys.stderr)

    echo = (lambda line: None) if args.check else print
    journal.emit("prewarm_start", kernels=kernels, metrics=bench_metrics,
                 device=str(device))
    echo(f"prewarm: {len(kernels)} configuration(s) of record on {device}"
         + (f" + {len(bench_metrics)} bench metric(s)" if bench_metrics
            else ""))
    t0 = time.monotonic()
    failed = []
    for name in kernels:
        trusted = metrics.counter("integrity.failures") + metrics.counter(
            "integrity.check_errors")
        (row,) = aot.prewarm_all([name], echo=echo, device=device)
        failures = [row["error"]] if "error" in row else []
        libs = _libraries(row.get("libraries", ()), failures, echo)
        if metrics.counter("integrity.failures") + metrics.counter(
                "integrity.check_errors") != trusted:
            failures.append("its first-trust canary failed")
        if failures:
            failed.append(name)
            print(f"prewarm: {name} FAILED: {'; '.join(failures)}",
                  file=sys.stderr)
        journal.emit("prewarm_kernel", kernel=name,
                     status="error" if failures else "ok",
                     **({"error": "; ".join(failures)} if failures else {}),
                     **{k: row[k] for k in ("key", "expected", "wall_s",
                                            "build_s", "load_s", "plan_s")
                        if k in row},
                     libraries=libs)
    for metric in bench_metrics:
        status, wall = _prewarm_bench_metric(metric, args.timeout_s, device)
        if status != "ok":
            failed.append(metric)
            print(f"prewarm: bench metric {metric} FAILED ({status})",
                  file=sys.stderr)
        else:
            echo(f"  {metric:<22} chains built and warm wall={wall:.1f}s")
        journal.emit("prewarm_kernel", kernel=metric, mode="bench",
                     status=status, wall_s=wall)
    total = round(time.monotonic() - t0, 3)
    asked = len(kernels) + len(bench_metrics)
    journal.emit("prewarm_end", warmed=asked - len(failed),
                 failed=failed, total_wall_s=total)
    print(f"prewarm{' --check' if args.check else ''}: "
          f"{asked - len(failed)} warmed, {len(failed)} failed in "
          f"{total:.1f}s" + (f" (failed: {','.join(failed)})"
                             if failed else ""))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
