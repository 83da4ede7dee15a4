"""Autotune CLI of the port: sweep a kernel's search space and promote the
winner into the tuning cache.

    python -m tpukernels_torch.autotune --list                   # tunable kernels
    python -m tpukernels_torch.autotune --kernel sgemm           # full sweep
    python -m tpukernels_torch.autotune --kernel sgemm --quick   # control + probes
    python -m tpukernels_torch.autotune --kernel sgemm --smoke   # CPU pipeline proof

The port's copy of ``tools/autotune.py``. Each candidate runs through the
real metric path, ``python -m tpukernels_torch.bench --one <metric>``, in
a killable child (``tuning/runner.py``), so a wedged candidate costs
``TPKT_TUNE_TIMEOUT_S`` (420 s, 60 with ``--smoke``) and nothing more.
Candidates whose shared memory exceeds a block's are pruned before any
is measured; a promotion must beat the shipped defaults' control row by
more than 3 % on the bench medians (``runner.PROMOTE_MARGIN``).

``--smoke`` runs the same sweep, cache and journal machinery with its
children on the CPU (``TPKT_BENCH_SMOKE=1``, ``--device cpu``): values
are meaningless and the entry is keyed ``device_kind=cpu``, so it can
never steer a card run.

This process never touches the card: it makes no CUDA context, and only
its children (an identity probe and the candidates) do. With no
``TPKT_HEALTH_JOURNAL`` the sweep journals into a dated file beside the
AOT manifest, shared with its children.

Exit codes: 0 the sweep ran (promoted or not); 2 no candidate produced a
number (no card, or every candidate failed), or a usage error.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tpukernels_torch.autotune",
                                 description="sweep a kernel's TUNABLES "
                                             "search space")
    ap.add_argument("--kernel", help="registry kernel name (see --list)")
    ap.add_argument("--list", action="store_true",
                    help="list tunable kernels and exit")
    ap.add_argument("--smoke", action="store_true",
                    help="CPU pipeline proof (the children's values are "
                         "meaningless)")
    ap.add_argument("--quick", action="store_true",
                    help="the control and single-axis probes of the first "
                         "knob (at most 3 candidates)")
    ap.add_argument("--max-candidates", type=int, default=None,
                    help="cap the sweep (default: smoke caps at 3)")
    ap.add_argument("--timeout-s", type=float, default=None,
                    help="a candidate's watchdog (default "
                         "TPKT_TUNE_TIMEOUT_S, 420 real / 60 smoke)")
    try:
        args = ap.parse_args(argv)
    except SystemExit as e:
        return 0 if e.code == 0 else 2

    from tpukernels_torch import registry
    from tpukernels_torch.tuning import runner

    if args.list:
        for name in registry.tunable_kernels():
            sp = registry.tunables(name)
            knobs = ", ".join(f"{t.name}({t.env})" for t in sp.tunables)
            print(f"{name:14s} metric={sp.metric}  knobs: {knobs}")
        return 0
    if not args.kernel:
        print("autotune: --kernel is required (or --list)", file=sys.stderr)
        return 2
    try:
        summary = runner.tune(args.kernel, smoke=args.smoke, quick=args.quick,
                              max_candidates=args.max_candidates,
                              timeout_s=args.timeout_s,
                              echo=lambda line: print(line, flush=True))
    except (KeyError, ValueError) as e:
        print(f"autotune: {e}", file=sys.stderr)
        return 2
    except RuntimeError as e:
        print(f"{e}\nno candidate produced a number - no card answering?")
        return 2
    best, control = summary["best"], summary["control"]
    if best is None:
        print("no candidate produced a number - no card answering, or "
              "every candidate failed?")
        return 2
    line = ("best: " + " ".join(f"{k}={v}" for k, v in best["params"].items())
            + f" at {best['value']:.2f} {summary['metric']}")
    if control and control["value"]:
        line += f" ({best['value'] / control['value']:.3f}x of default)"
    print(line)
    if summary["promoted"] is not None:
        print(f"promoted -> {summary['cache_path']} [{summary['cache_key']}]"
              + (" (smoke entry: pipeline proof, not a tuning claim)"
                 if args.smoke else ""))
    else:
        print("not promoted: best must beat the default control by "
              f">{runner.PROMOTE_MARGIN:.0%} on medians")
    return 0


if __name__ == "__main__":
    sys.exit(main())
